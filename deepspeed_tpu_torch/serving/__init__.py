"""Serving front-end of the port: requests, scheduler policies, the
replica server (:class:`~.server.ServingEngine`), the multi-replica fleet
with its routers (:class:`~.fleet.ServingFleet`), and the region over it:
cells (:class:`~.cell.ServingCell`), the two-tier router
(:class:`~.region.Region`) and the rollout controller
(:class:`~.rollout.RolloutController`).

The fleet's and the region's names load on first use:
``inference/ragged.py`` imports ``serving.kvtier`` while it loads, and the
fleet imports the ragged engine."""

from .router import (  # noqa: F401
    LeastLoadedRouter,
    NoHealthyReplica,
    PrefixAffinityRouter,
    ResidencyAwareRouter,
    RouterPolicy,
    make_router,
    prefix_key,
)

# name -> the module that defines it, imported on first use
_LAZY_NAMES = {
    "Replica": "fleet", "ReplicaState": "fleet", "ServingFleet": "fleet",
    "CellDigest": "cell", "CellState": "cell", "CellUnreachable": "cell",
    "ServingCell": "cell", "check_reachable": "cell",
    "Region": "region",
    "RolloutController": "rollout", "RolloutPhase": "rollout",
    "TERMINAL_PHASES": "rollout",
}


def __getattr__(name):
    if name in _LAZY_NAMES:
        import importlib

        module = importlib.import_module(f".{_LAZY_NAMES[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

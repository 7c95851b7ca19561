"""Serving front-end of the port: requests, scheduler policies, the
replica server (:class:`~.server.ServingEngine`) and the multi-replica
fleet with its routers (:class:`~.fleet.ServingFleet`).

The fleet's names load on first use: ``inference/ragged.py`` imports
``serving.kvtier`` while it loads, and the fleet imports the ragged
engine."""

from .router import (  # noqa: F401
    LeastLoadedRouter,
    NoHealthyReplica,
    PrefixAffinityRouter,
    ResidencyAwareRouter,
    RouterPolicy,
    make_router,
    prefix_key,
)

_FLEET_NAMES = ("Replica", "ReplicaState", "ServingFleet")


def __getattr__(name):
    if name in _FLEET_NAMES:
        from . import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

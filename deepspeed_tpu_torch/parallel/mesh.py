"""The topology: mesh axes as process groups.

Ports the part of ``deepspeed_tpu/parallel/mesh.py`` that the staged ZeRO-3
path and tensor-parallel serving read. In the JAX package a mesh axis is
a named dimension of a device mesh and a collective names it inside
``shard_map``; here each rank is a process, and an axis above 1 is a
``torch.distributed`` process group. The facade (``comm/compressed.py``)
takes the same axis names as the JAX facade and looks the group up in the
current topology.

Two axes are ported: ``data`` (ZeRO-3) and ``model`` (tensor parallelism).
``data * model`` must equal the world size (``data`` ``-1`` means the
ranks that are left). ``data`` and ``model`` both above 1 raise
(ROADMAP.md, Queue A item 6b), so an axis above 1 spans every rank; with
both, ``model`` would be the innermost axis, as in the JAX package. Any
other axis above 1 raises ``ConfigError`` naming the slice it comes
with.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch.distributed as dist

from ..config import ConfigError
from ..comm import comm

MESH_AXES = ("data", "zshard", "seq", "pipe", "expert", "model")
# axis -> where it comes with (ROADMAP.md, Queue A)
LATER_AXES = {
    "zshard": "the hpZ / MiCS slice (Queue A item 12)",
    "seq": "sequence parallelism (Queue A item 13)",
    "pipe": "pipeline parallelism (Queue A item 13)",
    "expert": "expert parallelism (Queue A item 13)",
}
MODEL_AND_DATA = ("a 'data' axis above 1 beside a 'model' axis above 1 "
                  "comes with ROADMAP.md, Queue A item 6b")


class PartitionSpec(tuple):
    """Per-dimension placement of a leaf: ``None`` (replicated along that
    dimension) or the name of the mesh axis it is sharded over, as
    ``jax.sharding.PartitionSpec`` spells it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


class Topology:
    """Mesh axis sizes and the process group of each axis above 1."""

    def __init__(self, sizes: Mapping[str, int], groups: Dict[str, Any]):
        self.sizes = {a: int(sizes.get(a, 1)) for a in MESH_AXES}
        self.groups = dict(groups)

    @classmethod
    def build(cls, mesh: Optional[Mapping[str, int]] = None) -> "Topology":
        """The topology of this process's ranks: ``mesh`` (a dict or a
        config with the axis sizes) checked against the world size. Every
        rank must call it."""
        sizes = dict(mesh or {})
        world = comm.get_world_size()
        for axis, n in sizes.items():
            if axis not in MESH_AXES:
                raise ConfigError(f"unknown mesh axis '{axis}'")
            if axis in LATER_AXES and n is not None and int(n) > 1:
                raise ConfigError(
                    f"mesh axis '{axis}' = {n}: it comes with "
                    f"{LATER_AXES[axis]}; this slice shards over 'data' "
                    f"and 'model' only")
        model = int(sizes.get("model", 1) or 1)
        if model > 1 and int(sizes.get("data", 1) or 1) > 1:
            raise ConfigError(f"mesh {{'data': {sizes['data']}, 'model': "
                              f"{model}}}: {MODEL_AND_DATA}")
        if model < 1 or world % model:
            raise ConfigError(f"mesh {{'model': {model}}} must divide the "
                              f"world size {world}")
        data = int(sizes.get("data", -1) or -1)
        if data == -1:
            data = world // model
        if data * model != world:
            live = f"'data': {data}" + (f", 'model': {model}"
                                        if model > 1 else "")
            raise ConfigError(f"mesh {{{live}}} must equal the world size "
                              f"{world}")
        if data > 1 and model > 1:
            raise ConfigError(f"mesh {{'data': {data}, 'model': {model}}}: "
                              f"{MODEL_AND_DATA}")
        # one axis above 1 at a time: its group is every rank
        groups = {a: dist.group.WORLD for a, n in (("data", data),
                                                   ("model", model)) if n > 1}
        return cls({"data": data, "model": model}, groups)

    def axis_size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else self.sizes.get(axis, 1)

    def group(self, axis: str):
        if self.axis_size(axis) <= 1:
            raise ValueError(f"mesh axis '{axis}' has size 1: no group")
        return self.groups[axis]

    def rank(self, axis: str) -> int:
        return comm.get_rank(self.groups[axis]) \
            if self.axis_size(axis) > 1 else 0

    @property
    def data_parallel_size(self) -> int:
        return self.sizes["data"]

    @property
    def model_parallel_size(self) -> int:
        return self.sizes["model"]

    def __repr__(self) -> str:
        live = {a: n for a, n in self.sizes.items() if n > 1}
        return f"Topology({live or {'data': 1}})"


_TOPOLOGY: Optional[Topology] = None


def get_topology() -> Topology:
    """The current topology (built from the process group on first use)."""
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = Topology.build()
    return _TOPOLOGY


def set_topology(topo: Topology) -> None:
    global _TOPOLOGY
    _TOPOLOGY = topo


def reset_topology() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None


def collective_axis_size(axis_name: Optional[str]) -> int:
    """Size of a mesh axis in the current topology (1 for ``None``)."""
    return get_topology().axis_size(axis_name)


def shard_slices(shape, spec, tp: int, rank: int) -> tuple:
    """The index of group rank ``rank``'s shard of a leaf of ``shape``
    placed by ``spec`` (a :class:`PartitionSpec`): the dimension marked
    ``"model"`` is cut into ``tp`` equal pieces, the others are whole."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec!r} does not match a leaf of shape "
                         f"{tuple(shape)}")
    index = []
    for n, axis in zip(shape, spec):
        if axis == "model" and tp > 1:
            if n % tp:
                raise ValueError(f"a dimension of {n} does not divide over "
                                 f"the model axis {tp}")
            k = n // tp
            index.append(slice(rank * k, (rank + 1) * k))
        else:
            index.append(slice(None))
    return tuple(index)

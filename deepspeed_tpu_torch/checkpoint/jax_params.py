"""Carry a JAX parameter tree into the port's ``Transformer`` or
``SequentialBlockModel``, and export it back.

The JAX package's ``Transformer.init`` returns a tree of arrays: top-level
``tok_embed`` ``[vocab, d]``, ``final_norm_w`` ``[d]``, ``lm_head``
``[d, vocab]``, and ``layers`` whose leaves are stacked ``[n_layers, ...]``
(``deepspeed_tpu/models/transformer.py``). Both packages keep the ``[in,
out]`` layout, so a leaf copies over as it is. The port imports nothing
of JAX for this: the caller converts the tree to nested dicts of numpy
arrays first (``jax.tree_util.tree_map(np.asarray, params)``).

The JAX ``SequentialBlockModel`` tree is ``{"block_i": {"w": [din, dout],
"b": [dout]}}``; the port's model names the same leaves ``block_i.w`` and
``block_i.b`` (:func:`load_block_params`, :func:`export_block_params`).

Tensor parallelism: :func:`shard_params` cuts a model (in place) or a
JAX tree (numpy views) to one rank's shard by the JAX package's
PartitionSpecs (``Transformer.partition_specs``), and
:func:`gather_params` puts the ranks' shards back together. A model
that is already sharded takes :func:`load_jax_params` of the full JAX
tree: each leaf is sliced to the rank's shard before it is copied, one
leaf at a time.

The JAX ragged engine's hand-off objects carry over too: a ``KVExport``
(:func:`load_kv_export`) or a ``PrefixExport`` (:func:`load_prefix_export`)
with numpy pages and scales becomes the port's, bytes unchanged, so the
port's engine can continue a prefill that the JAX engine ran.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..inference.ragged import KVExport
from ..models.transformer import LAYER_LEAVES as _LAYER_LEAVES, Transformer
from ..parallel.mesh import shard_slices
from ..parallel.zero import SequentialBlockModel
from ..serving.kvtier import PrefixExport

_TOP_LEAVES = ("tok_embed", "final_norm_w", "lm_head")


def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX leaf has shape {tuple(arr.shape)}, the "
                         f"model expects {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr, np.float32)))


@torch.no_grad()
def load_jax_params(model: Transformer, params_np: Dict[str, Any]
                    ) -> Transformer:
    """Copy ``params_np`` (nested dicts of numpy arrays in the JAX
    package's layout) into ``model``'s weights, in place, on the model's
    device and in its dtype. Missing or extra leaves and shape mismatches
    raise. Returns ``model``."""
    layers = params_np.get("layers")
    if not isinstance(layers, dict):
        raise ValueError("params has no 'layers' dict")
    extra = (set(params_np) - set(_TOP_LEAVES) - {"layers"}) \
        | (set(layers) - set(_LAYER_LEAVES))
    missing = (set(_TOP_LEAVES) - set(params_np)) \
        | (set(_LAYER_LEAVES) - set(layers))
    if extra or missing:
        raise ValueError(f"JAX params do not match the Llama flag set: "
                         f"missing {sorted(missing)}, unexpected "
                         f"{sorted(extra)}")
    # a sharded model takes this rank's slice of each full-width leaf
    local = model.local_shard if model._tp_size > 1 else (lambda _, a: a)
    for name in _TOP_LEAVES:
        _copy(getattr(model, name), local(name, np.asarray(params_np[name])),
              name)
    n = len(model.layers)
    for name in _LAYER_LEAVES:
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != n:
            raise ValueError(f"layers/{name}: {stacked.shape[0]} layers, the "
                             f"model has {n}")
        for i, blk in enumerate(model.layers):
            _copy(getattr(blk, name), local(f"layers.{i}.{name}", stacked[i]),
                  f"layers/{name}[{i}]")
    return model


def _tree_specs(specs: Dict[str, Any]):
    """(path, spec) of every leaf of a JAX-layout spec tree."""
    for name, spec in specs.items():
        if isinstance(spec, dict):
            for leaf, sp in spec.items():
                yield (name, leaf), sp
        else:
            yield (name,), spec


def shard_params(params: Union[Transformer, Dict[str, Any]], topology,
                 model: Optional[Transformer] = None):
    """This rank's shard over ``topology``'s ``model`` axis. A
    :class:`Transformer` is cut in place (``Transformer.shard_``) and
    returned; a JAX tree of numpy arrays (``model`` gives its specs)
    becomes the same tree of this rank's slices, views of its leaves."""
    if isinstance(params, Transformer):
        return params.shard_(topology)
    if model is None:
        raise ValueError("shard_params of a JAX tree needs the model whose "
                         "partition_specs place it")
    tp, rank = topology.model_parallel_size, topology.rank("model")
    out: Dict[str, Any] = {}
    for path, spec in _tree_specs(model.partition_specs()):
        arr = np.asarray(params[path[0]] if len(path) == 1
                         else params[path[0]][path[1]])
        piece = arr[shard_slices(arr.shape, spec, tp, rank)]
        if len(path) == 1:
            out[path[0]] = piece
        else:
            out.setdefault(path[0], {})[path[1]] = piece
    return out


def gather_params(shards: Sequence[Dict[str, Any]], model: Transformer
                  ) -> Dict[str, Any]:
    """The inverse of :func:`shard_params` on JAX trees: the ranks' shards
    (in rank order, as :func:`export_params` gives them on each rank)
    joined along each leaf's ``model`` dimension; replicated leaves are
    rank 0's."""
    out: Dict[str, Any] = {}
    for path, spec in _tree_specs(model.partition_specs()):
        pieces = [np.asarray(t[path[0]] if len(path) == 1
                             else t[path[0]][path[1]]) for t in shards]
        axis = list(spec).index("model") if "model" in spec else None
        full = pieces[0] if axis is None else np.concatenate(pieces, axis)
        if len(path) == 1:
            out[path[0]] = full
        else:
            out.setdefault(path[0], {})[path[1]] = full
    return out


def export_params(params: Union[Transformer, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, Any]:
    """The inverse of :func:`load_jax_params`: a model's weights (or a
    ``{name: tensor}`` dict with the names of its ``named_parameters()``,
    such as a ``TrainEngine``'s ``params``) as nested dicts of fp32 numpy
    arrays in the JAX package's layout, layer leaves stacked
    ``[n_layers, ...]``."""
    if isinstance(params, Transformer):
        params = dict(params.named_parameters())

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    n = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("layers."))
    out: Dict[str, Any] = {name: arr(params[name]) for name in _TOP_LEAVES}
    out["layers"] = {name: np.stack([arr(params[f"layers.{i}.{name}"])
                                     for i in range(n)])
                     for name in _LAYER_LEAVES}
    return out


@torch.no_grad()
def load_block_params(model: SequentialBlockModel,
                      params_np: Mapping[str, Mapping[str, Any]]
                      ) -> SequentialBlockModel:
    """Copy a JAX ``SequentialBlockModel`` tree (``{"block_i": {"w", "b"}}``
    of numpy arrays) into ``model``'s weights, in place. Missing or extra
    blocks or leaves and shape mismatches raise. Returns ``model``."""
    own = dict(model.named_parameters())
    theirs = {f"{blk}.{leaf}": v for blk, leaves in params_np.items()
              for leaf, v in leaves.items()}
    if set(own) != set(theirs):
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{sorted(set(own) - set(theirs))}, unexpected "
                         f"{sorted(set(theirs) - set(own))}")
    for name, dst in own.items():
        _copy(dst, theirs[name], name)
    return model


def export_block_params(params: Union[SequentialBlockModel,
                                      Mapping[str, torch.Tensor]]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`load_block_params`: a model's weights, or a
    ``{"block_i.w": tensor, ...}`` dict such as ``TrainEngine.full_params()``,
    as the JAX tree of fp32 numpy arrays."""
    if isinstance(params, SequentialBlockModel):
        params = dict(params.named_parameters())
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        blk, leaf = name.split(".")
        out.setdefault(blk, {})[leaf] = t.detach().float().cpu().numpy()
    return out


def _host_tensor(a: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor with the same bytes; bfloat16 (an
    ``ml_dtypes`` array, which torch cannot take) through an int16 view."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def load_kv_export(export: Any) -> KVExport:
    """The port's :class:`~deepspeed_tpu_torch.inference.ragged.KVExport`
    of a JAX ``KVExport`` (numpy pages and scales), bytes unchanged, for
    ``RaggedInferenceEngine.import_kv``."""
    scales = [None if a is None else _host_tensor(a)
              for a in (export.k_scales, export.v_scales)]
    return KVExport(
        uid=int(export.uid), tokens=[int(t) for t in export.tokens],
        seen=int(export.seen), prompt_len=int(export.prompt_len),
        kv_block_size=int(export.kv_block_size),
        n_layers=int(export.n_layers), n_kv_heads=int(export.n_kv_heads),
        head_dim=int(export.head_dim), dtype=str(export.dtype),
        k_pages=_host_tensor(export.k_pages),
        v_pages=_host_tensor(export.v_pages),
        kv_quant=str(export.kv_quant), k_scales=scales[0],
        v_scales=scales[1])


def load_prefix_export(export: Any) -> PrefixExport:
    """The port's :class:`~deepspeed_tpu_torch.serving.kvtier.PrefixExport`
    of a JAX ``PrefixExport``, bytes unchanged and keeping the checksum
    the JAX side stamped (so ``verify`` still catches corruption on the
    way)."""
    def pair(p):
        return None if p is None else tuple(_host_tensor(a) for a in p)
    return PrefixExport(
        tokens=export.tokens, n_pages=export.n_pages,
        block_size=export.block_size, n_layers=export.n_layers,
        n_kv_heads=export.n_kv_heads, head_dim=export.head_dim,
        dtype=export.dtype, kv_quant=export.kv_quant,
        pages=pair(export.pages), scales=pair(export.scales),
        wire_bytes=export.wire_bytes, logical_bytes=export.logical_bytes,
        source=export.source, checksum=export.checksum)

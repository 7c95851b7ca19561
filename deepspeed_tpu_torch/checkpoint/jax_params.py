"""Carry a JAX parameter tree into the port's ``Transformer``.

The JAX package's ``Transformer.init`` returns a tree of arrays: top-level
``tok_embed`` ``[vocab, d]``, ``final_norm_w`` ``[d]``, ``lm_head``
``[d, vocab]``, and ``layers`` whose leaves are stacked ``[n_layers, ...]``
(``deepspeed_tpu/models/transformer.py``). Both packages keep the ``[in,
out]`` layout, so a leaf copies over as it is. The port imports nothing
of JAX for this: the caller converts the tree to nested dicts of numpy
arrays first (``jax.tree_util.tree_map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..models.transformer import LAYER_LEAVES as _LAYER_LEAVES, Transformer

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
    for name in _TOP_LEAVES:
        _copy(getattr(model, name), params_np[name], name)
    n = len(model.layers)
    for name in _LAYER_LEAVES:
        stacked = np.asarray(layers[name])
        if stacked.shape[0] != n:
            raise ValueError(f"layers/{name}: {stacked.shape[0]} layers, the "
                             f"model has {n}")
        for i, blk in enumerate(model.layers):
            _copy(getattr(blk, name), stacked[i], f"layers/{name}[{i}]")
    return model


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

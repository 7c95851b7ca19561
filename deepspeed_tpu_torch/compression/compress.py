"""Compression: QAT weight quantization, magnitude pruning (sparse, row,
head), layer reduction and their schedule.

Ports ``deepspeed_tpu/compression/compress.py`` (``CompressionConfig``,
``Compressor``, ``init_compression``, ``redundancy_clean``; the
reference's ``compression_training`` vocabulary, taken verbatim).
Compression is a transform of the compute copy installed at the engine's
cast boundary (``TrainEngine.register_param_transform``): QAT is
``ops.quantizer.fake_quantize`` (straight-through) on the matched leaves,
pruning multiplies masks made once when a technique's
``schedule_offset`` is crossed, and ``redundancy_clean`` bakes the masks
into the weights. The schedule runs as a step hook
(``register_step_hook``).

The JAX tree stacks each per-layer leaf ``[n_layers, ...]`` under
``['layers']``; the port keeps one leaf a layer (``layers.<i>.<leaf>``).
Everything that reads a leaf whole reads the stack of a leaf's layers,
so it picks what JAX's picks: techniques match ``modules`` substrings
against the stacked leaf's ``jax.tree_util.keystr`` path
(``['layers']['w_up']``; ``teacher_layer`` indexes the same layers);
a leaf is prunable by the stacked leaf's rank; the magnitude threshold,
the row norms and the head importances are taken over the stack; QAT's
block is chosen from the stack's size. The masks are computed on the
host with the JAX function's numpy code (``np.partition`` for the k-th
largest magnitude), so they are the same elements bit for bit, and ties
are broken as there: every element whose magnitude equals the threshold
is kept (a threshold, not a top-k, so no sort order enters).

Under tensor parallelism or ZeRO stage 3 over data ranks (leaves cut into
shards) the compressor raises: it comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.quantizer import fake_quantize
from ..utils.logging import log_dist

Params = Dict[str, torch.Tensor]


def _groups(section: Dict[str, Any]) -> List[Dict[str, Any]]:
    """``shared_parameters`` + ``different_groups`` as a list of groups."""
    shared = section.get("shared_parameters", {})
    if not shared.get("enabled", False):
        return []
    out = []
    dg = section.get("different_groups", {}) or {"default": {}}
    for name, g in dg.items():
        params = dict(g.get("params", {}))
        out.append({
            "name": name,
            "modules": g.get("modules", ["*"]),
            "schedule_offset": int(shared.get("schedule_offset", 0)),
            "schedule_offset_end": shared.get("schedule_offset_end"),
            "method": shared.get("method", "l1"),
            **params,
        })
    return out


@dataclass
class CompressionConfig:
    weight_quantization: List[Dict[str, Any]] = field(default_factory=list)
    sparse_pruning: List[Dict[str, Any]] = field(default_factory=list)
    row_pruning: List[Dict[str, Any]] = field(default_factory=list)
    head_pruning: List[Dict[str, Any]] = field(default_factory=list)
    layer_reduction: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, cfg: Optional[Dict[str, Any]]) -> "CompressionConfig":
        cfg = cfg or {}
        ct = cfg.get("compression_training", cfg)
        lr = ct.get("layer_reduction", {})
        return cls(
            weight_quantization=_groups(ct.get("weight_quantization", {})),
            sparse_pruning=_groups(ct.get("sparse_pruning", {})),
            row_pruning=_groups(ct.get("row_pruning", {})),
            head_pruning=_groups(ct.get("head_pruning", {})),
            layer_reduction=lr if lr.get("enabled") else {},
        )

    def any_enabled(self) -> bool:
        return bool(self.weight_quantization or self.sparse_pruning
                    or self.row_pruning or self.head_pruning
                    or self.layer_reduction)


def stacked_leaves(names) -> Dict[str, List[str]]:
    """``{keystr of the JAX leaf: [port names, layer by layer]}``: a
    per-layer leaf's layers under its stacked leaf's path, another leaf
    alone under its own."""
    from ..runtime.engine import _LAYER, _keystr

    out: Dict[str, Dict[int, str]] = {}
    for name in names:
        m = _LAYER.search(name)
        if m:
            key = name[:m.start()] + m.group(1) + "layers." + name[m.end():]
            out.setdefault(_keystr(key), {})[int(m.group(2))] = name
        else:
            out.setdefault(_keystr(name), {})[-1] = name
    return {k: [v[i] for i in sorted(v)] for k, v in out.items()}


def _matches(path: str, modules: List[str]) -> bool:
    return any(m == "*" or m in path for m in modules)


def _is_stack(names: List[str]) -> bool:
    from ..runtime.engine import _LAYER

    return _LAYER.search(names[0]) is not None


def _prunable(tree: Params, names: List[str]) -> bool:
    """JAX's rule on the stacked leaf: floating and of rank >= 2."""
    t = tree[names[0]]
    return t.is_floating_point() and t.dim() + _is_stack(names) >= 2


def _stack(tree: Params, names: List[str]) -> torch.Tensor:
    return torch.stack([tree[n] for n in names]) if _is_stack(names) \
        else tree[names[0]]


class Compressor:
    """Masks and schedule state per technique; its :meth:`transform` is
    the engine's params transform."""

    def __init__(self, config: CompressionConfig):
        self.config = config
        self.masks: Dict[str, np.ndarray] = {}       # keystr -> mask
        self._dev_masks: Dict[Tuple[str, Any], torch.Tensor] = {}
        self._mask_done: set = set()
        self._active_quant: bool = False
        self._active_groups: set = set()
        self._quant_bits: Dict[str, int] = {}

    @staticmethod
    def _bits_at(g: Dict[str, Any], step: int) -> int:
        """Progressive bit reduction: bits halve from ``start_bits``
        toward ``target_bits`` every ``quantization_period`` steps past
        the schedule offset."""
        target = int(g.get("target_bits", g.get("start_bits", 8)))
        start = int(g.get("start_bits", target))
        period = int(g.get("quantization_period", 1))
        if start <= target or period <= 0:
            return target
        halvings = max(0, (step - int(g["schedule_offset"])) // period)
        return max(target, start >> min(halvings, start.bit_length()))

    def _compute_masks(self, params: Params, kind: str,
                       group: Dict[str, Any]) -> None:
        """The JAX function's mask arithmetic on the host, over each
        matched stacked leaf."""
        ratio = float(group.get("dense_ratio", 0.5))
        for path, names in stacked_leaves(params).items():
            if not (_prunable(params, names)
                    and _matches(path, group["modules"])):
                continue
            w = _stack(params, names).detach().float().cpu().numpy()
            if kind == "sparse":
                k = max(1, int(round(w.size * ratio)))
                thresh = np.partition(np.abs(w).reshape(-1), -k)[-k]
                mask = (np.abs(w) >= thresh).astype(np.float32)
            elif kind == "row":
                norms = np.sum(np.abs(w), axis=tuple(range(w.ndim - 1)))
                k = max(1, int(round(norms.size * ratio)))
                thresh = np.partition(norms, -k)[-k]
                mask = (norms >= thresh).astype(np.float32)       # [out]
            elif kind == "head":
                nh = int(group["num_heads"])
                din = w.shape[-2]
                assert din % nh == 0, (path, w.shape, nh)
                hd = din // nh
                per_head = (np.abs(w).reshape(-1, nh, hd, w.shape[-1])
                            .sum(axis=(0, 2, 3)))                  # [nh]
                k = max(1, int(round(nh * ratio)))
                thresh = np.partition(per_head, -k)[-k]
                hmask = (per_head >= thresh).astype(np.float32)
                mask = np.repeat(hmask, hd)[:, None]               # [in, 1]
            else:
                raise ValueError(kind)
            prev = self.masks.get(path)
            self.masks[path] = mask if prev is None else prev * mask
        self._dev_masks.clear()
        log_dist(f"compression: {kind} mask activated for group "
                 f"'{group['name']}' ({group['modules']})")

    @staticmethod
    def _in_window(g: Dict[str, Any], step: int) -> bool:
        end = g.get("schedule_offset_end")
        return step >= g["schedule_offset"] and (end is None
                                                 or step < int(end))

    @staticmethod
    def _whole_params(engine) -> Params:
        if getattr(engine, "tp_sharded", None) or any(
                tuple(p.shape) != engine.full_shapes[n]
                for n, p in engine.params.items()):
            raise NotImplementedError(
                "compression over leaves cut into shards (tensor "
                "parallelism, ZeRO stage 3 over data ranks) comes with a "
                "later slice of deepspeed_tpu_torch (ROADMAP.md, Queue A "
                "item 12)")
        return engine.params

    def step(self, engine, global_step: int) -> None:
        """The engine's step hook: masks (re)computed where an offset is
        crossed, techniques retired past ``schedule_offset_end``, and the
        transform re-registered only when the active set changes."""
        changed = False
        kinds = (("sparse", self.config.sparse_pruning),
                 ("row", self.config.row_pruning),
                 ("head", self.config.head_pruning))
        for kind, groups in kinds:
            for g in groups:
                key = (kind, g["name"])
                if key not in self._mask_done and self._in_window(
                        g, global_step):
                    self._compute_masks(self._whole_params(engine), kind, g)
                    self._mask_done.add(key)
                    changed = True
                end = g.get("schedule_offset_end")
                if (key in self._mask_done and end is not None
                        and global_step >= int(end)):
                    # retire this group: the survivors' masks again
                    self._mask_done.discard(key)
                    g["schedule_offset"] = float("inf")
                    self.masks.clear()
                    for k2, gs2 in kinds:
                        for g2 in gs2:
                            if (k2, g2["name"]) in self._mask_done:
                                self._compute_masks(
                                    self._whole_params(engine), k2, g2)
                    self._dev_masks.clear()
                    changed = True
        want_quant = any(self._in_window(g, global_step)
                         for g in self.config.weight_quantization)
        if want_quant != self._active_quant:
            self._active_quant = want_quant
            changed = True
        active = {g["name"] for g in self.config.weight_quantization
                  if self._in_window(g, global_step)}
        if active != self._active_groups:
            self._active_groups = active
            changed = True
        for g in self.config.weight_quantization:
            if g["name"] not in active:
                continue
            bits = self._bits_at(g, global_step)
            if self._quant_bits.get(g["name"]) != bits:
                self._quant_bits[g["name"]] = bits
                changed = True
        if changed and hasattr(engine, "register_param_transform"):
            engine.register_param_transform(self.transform)

    def _mask_for(self, path: str, i: int, like: torch.Tensor
                  ) -> Optional[torch.Tensor]:
        """Layer ``i``'s part of ``path``'s mask (a sparse mask is cut;
        row and head masks broadcast over the layers) on ``like``'s
        device and dtype."""
        m = self.masks.get(path)
        if m is None:
            return None
        key = (path, i, like.device, like.dtype)
        t = self._dev_masks.get(key)
        if t is None:
            full = torch.from_numpy(np.ascontiguousarray(m))
            if i >= 0 and full.dim() == like.dim() + 1:
                full = full[i]
            t = full.to(device=like.device, dtype=like.dtype)
            self._dev_masks[key] = t
        return t

    def transform(self, params: Params) -> Params:
        """Masks, then QAT, on the compute copy (inside autograd)."""
        out = dict(params)
        quant = ([g for g in self.config.weight_quantization
                  if g["name"] in self._active_groups]
                 if self._active_quant else [])
        for path, names in stacked_leaves(params).items():
            stack = _is_stack(names)
            for i, n in enumerate(names):
                m = self._mask_for(path, i if stack else -1, out[n])
                if m is not None:
                    out[n] = out[n] * m
            for g in quant:
                if _prunable(out, names) and _matches(path, g["modules"]):
                    bits = self._quant_bits.get(
                        g["name"], int(g.get("target_bits",
                                             g.get("start_bits", 8))))
                    size = sum(out[n].numel() for n in names)
                    block = next((b for b in (256, 128, 64, 32, 16)
                                  if size % b == 0), None)
                    if bits < 16 and block is not None:
                        self._fake_quantize(out, names,
                                            8 if bits > 4 else 4, block)
                    break
        return out

    @staticmethod
    def _fake_quantize(tree: Params, names: List[str], bits: int,
                       block: int) -> None:
        """``fake_quantize`` of the stacked leaf: layer by layer where no
        block straddles two layers (the same blocks), else on the
        stack."""
        if all(tree[n].numel() % block == 0 for n in names):
            for n in names:
                tree[n] = fake_quantize(tree[n], bits=bits, block=block)
            return
        q = fake_quantize(_stack(tree, names), bits=bits, block=block)
        if not _is_stack(names):
            tree[names[0]] = q
            return
        for n, t in zip(names, q.unbind(0)):
            tree[n] = t

    def student_params(self, params: Params) -> Params:
        """Layer reduction (the student's initial weights) of a
        ``{name: tensor}`` tree, before ``initialize`` (shapes change)."""
        if not self.config.layer_reduction:
            return params
        return _apply_layer_reduction(params, self.config.layer_reduction)

    def clean(self, params: Params) -> Params:
        """The masks baked into the weights (new tensors)."""
        out = dict(params)
        for path, names in stacked_leaves(params).items():
            stack = _is_stack(names)
            for i, n in enumerate(names):
                m = self._mask_for(path, i if stack else -1, out[n])
                if m is not None:
                    out[n] = (out[n] * m).to(out[n].dtype)
        return out


def _apply_layer_reduction(params: Params, lr_cfg: Dict[str, Any]
                           ) -> Params:
    """Keep the ``teacher_layer`` layers (default the first
    ``keep_number_layer``), renumbered from 0 in that order."""
    from ..runtime.engine import _LAYER

    keep = lr_cfg.get("teacher_layer")
    if keep is None:
        keep = list(range(int(lr_cfg["keep_number_layer"])))
    new_index = {int(t): j for j, t in enumerate(keep)}
    out: Params = {}
    for name, t in params.items():
        m = _LAYER.search(name)
        if not m:
            out[name] = t
            continue
        j = new_index.get(int(m.group(2)))
        if j is not None:
            out[f"{name[:m.start()]}{m.group(1)}layers.{j}."
                f"{name[m.end():]}"] = t
    log_dist(f"compression: layer reduction -> {len(keep)} layers {keep}")
    return out


def init_compression(engine_or_params: Any, config: Any) -> Compressor:
    """The reference's ``init_compression(model, ds_config)``. Given a
    ``TrainEngine`` the schedule runs as its step hook and the transform
    is registered with it (offsets at 0 activate now); given a params
    tree the compressor is driven by hand (``step`` / ``transform``).
    Layer reduction changes shapes, so it runs on params before
    ``initialize`` (``student_params``)."""
    ccfg = (config if isinstance(config, CompressionConfig)
            else CompressionConfig.from_dict(config))
    comp = Compressor(ccfg)
    engine = engine_or_params if hasattr(engine_or_params, "train_batch") \
        else None
    if engine is not None:
        if ccfg.layer_reduction:
            raise ValueError(
                "layer_reduction must be applied before initialize(): "
                "comp = init_compression(params, cfg); "
                "params = comp.student_params(params)")
        engine.register_step_hook(comp.step)
        comp.step(engine, engine.global_steps)
    return comp


def redundancy_clean(params_or_engine: Any, config: Any,
                     compressor: Optional[Compressor] = None) -> Params:
    """The reference's ``redundancy_clean``: the weights with the
    compressor's masks baked in (an engine's masters, or a params
    tree)."""
    ccfg = (config if isinstance(config, CompressionConfig)
            else CompressionConfig.from_dict(config))
    if hasattr(params_or_engine, "train_batch"):
        params = Compressor._whole_params(params_or_engine)
    else:
        params = params_or_engine
    comp = compressor or Compressor(ccfg)
    return comp.clean(params)

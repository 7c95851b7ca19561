"""Mixture-of-Experts: top-k gating and the no-drop expert dispatch.

Ports the one-device parts of ``deepspeed_tpu/parallel/moe.py``:

* :class:`GateConfig` and :func:`capacity`;
* :func:`top_k_gating`, the training route: softmax probabilities, the
  greedy top-1 / top-2 choice (Gumbel noise under ``RSample``), each
  token's place in its expert's queue by a cumsum over the tokens, the
  second choice's places offset by the first choice's counts, tokens past
  ``capacity`` dropped, and the load-balancing aux loss;
* :func:`no_drop_moe`, the eval and serving route: the (token, k) pairs
  stably sorted by expert id, one grouped GEMM a projection over the
  experts' contiguous row segments, the gate-weighted rows scatter-added
  back in ``x``'s dtype. No capacity buffer exists, so no token is dropped
  and a sequence's output does not depend on the traffic beside it;
* :class:`MoELayer` (``init`` / ``apply``): the eval route (fp32 gate
  logits, softmax, top-k, the top-k weights renormalised) and the
  training route (capacity dispatch per batch row, as the JAX ``vmap``
  over rows), with ``Jitter`` (the router's input times U(0.99, 1.01)).

Noise comes from an explicit ``torch.Generator`` (the JAX package's
``rng`` key); the two frameworks draw different numbers from one seed.

The grouped GEMM (:func:`grouped_mm`; ``jax.lax.ragged_dot`` in the JAX
package, an XLA op, not a Pallas kernel) has two routes, chosen by
:func:`grouped_route` from the device and dtype before the call:

* ``"grouped"``: one ``torch._grouped_mm(a, b, offs=cumsum(sizes))`` a
  projection on CUDA tensors. The offsets stay on the device, so the
  serving path reads nothing back to the host. The bank is the row-major
  ``[E, in, out]`` leaf as stored (the JAX package's layout; no copy is
  made at load or a call). On the H100 under torch 2.11
  ``_grouped_mm`` takes it in bf16, fp16 and fp32, with empty groups,
  wherever the in / out widths are multiples of 16 bytes (every preset's
  are); it refuses other widths ("strides should be multiple of 16
  bytes") and an empty ``a``;
* ``"loop"``: the plain version, one ``torch.matmul`` a non-empty group
  after a host copy of the group sizes. CPU tensors take it (so the
  tests' JAX parity runs through it), as do CUDA tensors whose widths are
  not 16-byte multiples, and a product asked for in a wider ``out_dtype``
  than ``a``'s (``_grouped_mm`` writes ``a``'s dtype only): each group's
  ``torch.mm(..., out_dtype=...)`` on the card, fp32 operands on the CPU.
  An empty ``a`` gives an empty product on either route without a call.

Tensor parallelism: :meth:`MoELayer.partition_specs` are the JAX
package's (``w_up`` / ``w_gate`` ``(expert, None, model)``, ``w_down``
``(expert, model, None)``, ``b_up`` ``(expert, model)``, ``b_down`` and
``wg`` replicated). Over the ``model`` axis a rank holds ``d_ff / tp`` of
every expert, routes every token itself (the gate reads the same states
on every rank: they come out of the model group's all-reduce, which
hands every rank the same bits) and sums its fp32 ``w_down`` partial rows
over the group (``reduce``) before they are rounded and ``b_down`` is
added, so each row is rounded once, where one device's grouped GEMM
rounds it. The capacity route (training) runs over ``model`` the same
way: every rank gates every token from the same bits (a noisy gate draws
the same noise from the same generator), the dispatched rows enter the
rank's ``d_ff`` slice of ``w_up`` / ``w_gate`` through ``copy`` (in
training ``comm.tp_copy``: the backward sums the input gradients over
the group) and the fp32 ``w_down`` partials go through ``reduce`` (in
training ``comm.tp_sum``) before they are rounded and combined. The
``expert`` axis stays size 1: expert parallelism comes with item 13
(``parallel/mesh.py`` refuses the axis).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from .mesh import PartitionSpec as P

Params = Dict[str, torch.Tensor]

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclass
class GateConfig:
    """Copy of the JAX package's gate config (same fields and defaults)."""

    n_experts: int = 8
    top_k: int = 2                    # 1 or 2 (reference supports k in {1,2})
    capacity_factor: float = 1.25     # train capacity
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None  # None | 'RSample' | 'Jitter'
    drop_tokens: bool = True
    aux_loss_weight: float = 0.01


def capacity(tokens_per_group: int, cfg: GateConfig, training: bool) -> int:
    """Slots an expert has in a group of ``tokens_per_group`` tokens:
    ``ceil(tokens * factor * top_k / n_experts)``, at least
    ``min_capacity``; without ``drop_tokens``, the whole group (the static
    worst case)."""
    if not cfg.drop_tokens:
        return tokens_per_group
    f = cfg.capacity_factor if training else cfg.eval_capacity_factor
    cap = int(math.ceil(tokens_per_group * f * cfg.top_k / cfg.n_experts))
    return max(cap, cfg.min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` (integer or integer-valued float) over
    ``n`` classes; an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_gating(logits: torch.Tensor, cfg: GateConfig, cap: int,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine weights and dispatch mask of top-1 / top-2 routing.

    logits: ``[..., S, E]`` router logits of groups of S tokens (the JAX
    function takes one group; leading dims are groups, each routed on
    its own). Returns (combine ``[..., S, E, cap]`` fp32, dispatch bool of
    the same shape, aux ``[...]``), the JAX package's arithmetic step for
    step: the aux loss is ``E * mean(probs) . mean(top-1 assignment)``
    over the group's tokens, taken before drops."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    if cfg.noisy_gate_policy == "RSample" and training \
            and generator is not None:
        # Gumbel(0, 1) = -log(-log(U)), U in [tiny, 1), as jax.random.gumbel
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        idx1 = torch.argmax(logits + -torch.log(-torch.log(u)), dim=-1)
    else:
        idx1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(idx1, E)                                 # [..., S, E]
    me = torch.mean(probs, dim=-2)
    ce = torch.mean(mask1, dim=-2)
    aux = torch.sum(me * ce, dim=-1) * E
    # each token's place in its expert's queue
    pos1 = torch.cumsum(mask1, dim=-2) - mask1
    pos1_tok = torch.sum(pos1 * mask1, dim=-1)                # [..., S]
    if cfg.drop_tokens:
        mask1 = mask1 * (pos1_tok < cap)[..., None]
    gates1 = torch.sum(probs * mask1, dim=-1)
    if cfg.top_k == 2:
        probs2 = probs * (1.0 - _one_hot(idx1, E))
        idx2 = torch.argmax(probs2, dim=-1)
        mask2 = _one_hot(idx2, E)
        pos2 = torch.cumsum(mask2, dim=-2) - mask2 \
            + torch.sum(mask1, dim=-2, keepdim=True)
        pos2_tok = torch.sum(pos2 * mask2, dim=-1)
        if cfg.drop_tokens:
            mask2 = mask2 * (pos2_tok < cap)[..., None]
        gates2 = torch.sum(probs * mask2, dim=-1)
        denom = torch.clamp(gates1 + gates2, min=1e-9)
        gates1, gates2 = gates1 / denom, gates2 / denom
        combine = (gates1[..., None, None] * mask1[..., None]
                   * _one_hot(pos1_tok, cap)[..., None, :]
                   + gates2[..., None, None] * mask2[..., None]
                   * _one_hot(pos2_tok, cap)[..., None, :])
    else:
        combine = gates1[..., None, None] * mask1[..., None] \
            * _one_hot(pos1_tok, cap)[..., None, :]
    return combine, combine > 0, aux


def grouped_route(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> str:
    """The grouped GEMM's route for ``a [M, in]`` times a bank ``b [E, in,
    out]``: ``"grouped"`` (``torch._grouped_mm``) on CUDA tensors whose
    in and out widths are 16-byte multiples and whose product is wanted
    in ``a``'s dtype, else ``"loop"``. Decided from the device, dtypes and
    widths alone, before the call."""
    if not a.is_cuda or out_dtype not in (None, a.dtype):
        return "loop"
    align = 16 // a.element_size()
    return "grouped" if a.shape[-1] % align == 0 \
        and b.shape[-1] % align == 0 else "loop"


def _grouped_mm_loop(a: torch.Tensor, b: torch.Tensor,
                     group_sizes: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The plain grouped GEMM: rows ``[off_g, off_g + n_g)`` of ``a`` times
    ``b[g]``, one matmul a non-empty group (the group sizes are read on
    the host). -> ``[M, out]`` in ``out_dtype``: a wider one than ``a``'s
    keeps the fp32 accumulator unrounded (``torch.mm``'s ``out_dtype`` on
    the card, fp32 operands on the CPU)."""
    out = torch.empty((a.shape[0], b.shape[-1]), dtype=out_dtype,
                      device=a.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        if n:
            rows = out[start:start + n]
            if out_dtype == a.dtype:
                torch.matmul(a[start:start + n], b[g], out=rows)
            elif a.is_cuda:
                rows.copy_(torch.mm(a[start:start + n], b[g],
                                    out_dtype=out_dtype))
            else:
                torch.matmul(a[start:start + n].to(out_dtype),
                             b[g].to(out_dtype), out=rows)
        start += n
    return out


def grouped_mm(a: torch.Tensor, b: torch.Tensor, group_sizes: torch.Tensor,
               route: Optional[str] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``jax.lax.ragged_dot(a, b, group_sizes)``: ``a [M, in]`` whose rows
    are grouped contiguously by expert (``group_sizes [E]``, summing to
    M), times ``b [E, in, out]`` -> ``[M, out]`` in ``out_dtype`` (default
    ``a``'s). ``route`` (default :func:`grouped_route`) is ``"grouped"``
    or ``"loop"``."""
    out_dtype = out_dtype or a.dtype
    route = route or grouped_route(a, b, out_dtype)
    if a.shape[0] == 0:
        return a.new_empty((0, b.shape[-1]), dtype=out_dtype)
    if route == "loop":
        return _grouped_mm_loop(a, b, group_sizes, out_dtype)
    if route != "grouped" or out_dtype != a.dtype:
        raise ValueError(f"route must be 'grouped' (in a's dtype) or "
                         f"'loop', got {route!r} to {out_dtype}")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    return torch._grouped_mm(a, b, offs=offs)


def no_drop_moe(x_flat: torch.Tensor, probs: torch.Tensor, idx: torch.Tensor,
                params: Params, activation: str,
                route: Optional[str] = None,
                reduce: Reduce = None) -> torch.Tensor:
    """Sort-based no-drop expert dispatch on grouped GEMMs (the JAX
    ``no_drop_moe``, FastGen's ``moe_gather`` / grouped GEMM /
    ``moe_scatter``). x_flat: ``[S, d]``; probs / idx: ``[S, k]`` top-k
    gate weights and expert ids. The pairs are sorted stably by expert
    (tokens in order within an expert), each expert's segment runs
    through :func:`grouped_mm` (``route``), ``b_up`` / ``b_down`` are
    indexed by the sorted expert id, the activation is the tanh GELU
    (``jax.nn.gelu``) or gated SiLU, and the gate-weighted rows, cast to
    ``x``'s dtype, are added into zeros at their tokens. Nothing is read
    back to the host on the ``"grouped"`` route. With banks sharded on
    ``d_ff`` over the model axis, ``reduce`` sums the fp32 ``w_down``
    partial rows over the group (the ``"loop"`` route then takes that
    product); the sum is rounded to ``x``'s dtype once, as one device's
    grouped GEMM rounds its accumulator, and ``b_down``, the gate weights
    and the scatter-add follow as on one device. (Reducing the ``[S, d]``
    combined rows instead would move half the bytes at top-2 but round
    once where one device rounds three times: bf16 outputs would part
    from one device's by an ulp in many elements and flip near-tied
    gates.)"""
    S, k = idx.shape
    E = params["w_up"].shape[0]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = (torch.arange(S * k, device=x_flat.device) // k)[order]
    xs = x_flat[tok]                                          # moe_gather
    # bincount's counts, added on the device: torch.bincount on a CUDA
    # tensor reads its max back to the host first
    group_sizes = torch.zeros(E, dtype=torch.int64, device=flat_e.device) \
        .index_add_(0, flat_e, torch.ones(flat_e.shape, dtype=torch.int64,
                                          device=flat_e.device))
    e_sorted = flat_e[order]
    if activation == "silu_glu":
        h = F.silu(grouped_mm(xs, params["w_gate"], group_sizes, route)) \
            * grouped_mm(xs, params["w_up"], group_sizes, route)
    else:
        h = grouped_mm(xs, params["w_up"], group_sizes, route)
        if "b_up" in params:
            h = h + params["b_up"][e_sorted].to(h.dtype)
        h = F.gelu(h, approximate="tanh")
    if reduce is None:
        ys = grouped_mm(h, params["w_down"], group_sizes, route)  # [S*k, d]
    else:
        ys = reduce(grouped_mm(h, params["w_down"], group_sizes,
                               out_dtype=torch.float32)).to(h.dtype)
    if "b_down" in params:
        ys = ys + params["b_down"][e_sorted].to(ys.dtype)
    w = probs.reshape(-1)[order][:, None].to(ys.dtype)
    return torch.zeros_like(x_flat).index_add_(0, tok,
                                               (ys * w).to(x_flat.dtype))


class MoELayer:
    """A gated bank of expert FFNs. Params: ``{"wg": [d, E], "w_up": [E, d,
    f], "w_gate": [E, d, f] (gated SiLU), "w_down": [E, f, d]}``, plus
    ``"b_up": [E, f]`` and ``"b_down": [E, d]`` with ``use_bias``. Eval
    and serving route through :func:`no_drop_moe`; training with
    ``drop_tokens`` through capacity dispatch."""

    def __init__(self, d_model: int, d_ff: int, gate: GateConfig,
                 activation: str = "silu_glu", use_bias: bool = False):
        self.d_model, self.d_ff, self.gate = d_model, d_ff, gate
        self.activation = activation
        self.use_bias = use_bias

    def shapes(self, n_layers: Optional[int] = None
               ) -> Dict[str, Tuple[int, ...]]:
        """Each leaf's shape, in the JAX ``init``'s order (stacked ``[n_layers,
        ...]`` when ``n_layers`` is given)."""
        E, d, f = self.gate.n_experts, self.d_model, self.d_ff
        lead = (n_layers,) if n_layers else ()
        s = {"wg": (d, E), "w_up": (E, d, f), "w_down": (E, f, d)}
        if self.activation == "silu_glu":
            s["w_gate"] = (E, d, f)
        if self.use_bias:
            s["b_up"] = (E, f)
            s["b_down"] = (E, d)
        return {k: lead + v for k, v in s.items()}

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             n_layers: Optional[int] = None, device=None) -> Params:
        """Fresh weights with the JAX scheme: dense leaves ~ N(0,
        1/fan_in) drawn in fp32 from ``generator`` then cast, biases 0."""
        dev = generator.device if device is None else device
        out = {}
        for name, shape in self.shapes(n_layers).items():
            if name.startswith("b_"):
                out[name] = torch.zeros(shape, dtype=dtype, device=dev)
            else:
                out[name] = (torch.randn(shape, generator=generator,
                                         device=dev, dtype=torch.float32)
                             / math.sqrt(shape[-2])).to(dtype)
        return out

    def apply(self, params: Params, x: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              training: bool = True,
              reduce: Reduce = None,
              copy: Reduce = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: ``[b, s, d]`` -> (out ``[b, s, d]``, aux loss, a 0-dim fp32
        tensor). Token groups are the batch rows (the JAX per-row
        capacity). Eval, or training without ``drop_tokens``, takes the
        no-drop route; its aux is the same load-balance diagnostic over
        the first choice. With banks sharded on ``d_ff`` over the model
        group, ``reduce`` sums a bank's fp32 ``w_down`` partial products
        over the group, and ``copy`` (the capacity route) takes ``x``
        into the bank's column-parallel ``w_up`` / ``w_gate``; the gate
        reads ``x`` itself."""
        b, s, d = x.shape
        cfg = self.gate
        if not training or not cfg.drop_tokens:
            logits = x.float() @ params["wg"].float()
            probs = torch.softmax(logits.reshape(b * s, -1), dim=-1)
            topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
            topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True),
                                      min=1e-9)
            out = no_drop_moe(x.reshape(b * s, d), topw, topi, params,
                              self.activation, reduce=reduce)
            assign = torch.mean(_one_hot(topi[:, 0], cfg.n_experts), dim=0)
            aux = cfg.n_experts * torch.sum(torch.mean(probs, dim=0) * assign)
            return out.reshape(b, s, d), aux
        cap = capacity(s, cfg, training)
        x_r = x
        if cfg.noisy_gate_policy == "Jitter" and generator is not None:
            # multiplicative jitter of the router's input only
            x_r = x * (torch.rand(x.shape, generator=generator,
                                  device=x.device, dtype=torch.float32)
                       * 0.02 + 0.99).to(x.dtype)
        logits = x_r.float() @ params["wg"].float()               # [b, s, E]
        combine, dispatch, aux = top_k_gating(logits, cfg, cap, generator,
                                              training)
        aux = torch.mean(aux)
        xe = x if copy is None else copy(x)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), xe)
        if self.activation == "silu_glu":
            h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in,
                                    params["w_gate"])) \
                * torch.einsum("ebcd,edf->ebcf", expert_in, params["w_up"])
        else:
            h = torch.einsum("ebcd,edf->ebcf", expert_in, params["w_up"])
            if "b_up" in params:
                h = h + params["b_up"][:, None, None, :].to(h.dtype)
            h = F.gelu(h, approximate="tanh")
        if reduce is None:
            expert_out = torch.einsum("ebcf,efd->ebcd", h, params["w_down"])
        else:
            # the rank's d_ff slice: fp32 partials, summed, rounded once
            expert_out = reduce(torch.einsum(
                "ebcf,efd->ebcd", h.float(),
                params["w_down"].float())).to(h.dtype)
        if "b_down" in params:
            expert_out = expert_out \
                + params["b_down"][:, None, None, :].to(expert_out.dtype)
        out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), expert_out)
        return out, aux

    def partition_specs(self, n_layers: Optional[int] = None,
                        pipe: Optional[str] = None):
        """The JAX package's specs of the bank (stacked ``[n_layers, ...]``
        when ``n_layers`` is given, its layer dim over ``pipe``): experts
        over ``expert``, ``d_ff`` over ``model``, ``wg`` and ``b_down``
        replicated."""
        lead = (pipe,) if n_layers else ()
        specs = {"wg": P(*lead, None, None),
                 "w_up": P(*lead, "expert", None, "model"),
                 "w_down": P(*lead, "expert", "model", None)}
        if self.activation == "silu_glu":
            specs["w_gate"] = P(*lead, "expert", None, "model")
        if self.use_bias:
            specs["b_up"] = P(*lead, "expert", "model")
            specs["b_down"] = P(*lead, "expert", None)
        return specs

"""Flash attention, forward and backward: the Hopper kernels, their plain
PyTorch versions, and the autograd Function that wires them together.

Ports ``deepspeed_tpu/ops/pallas/flash_attention.py``: ``_flash_forward``
(Pallas body ``_fwd_kernel``), the dq and dk/dv kernels of
``_flash_backward`` (``_dq_kernel``, ``_dkv_kernel``) and the
``flash_attention`` ``custom_vjp``. The kernels are CUDA C++ in
``deepspeed_tpu_torch/csrc/flash_attention.cu`` (see its header for the
design and what bounds them), built by ``nvcc`` at first use and called
through ``ctypes`` (:mod:`.op_builder`). The forward's bf16/fp16 work at
head_dim 64 and 128 goes to its Hopper kernel (TMA + ``wgmma``,
:func:`flash_forward_wgmma_path`), the backward's to its two
(:func:`flash_wgmma_path`); fp32 and head_dim 256 take the scalar
kernels.

Layout contract (the JAX package's, unchanged):
  q:    [b, sq, hq, d]        k, v: [b, skv, hkv, d]   (hq % hkv == 0)
  out:  [b, sq, hq, d] in q's dtype
  lse:  [b, hq, sq] fp32      (log-sum-exp of each row's scaled logits)
Causal masking aligns the queries to the END of the kv sequence (row i
sits at position i + skv - sq); ``window`` > 0 (causal only) keeps keys
k > position - window. A row that sees no key gives 0 and LSE 1e30.

The plain versions round where the kernels do: logits, dO.V^T and all
sums in fp32; P cast to V's dtype before P.V and to dO's dtype before
P^T.dO; dS cast to the input dtype before dS.K and dS^T.Q.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import op_builder

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _library() -> ctypes.CDLL:
    lib = op_builder.load("flash_attention")
    if lib.dst_flash_forward.argtypes is None:
        # b, sq, skv, hq, hkv, d, causal, window; scale, dtype, stream
        dims = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.dst_flash_forward.argtypes = [ctypes.c_void_p] * 5 + dims
        lib.dst_flash_forward_wgmma.argtypes = [ctypes.c_void_p] * 5 + dims
        lib.dst_flash_backward_dq.argtypes = [ctypes.c_void_p] * 7 + dims
        lib.dst_flash_backward_dkv.argtypes = [ctypes.c_void_p] * 8 + dims
        lib.dst_flash_backward_dq_wgmma.argtypes = [ctypes.c_void_p] * 7 + dims
        lib.dst_flash_backward_dkv_wgmma.argtypes = [ctypes.c_void_p] * 8 \
            + dims
        lib.dst_flash_wgmma_smem.argtypes = [ctypes.c_int]
        for fn in (lib.dst_flash_forward, lib.dst_flash_forward_wgmma,
                   lib.dst_flash_backward_dq,
                   lib.dst_flash_backward_dkv, lib.dst_flash_backward_dq_wgmma,
                   lib.dst_flash_backward_dkv_wgmma, lib.dst_flash_wgmma_smem):
            fn.restype = ctypes.c_int
        lib.dst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.dst_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


def _check(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [b, s, h, d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[b={b}, skv, hkv, d={d}]")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError(f"empty sequence: sq={sq}, skv={k.shape[1]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of fp32/fp16/bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if int(window) < 0 or (window > 0 and not causal):
        raise ValueError(f"window must be >= 0 and needs causal attention; "
                         f"got window={window}, causal={causal}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v must be on one device, got {q.device}, "
                         f"{k.device}, {v.device}")


def _visible(sq: int, skv: int, causal: bool, window: int, device):
    """[sq, skv] bool: which key each query row sees."""
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    vis = k_pos <= q_pos
    if window > 0:
        vis = vis & (k_pos > q_pos - window)
    return vis


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[b, s, hkv, d] -> [b, s, hkv * group, d], q-head h reading kv-head
    h // group (GQA by repeating kv heads)."""
    return x if group == 1 else torch.repeat_interleave(x, group, dim=2)


def flash_attention_forward_reference(q, k, v, *, causal: bool = True,
                                      scale: Optional[float] = None,
                                      window: int = 0
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: dense fp32 logits,
    masked with -1e30, softmax by the row max; P cast to V's dtype before
    P.V. Returns (out [b, sq, hq, d] in q's dtype, lse [b, hq, sq] fp32);
    a row that sees no key gives 0 and LSE 1e30."""
    _check(q, k, v, causal, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = repeat_kv(k, hq // hkv).float()
    vf = repeat_kv(v, hq // hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    vis = _visible(sq, skv, causal, window, q.device)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf.float())
    out = torch.where(empty, torch.zeros_like(pv), pv / l_safe)
    lse = torch.where(empty, torch.full_like(l, -NEG_INF),
                      m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _delta(out, dout) -> torch.Tensor:
    """rowsum(dO * O) in fp32, [b, hq, sq]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _backward_from_delta(q, k, v, lse, delta, dout, causal, scale, window):
    _check(q, k, v, causal, window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = repeat_kv(k, group).float()
    vf = repeat_kv(v, group).float()
    qf, dof = q.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    vis = _visible(sq, skv, causal, window, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk.reshape(b, skv, hkv, group, d).sum(3)
    dv = dv.reshape(b, skv, hkv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, dout, *,
                                       causal: bool = True,
                                       scale: Optional[float] = None,
                                       window: int = 0):
    """Plain PyTorch version of the dq and dk/dv kernels (dense flash-2
    formulas from the LSE): P = exp(S - lse), delta = rowsum(dO * O) in
    fp32, dS = P (dO.V^T - delta) scale. Returns (dq, dk, dv) in the input
    dtype; dk and dv sum over each kv-head's query heads in fp32."""
    return _backward_from_delta(q, k, v, lse, _delta(out, dout), dout,
                                causal, scale, window)


def _check_cuda(*tensors) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash attention inputs must be 16-byte aligned")


def flash_forward_wgmma_path(dtype: torch.dtype, d: int, hq: int, hkv: int,
                             addrs: Tuple[int, ...], scale: float) -> bool:
    """Whether the forward's Hopper kernel (TMA + ``wgmma``) computes
    (out, lse); else the ``mma.sync`` (bf16/fp16 at d 64/128) or scalar
    kernel does. ``addrs`` are the base addresses that TMA reads (q, k,
    v). It takes bf16/fp16 at head_dim 64 or 128 (one or two 128-byte
    swizzle atoms a row) with 16-byte aligned bases and a positive scale
    (the kernel keeps its running max over the raw scores and folds the
    scale into exp2); ``flash_attention.cu``'s ``fwd_hopper_ok`` checks the
    same and refuses the rest."""
    return (dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
            and hkv >= 1 and hq % hkv == 0 and scale > 0
            and all(a % 16 == 0 for a in addrs))


def flash_forward(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the forward. On CUDA tensors this launches the
    forward kernel on PyTorch's current stream and adds one to
    ``flash_forward.launches`` (and to ``.wgmma_launches`` when
    :func:`flash_forward_wgmma_path` picks the Hopper kernel); on CPU
    tensors it runs :func:`flash_attention_forward_reference`."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, causal=causal,
                                                 scale=scale, window=window)
    _check_cuda(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    hopper = flash_forward_wgmma_path(
        q.dtype, d, hq, hkv, tuple(t.data_ptr() for t in (q, k, v)), scale)
    fn = lib.dst_flash_forward_wgmma if hopper else lib.dst_flash_forward
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), int(window),
             float(scale), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_forward")
    flash_forward.launches += 1
    flash_forward.wgmma_launches += hopper
    return out, lse


def flash_wgmma_path(dtype: torch.dtype, d: int, hq: int, hkv: int,
                     addrs: Tuple[int, ...]) -> bool:
    """Whether the backward's Hopper kernels (TMA + ``wgmma``) compute dq
    and dk/dv; else the scalar kernels do (fp32, head_dim 256). The
    ``mma.sync`` dq and dk/dv kernels stay in the library only as a
    yardstick (``dst_flash_backward_dq`` / ``dst_flash_backward_dkv``
    called directly): no wrapper gives way to them. ``addrs`` are the base
    addresses that TMA reads (q, k, v, dout). It takes bf16/fp16 at
    head_dim 64 or 128 (a row is one or two 128-byte swizzle atoms, so
    every stride of the tensor maps is a whole 16 bytes) with 16-byte
    aligned bases; ``flash_attention.cu``'s ``hopper_ok`` checks the same
    and refuses the rest."""
    return (dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
            and hkv >= 1 and hq % hkv == 0
            and all(a % 16 == 0 for a in addrs))


def _hopper(q, k, v, dout) -> bool:
    return flash_wgmma_path(q.dtype, q.shape[-1], q.shape[2], k.shape[2],
                            tuple(t.data_ptr() for t in (q, k, v, dout)))


def _backward_args(q, k, v, dout, lse, delta, causal, scale, window):
    """Checks shared by the two backward kernels; returns the C arguments
    after the pointers."""
    _check(q, k, v, causal, window)
    b, sq, hq, d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must be like q {tuple(q.shape)} {q.dtype}; "
                         f"got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [b, hq, sq] fp32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_cuda(q, k, v, dout, lse, delta)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return (b, sq, k.shape[1], hq, k.shape[2], d, int(causal), int(window),
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_backward_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                      scale: Optional[float] = None, window: int = 0):
    """dq from the saved LSE and delta = rowsum(dO * O) ([b, hq, sq] fp32).
    On CUDA tensors this launches the dq kernel and adds one to
    ``flash_backward_dq.launches`` (and to ``.wgmma_launches`` when
    :func:`flash_wgmma_path` picks the Hopper kernel); on CPU tensors it
    runs the plain version."""
    if q.device.type == "cpu":
        return _backward_from_delta(q, k, v, lse, delta, dout, causal,
                                    scale, window)[0]
    args = _backward_args(q, k, v, dout, lse, delta, causal, scale, window)
    lib = _library()
    dq = torch.empty_like(q)
    hopper = _hopper(q, k, v, dout)
    fn = lib.dst_flash_backward_dq_wgmma if hopper \
        else lib.dst_flash_backward_dq
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
    _raise_on(lib, err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    flash_backward_dq.wgmma_launches += hopper
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                       scale: Optional[float] = None, window: int = 0):
    """(dk, dv), each kv-head summed over its query heads inside one thread
    block (no atomics: two runs give equal bits). On CUDA tensors this
    launches the dk/dv kernel and adds one to
    ``flash_backward_dkv.launches`` (and to ``.wgmma_launches`` when
    :func:`flash_wgmma_path` picks the Hopper kernel); on CPU tensors it
    runs the plain version."""
    if q.device.type == "cpu":
        return _backward_from_delta(q, k, v, lse, delta, dout, causal,
                                    scale, window)[1:]
    args = _backward_args(q, k, v, dout, lse, delta, causal, scale, window)
    lib = _library()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    hopper = _hopper(q, k, v, dout)
    fn = lib.dst_flash_backward_dkv_wgmma if hopper \
        else lib.dst_flash_backward_dkv
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *args)
    _raise_on(lib, err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    flash_backward_dkv.wgmma_launches += hopper
    return dk, dv


def flash_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                   scale: Optional[float] = None, window: int = 0):
    """(dq, dk, dv): delta = rowsum(dO * O) in fp32 with PyTorch (as the
    JAX package computes it outside its kernels), then the dq and the
    dk/dv kernels. On CPU tensors it runs
    :func:`flash_attention_backward_reference`."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, scale=scale,
            window=window)
    if out.shape != q.shape:
        raise ValueError(f"out must be like q {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}")
    delta = _delta(out, dout)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = flash_backward_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# launch counters: one per kernel, bumped only where it launches; each
# also counts its Hopper-kernel launches
flash_forward.launches = 0
flash_forward.wgmma_launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0
flash_backward_dq.wgmma_launches = 0
flash_backward_dkv.wgmma_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with its gradient: ``forward`` runs
    :func:`flash_forward` and saves (q, k, v, out, lse); ``backward`` runs
    :func:`flash_backward`. Under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass (the remat replay), and so counts
    again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                scale: Optional[float] = None, window: int = 0):
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                                 window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale,
                                    window=ctx.window)
        return dq, dk, dv, None, None, None

"""Paged attention over a paged KV pool: the Hopper kernel, its plain
PyTorch version, and the wrapper that picks between them.

Ports ``deepspeed_tpu/ops/pallas/paged_attention.py`` (``paged_attention``,
Pallas body ``_kernel``) for floating-point and quantized pools. The
kernel is CUDA C++
in ``deepspeed_tpu_torch/csrc/paged_attention.cu`` (see its header for the
design and what bounds it), built by ``nvcc`` at first use and called
through ``ctypes`` (:mod:`.op_builder`).

Layout contract (the JAX package's, unchanged):
  q:         [T, hq, hd]                one query per ragged token
  k_pool:    [n_pages, hkv, block, hd]
  v_pool:    [n_pages, hkv, block, hd]
  tables:    [T, max_pages] int32 per token, or [n_seqs, max_pages] with
             ``seq_slots`` [T] int32 naming each token's row
  positions: [T] int32                  absolute position of each token
Output:      [T, hq, hd] in q's dtype.

Quantized pools (``k_scale``/``v_scale`` fp32 [n_pages, hkv, block] and
``kv_bits`` 8 or 4, as ``ops/quantizer.py::quantize_kv`` writes them): the
pools are int8 [n_pages, hkv, block, hd], or nibble-packed uint8
[n_pages, hkv, block, hd // 2] at ``kv_bits=4``. Pages are dequantized in
the read, and q, both products and the probabilities are fp32 (the JAX
kernel's rounding for quantized pools); the output is cast to q's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import op_builder
from .quantizer import dequantize_kv

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_BLOCK = 64
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _library() -> ctypes.CDLL:
    lib = op_builder.load("paged_attention")
    fn = lib.dst_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dst_paged_attention_quant.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.dst_paged_attention_quant.restype = ctypes.c_int
        lib.dst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _walk_bound(live_pages: Optional[int], max_pages: int) -> int:
    return max_pages if live_pages is None else max(1, min(int(live_pages),
                                                           max_pages))


def _check_quant_geometry(k_pool, hd: int, kv_bits: int) -> None:
    """Fail loudly on a kv_bits/payload mismatch: an int4 nibble-packed
    pool read as int8 would dequantize to shape-valid garbage."""
    if kv_bits == 4:
        if k_pool.dtype != torch.uint8 or k_pool.shape[-1] * 2 != hd:
            raise ValueError(
                f"kv_bits=4 expects a nibble-packed uint8 pool "
                f"[..., hd//2={hd // 2}], got {k_pool.dtype} "
                f"[..., {k_pool.shape[-1]}] — pass the kv_bits the pool "
                f"was quantized with")
    elif kv_bits == 8:
        if k_pool.dtype != torch.int8 or k_pool.shape[-1] != hd:
            raise ValueError(
                f"kv_bits=8 expects an int8 pool [..., hd={hd}], got "
                f"{k_pool.dtype} [..., {k_pool.shape[-1]}] — pass the "
                f"kv_bits the pool was quantized with")
    else:
        raise ValueError(f"kv_bits must be 4 or 8 with scales, got {kv_bits}")


def _check(q, k_pool, v_pool, tables, positions, seq_slots, window,
           k_scale=None, v_scale=None, kv_bits=8) -> None:
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [T, hq, hd] and the pools [n_pages, hkv, "
                         f"block, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} differ")
    T, hq, hd = q.shape
    n_pages, hkv, block, hd_p = k_pool.shape
    quant = k_scale is not None or v_scale is not None
    if quant:
        _check_quant_geometry(k_pool, hd, kv_bits)
        hd_p = hd
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s is None or s.dtype != torch.float32 \
                    or tuple(s.shape) != (n_pages, hkv, block):
                raise ValueError(
                    f"{name} must be fp32 [{n_pages}, {hkv}, {block}] beside "
                    f"a quantized pool, got "
                    f"{None if s is None else (s.dtype, tuple(s.shape))}")
    if hd_p != hd or hkv < 1 or hq % hkv:
        raise ValueError(f"pool [.., hkv={hkv}, .., hd={hd_p}] does not fit "
                         f"q [.., hq={hq}, hd={hd}] (hq % hkv must be 0)")
    if q.dtype not in _DTYPE_CODE or (
            not quant and (k_pool.dtype != q.dtype
                           or v_pool.dtype != q.dtype)):
        raise TypeError(f"q and fp pools must share one of fp32/fp16/bf16; "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    ints = [("tables", tables), ("positions", positions)]
    if seq_slots is not None:
        ints.append(("seq_slots", seq_slots))
    for name, a in ints:
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
    if tables.dim() != 2 or positions.shape != (T,):
        raise ValueError(f"tables must be 2-D and positions [T={T}]; got "
                         f"{tuple(tables.shape)}, {tuple(positions.shape)}")
    if seq_slots is None and tables.shape[0] != T:
        raise ValueError(f"per-token tables need {T} rows, got "
                         f"{tables.shape[0]} (or pass seq_slots)")
    if seq_slots is not None and seq_slots.shape != (T,):
        raise ValueError(f"seq_slots must be [T={T}], got "
                         f"{tuple(seq_slots.shape)}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    devices = {a.device for a in (q, k_pool, v_pool, tables, positions,
                                  seq_slots, k_scale, v_scale)
               if a is not None}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def paged_attention_reference(q, k_pool, v_pool, tables, positions, *,
                              seq_slots=None, scale: Optional[float] = None,
                              live_pages: Optional[int] = None,
                              window: int = 0, k_scale=None, v_scale=None,
                              kv_bits: int = 8):
    """Plain gather-based PyTorch version of the kernel's function: every
    token's pages are gathered into a dense [T, hkv, ctx, hd] context
    (quantized pages dequantized to fp32 with their scales after the
    gather), masked (k <= pos; k > pos - window when window > 0) with
    -1e30, and reduced with an fp32 softmax. A row that sees no key gives
    0, as the kernel's ``l == 0`` guard does. Pages past ``live_pages``
    are not read (callers keep every position below ``live_pages *
    block``)."""
    T, hq, hd = q.shape
    n_pages, hkv, block, _ = k_pool.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if seq_slots is not None:
        tables = tables[seq_slots.long()]
    tables = tables[:, :_walk_bound(live_pages, tables.shape[1])]
    tables = tables.long().clamp(0, n_pages - 1)       # jnp indexing clamps
    # [T, P, hkv, block, hd] -> [T, hkv, P*block, hd]
    k_pages, v_pages = k_pool[tables], v_pool[tables]
    if k_scale is not None:
        k_pages = dequantize_kv(k_pages, k_scale[tables], bits=kv_bits)
        v_pages = dequantize_kv(v_pages, v_scale[tables], bits=kv_bits)
    keys = k_pages.permute(0, 2, 1, 3, 4).reshape(T, hkv, -1, hd)
    vals = v_pages.permute(0, 2, 1, 3, 4).reshape(T, hkv, -1, hd)
    qg = q.float().reshape(T, hkv, group, hd)
    logits = torch.einsum("tgqd,tgkd->tgqk", qg, keys.float()) * scale
    kv_pos = torch.arange(keys.shape[2], device=q.device)[None, :]
    pos = positions.long()[:, None]
    visible = kv_pos <= pos
    if window > 0:
        visible = visible & (kv_pos > pos - window)
    visible = visible[:, None, None, :]                 # [T, 1, 1, ctx]
    logits = torch.where(visible, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("tgqk,tgkd->tgqd", p, vals.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(T, hq, hd).to(q.dtype)


def paged_attention(q, k_pool, v_pool, tables, positions, *,
                    seq_slots=None, scale: Optional[float] = None,
                    live_pages: Optional[int] = None, window: int = 0,
                    k_scale=None, v_scale=None, kv_bits: int = 8):
    """Attention of T ragged tokens over a paged KV pool (see the module
    docstring for the layout). ``live_pages`` bounds the page walk
    (callers keep every position below ``live_pages * block``);
    ``window`` > 0 bands attention to the trailing ``window`` positions.

    ``k_scale``/``v_scale`` with ``kv_bits`` switch to quantized pools
    (module docstring).

    On CUDA tensors this launches the hand-written kernel on PyTorch's
    current stream and adds one to ``paged_attention.launches`` (fp
    pools), ``paged_attention.int8_launches`` or
    ``paged_attention.int4_launches``; it takes head_dim in (64, 128,
    256), a power-of-two page size up to 64 and contiguous inputs, and
    raises on anything else. On CPU tensors it runs
    :func:`paged_attention_reference`."""
    _check(q, k_pool, v_pool, tables, positions, seq_slots, window,
           k_scale, v_scale, kv_bits)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, tables, positions, seq_slots=seq_slots,
            scale=scale, live_pages=live_pages, window=window,
            k_scale=k_scale, v_scale=v_scale, kv_bits=kv_bits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    T, hq, hd = q.shape
    n_pages, hkv, block, _ = k_pool.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if block > MAX_BLOCK or block & (block - 1):
        raise ValueError(f"the CUDA kernel takes a power-of-two page size "
                         f"up to {MAX_BLOCK}, got {block}")
    args = [a for a in (q, k_pool, v_pool, tables, positions, seq_slots,
                        k_scale, v_scale) if a is not None]
    if not all(a.is_contiguous() for a in args):
        raise ValueError("paged_attention needs contiguous inputs")
    if any(a.data_ptr() % 16 for a in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    lib = _library()
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    slots_ptr = seq_slots.data_ptr() if seq_slots is not None else None
    geometry = (T, hq, hkv, hd, n_pages, block, tables.shape[1],
                _walk_bound(live_pages, tables.shape[1]), int(window),
                float(scale), _DTYPE_CODE[q.dtype])
    if k_scale is None:
        err = lib.dst_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), slots_ptr, positions.data_ptr(),
            out.data_ptr(), *geometry, stream)
    else:
        err = lib.dst_paged_attention_quant(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
            slots_ptr, positions.data_ptr(), out.data_ptr(), *geometry,
            int(kv_bits), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{lib.dst_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    if k_scale is None:
        paged_attention.launches += 1
    elif kv_bits == 8:
        paged_attention.int8_launches += 1
    else:
        paged_attention.int4_launches += 1
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.int4_launches = 0

"""Fused matmul kernels of the compressed collectives: the Hopper kernels,
their plain PyTorch versions, and the wrappers that pick between them.

Ports ``deepspeed_tpu/ops/pallas/fused_collectives.py``:

* :func:`dequant_matmul` — ``h [m, k] @ dequant(payload, scales) [k, b]``,
  the consumer side of the fused ring all-gather (qwZ on);
* :func:`matmul_pallas` — ``a [m, k] @ b [k, n]``, its dense twin (qwZ off).
  The name is the JAX function's, so a reader finds the counterpart; here
  it launches a CUDA kernel, not a Pallas one;
* :func:`matmul_quantize` — ``a @ b`` or ``a.T @ b`` (``trans_a``) with the
  blockwise quantization of the product (and the int4 pack) in the
  epilogue, the producer side of the fused reduce-scatter (qgZ on).

The kernels are CUDA C++ in ``deepspeed_tpu_torch/csrc/fused_collectives.cu``
(see its header for the design, the rounding contract and what bounds
them), built by ``nvcc`` at first use and called through ``ctypes``
(:mod:`.op_builder`). On CUDA tensors each wrapper launches its kernel on
PyTorch's current stream, adds one to its ``.launches`` and raises on what
the kernel does not take; on CPU tensors it runs the plain version.

Each wrapper has two kernels: the Hopper one (TMA loads into a ring of
shared memory, ``wgmma``; converter warps for the dequantize; for
``matmul_quantize`` the quantize in the consumers' registers) for the
bf16/fp16 products that :func:`wgmma_path` (:func:`wgmma_quantize_path`
for ``matmul_quantize``) accepts, and the ``mma.sync`` / fp32 FMA tile
loop for the rest. The predicate alone picks; each wrapper counts the
Hopper launches in ``.wgmma_launches`` beside ``.launches``, and a Hopper
kernel that fails raises like any other: nothing gives way to the other
kernel.

Layouts follow the facade's wire format: ``payload`` is the flat int8
``[k*b]`` (uint8 ``[k*b/2]`` nibble-packed for int4, ``pack_int4``'s
layout: two's complement, element 2i low) whose row-major reshape is the
weight tile; ``scales`` is the flat fp32 ``[k*b/block]`` vector (the JAX
kernels' ``[rows, 128]`` lane replication is a Mosaic layout and is not
carried over). Products accumulate in fp32 over the full contraction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import op_builder
from .quant import quantize_blockwise_reference
from .quantizer import pack_int4, unpack_int4

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _library(defines=None) -> ctypes.CDLL:
    """The kernels' library; ``defines`` builds a scratch variant (see
    ``DST_FC_CONVERTER`` in the source)."""
    lib = op_builder.load("fused_collectives", defines)
    if lib.dst_fc_matmul.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dst_fc_matmul.argtypes = [vp, vp, vp] + [i] * 5 + [vp]
        lib.dst_fc_dequant_matmul.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.dst_fc_matmul_quantize.argtypes = [vp] * 5 + [i] * 7 + [vp]
        lib.dst_fc_matmul_wgmma.argtypes = lib.dst_fc_matmul.argtypes
        lib.dst_fc_dequant_matmul_wgmma.argtypes = \
            lib.dst_fc_dequant_matmul.argtypes
        lib.dst_fc_matmul_quantize_wgmma.argtypes = [vp] * 4 + [i] * 7 + [vp]
        for fn in (lib.dst_fc_matmul, lib.dst_fc_dequant_matmul,
                   lib.dst_fc_matmul_quantize, lib.dst_fc_matmul_wgmma,
                   lib.dst_fc_dequant_matmul_wgmma,
                   lib.dst_fc_matmul_quantize_wgmma):
            fn.restype = ctypes.c_int
        lib.dst_fc_wgmma_smem.argtypes = [i]
        lib.dst_fc_wgmma_smem.restype = ctypes.c_int
        lib.dst_fc_error_string.argtypes = [ctypes.c_int]
        lib.dst_fc_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.dst_fc_error_string(err).decode()} "
                           f"(cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_operand(t: torch.Tensor, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dtype(t: torch.Tensor, name: str) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be fp32/fp16/bf16, got {t.dtype}")


def _out(m: int, n: int, device, out: Optional[torch.Tensor]) -> torch.Tensor:
    """The fp32 [m, n] output, or ``out``: a fp32 [m, n] view whose rows
    are contiguous (a column slice of a wider matrix)."""
    if out is None:
        return torch.empty((m, n), dtype=torch.float32, device=device)
    if (out.dtype != torch.float32 or tuple(out.shape) != (m, n)
            or out.device != device or out.stride(1) != 1):
        raise ValueError(f"out must be an fp32 [{m}, {n}] view with "
                         f"contiguous rows on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} strides {out.stride()}")
    return out


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the operands cast to fp32: exact products, one fp32
    accumulation (TF32 is the caller's setting to keep off)."""
    return torch.matmul(a.float(), b.float())


def _finish(y: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version's product, written into ``out`` when given."""
    if out is None:
        return y
    _out(*y.shape, y.device, out).copy_(y)
    return out


# ----------------------------------------------------------------------
# plain versions

def dequant_matmul_reference(h: torch.Tensor, payload: torch.Tensor,
                             scales: torch.Tensor, *, bits: int, block: int,
                             b: int, w_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`dequant_matmul`: unpack, ``float(q) *
    scale`` cast to ``w_dtype``, then the fp32 matmul."""
    m, k = h.shape
    q = unpack_int4(payload) if bits == 4 else payload.reshape(-1)
    rows = k * b // block
    w = (q.reshape(rows, block).float() * scales.reshape(rows, 1)) \
        .reshape(k, b).to(w_dtype)
    return _matmul_fp32(h, w)


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`matmul_pallas`."""
    return _matmul_fp32(a, b)


def matmul_quantize_reference(a: torch.Tensor, b: torch.Tensor, *,
                              bits: int, block: int, trans_a: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`matmul_quantize`: the fp32 product, then
    ``quantize_blockwise`` (IEEE division) and ``pack_int4`` for int4."""
    t = _matmul_fp32(a.t() if trans_a else a, b)
    q, s = quantize_blockwise_reference(t, bits, block)
    return (pack_int4(q) if bits == 4 else q.reshape(-1)), s


# ----------------------------------------------------------------------
# wrappers

# int8 / int4 payload rows must be whole 16-byte TMA strides: n bytes, n/2
_PAYLOAD_N_MULTIPLE = {8: 16, 4: 32}


def wgmma_path(dtype: torch.dtype, m: int, n: int, k: int,
               addrs: Tuple[int, ...], *, bits: Optional[int] = None,
               block: Optional[int] = None) -> bool:
    """Whether the Hopper kernel (TMA + ``wgmma``) computes the product
    ``[m, k] @ [k, n]``; else the ``mma.sync`` / fp32 FMA kernels do.
    ``addrs`` are the base addresses of the operands that TMA reads (``a``
    and ``b``; ``h`` and the payload). ``bits`` (8 or 4) and ``block``
    describe a quantized weight (:func:`dequant_matmul`); ``None`` a dense
    one. It takes bf16/fp16 operands whose bases are 16-byte aligned and
    whose rows are whole 16-byte strides (``k % 8 == 0``, ``n % 8 == 0``;
    for the payload ``n % 16 == 0`` (int8) or ``n % 32 == 0`` (int4)), a
    block of whole 8-element pieces (``block % 8 == 0``) and a flat weight
    index below 2^31. ``fused_collectives.cu``'s ``wgmma_ok`` checks the
    same and refuses the rest."""
    if dtype not in (torch.bfloat16, torch.float16) or min(m, n, k) < 1:
        return False
    if k % 8 or n % 8 or any(p % 16 for p in addrs):
        return False
    if bits is None:
        return True
    return (block % 8 == 0 and n % _PAYLOAD_N_MULTIPLE[bits] == 0
            and k * n < 2 ** 31)


# row 9's output tile is 256 columns wide: a quantization block must tile
# it; and its n tiles must fit the grid's 65535
_QUANT_TILE_N = 256
_MAX_N_TILES = 65535


def wgmma_quantize_path(dtype: torch.dtype, rows: int, n: int, k: int,
                        trans_a: bool, addrs: Tuple[int, ...], *,
                        block: int) -> bool:
    """Whether the Hopper kernel (TMA + ``wgmma``, the quantize in the
    consumers' registers) computes :func:`matmul_quantize` of ``A [rows,
    k] @ b [k, n]``, ``A = a`` or, with ``trans_a``, ``a.T`` read from the
    ``[k, rows]`` array as it lies; else the ``mma.sync`` / fp32 FMA
    kernels do. ``addrs`` are the base addresses of ``a`` and ``b``. It
    takes bf16/fp16 operands whose bases are 16-byte aligned and whose rows
    are whole 16-byte strides (``k % 8 == 0``, or ``rows % 8 == 0`` with
    ``trans_a``; ``n % 8 == 0``), and a block that tiles the kernel's
    256-wide output tile and the product's rows (``block % 8 == 0``,
    ``256 % block == 0``, ``n % block == 0``). ``fused_collectives.cu``'s
    ``wgmma_quantize_ok`` checks the same and refuses the rest."""
    if dtype not in (torch.bfloat16, torch.float16) or min(rows, n, k) < 1:
        return False
    if (rows if trans_a else k) % 8 or n % 8 or any(p % 16 for p in addrs):
        return False
    return (block >= 8 and block % 8 == 0 and _QUANT_TILE_N % block == 0
            and n % block == 0
            and -(-n // _QUANT_TILE_N) <= _MAX_N_TILES)


def dequant_matmul(h: torch.Tensor, payload: torch.Tensor,
                   scales: torch.Tensor, *, bits: int, block: int, b: int,
                   w_dtype=torch.float32,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h [m, k] @ dequant(payload, scales) [k, b] -> fp32 [m, b]`` with the
    dequantize (int4 unpack, blockwise scale, cast to ``w_dtype``) in the
    matmul's prologue. ``out`` (fp32 ``[m, b]``, rows contiguous) receives
    the product in place, e.g. a column slice of the gathered output. The
    kernel takes ``w_dtype == h.dtype`` (fp32, fp16 or bf16)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    m, k = h.shape
    if (k * b) % block or block % 2:
        raise ValueError(f"k*b = {k * b} must be a multiple of the even "
                         f"block {block}")
    if h.device.type == "cpu":
        return _finish(dequant_matmul_reference(
            h, payload, scales, bits=bits, block=block, b=b,
            w_dtype=w_dtype), out)
    _check_operand(h, "h", h.device)
    _check_operand(payload, "payload", h.device)
    _check_operand(scales, "scales", h.device)
    _check_dtype(h, "h")
    if w_dtype != h.dtype:
        raise TypeError(f"the kernel dequantizes to h's dtype {h.dtype}, "
                        f"got w_dtype {w_dtype}")
    want = (torch.uint8, k * b // 2) if bits == 4 else (torch.int8, k * b)
    if (payload.dtype, payload.numel()) != want:
        raise ValueError(f"payload must be {want[0]} with {want[1]} "
                         f"elements, got {payload.dtype} {payload.numel()}")
    if scales.dtype != torch.float32 or scales.numel() != k * b // block:
        raise ValueError(f"scales must be fp32 [{k * b // block}]")
    lib = _library()
    y = _out(m, b, h.device, out)
    hopper = wgmma_path(h.dtype, m, b, k, (h.data_ptr(), payload.data_ptr()),
                        bits=bits, block=block)
    fn = lib.dst_fc_dequant_matmul_wgmma if hopper \
        else lib.dst_fc_dequant_matmul
    _raise_on(lib, "dequant_matmul", fn(
        h.data_ptr(), payload.data_ptr(), scales.data_ptr(), y.data_ptr(),
        m, b, k, y.stride(0), bits, block, _DTYPE_CODE[h.dtype], _stream(h)))
    dequant_matmul.launches += 1
    dequant_matmul.wgmma_launches += hopper
    return y


def matmul_pallas(a: torch.Tensor, b: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a [m, k] @ b [k, n] -> fp32 [m, n]``, fp32 accumulation over the whole
    contraction. ``out`` as in :func:`dequant_matmul`. The kernel takes
    ``a`` and ``b`` of one dtype (fp32, fp16 or bf16)."""
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}")
    n = b.shape[1]
    if a.device.type == "cpu":
        return _finish(matmul_reference(a, b), out)
    _check_operand(a, "a", a.device)
    _check_operand(b, "b", a.device)
    _check_dtype(a, "a")
    if b.dtype != a.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and "
                        f"{b.dtype}")
    lib = _library()
    y = _out(m, n, a.device, out)
    hopper = wgmma_path(a.dtype, m, n, k, (a.data_ptr(), b.data_ptr()))
    fn = lib.dst_fc_matmul_wgmma if hopper else lib.dst_fc_matmul
    _raise_on(lib, "matmul_pallas", fn(
        a.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, y.stride(0),
        _DTYPE_CODE[a.dtype], _stream(a)))
    matmul_pallas.launches += 1
    matmul_pallas.wgmma_launches += hopper
    return y


def matmul_quantize(a: torch.Tensor, b: torch.Tensor, *, bits: int,
                    block: int, trans_a: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The product ``a.T @ b`` (``trans_a``: ``a [m, K]`` contracted over
    m, the weight-gradient shape) or ``a @ b``, blockwise-quantized in the
    epilogue: ``(payload, scales)`` with payload the flat int8
    ``[rows*block]`` (uint8 ``[rows*block/2]`` packed for int4) and scales
    fp32 ``[rows]``, rows = product size / block, ready for
    ``comm.compressed.quantized_chunk_exchange``. :func:`wgmma_quantize_path`
    picks the kernel."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    kc, out_rows = a.shape if trans_a else a.shape[::-1]
    if b.shape[0] != kc:
        raise ValueError(f"{'a.T' if trans_a else 'a'} of {tuple(a.shape)} "
                         f"@ b {tuple(b.shape)}")
    n = b.shape[1]
    numel = out_rows * n
    if numel % block or block % 2:
        raise ValueError(f"product size {numel} must be a multiple of the "
                         f"even block {block}")
    if a.device.type == "cpu":
        return matmul_quantize_reference(a, b, bits=bits, block=block,
                                         trans_a=trans_a)
    _check_operand(a, "a", a.device)
    _check_operand(b, "b", a.device)
    _check_dtype(a, "a")
    if b.dtype != a.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype} and "
                        f"{b.dtype}")
    lib = _library()
    rows = numel // block
    payload = torch.empty(numel // 2 if bits == 4 else numel,
                          dtype=torch.uint8 if bits == 4 else torch.int8,
                          device=a.device)
    scales = torch.empty(rows, dtype=torch.float32, device=a.device)
    hopper = wgmma_quantize_path(a.dtype, out_rows, n, kc, trans_a,
                                 (a.data_ptr(), b.data_ptr()), block=block)
    if hopper:
        err = lib.dst_fc_matmul_quantize_wgmma(
            a.data_ptr(), b.data_ptr(), payload.data_ptr(),
            scales.data_ptr(), out_rows, n, kc, int(trans_a), bits, block,
            _DTYPE_CODE[a.dtype], _stream(a))
    else:
        one_pass = 256 % block == 0 and n % block == 0
        scratch = None if one_pass else torch.empty(
            (out_rows, n), dtype=torch.float32, device=a.device)
        err = lib.dst_fc_matmul_quantize(
            a.data_ptr(), b.data_ptr(), payload.data_ptr(),
            scales.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), out_rows, n, kc,
            int(trans_a), bits, block, _DTYPE_CODE[a.dtype], _stream(a))
    _raise_on(lib, "matmul_quantize", err)
    matmul_quantize.launches += 1
    matmul_quantize.wgmma_launches += hopper
    return payload, scales


dequant_matmul.launches = 0
dequant_matmul.wgmma_launches = 0
matmul_pallas.launches = 0
matmul_pallas.wgmma_launches = 0
matmul_quantize.launches = 0
matmul_quantize.wgmma_launches = 0

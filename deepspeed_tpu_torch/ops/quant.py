"""Blockwise symmetric quantize / dequantize: the Hopper kernels, their
plain PyTorch versions, and the wrappers that pick between them.

Ports ``deepspeed_tpu/ops/pallas/quant.py`` (``quantize_blockwise_pallas``,
``dequantize_blockwise_pallas``). The kernels are CUDA C++ in
``deepspeed_tpu_torch/csrc/quant.cu`` (see its header for the design and
what bounds them), built by ``nvcc`` at first use and called through
``ctypes`` (:mod:`.op_builder`).

Layout: ``x`` of any shape is viewed flat as ``[rows, block]``; its size
must be a multiple of ``block``. The scale is fp32 ``[rows]``: absmax / qmax
with qmax = 2^(bits-1) - 1, 1 where the absmax is 0. ``q`` is int8 with
``x``'s shape, values in [-qmax-1, qmax]; with ``pack`` (int4 only) it is
the v1 inference engine's weight layout instead: uint8 ``[numel // 2]``,
byte k = (q[2k] + 8) | (q[2k+1] + 8) << 4, offset binary
(``deepspeed_tpu/inference/engine.py`` ``_quantize_tree``).

The JAX dispatch guard ``use_pallas_quant`` is not ported: its rules (a
TPU, one device, a lane-multiple block, a row count that is a multiple of
32, the ``DST_NO_PALLAS_QUANT`` lever) are Mosaic's and the TPU mesh's. The
CUDA kernels take any even block up to 4096 and any row count.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import op_builder

MAX_BLOCK = 4096
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _library() -> ctypes.CDLL:
    lib = op_builder.load("quant")
    if lib.dst_quantize_blockwise.argtypes is None:
        lib.dst_quantize_blockwise.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.dst_quantize_blockwise.restype = ctypes.c_int
        lib.dst_dequantize_blockwise.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.dst_dequantize_blockwise.restype = ctypes.c_int
        lib.dst_quant_error_string.argtypes = [ctypes.c_int]
        lib.dst_quant_error_string.restype = ctypes.c_char_p
    return lib


def _rows(numel: int, block: int) -> int:
    if block < 1 or numel % block:
        raise ValueError(f"size {numel} not divisible by block {block}")
    return numel // block


def _check_pack(bits: int, block: int, pack: bool) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if pack and (bits != 4 or block % 2):
        raise ValueError(f"packing needs bits=4 and an even block, got "
                         f"bits={bits}, block={block}")


def pack_int4_offset(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int8 in [-8, 7], even numel) -> uint8 ``[numel // 2]``,
    offset binary, element 2k in the low nibble."""
    q4 = (q.reshape(-1, 2).to(torch.int32) + 8)
    return (q4[:, 0] | (q4[:, 1] << 4)).to(torch.uint8)


def unpack_int4_offset(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_offset`: uint8 [n] -> int8 [2n]."""
    p = packed.reshape(-1).to(torch.int32)
    return torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=-1) \
        .reshape(-1).to(torch.int8)


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE fp32 division on every device.
    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    fp32 reciprocal instead, which can differ by one ulp; dividing by a
    0-dim tensor on ``x``'s device does the true division, as the kernels
    and the CPU do. The divisor is filled on the device (``torch.full``),
    not copied from the host, so the call does not synchronise."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# block rows a pass of the plain quantizer takes on the host: each pass's
# fp32 temporaries stay small and are reused, where a whole leaf's would
# be fresh memory the host must fault in (each row's result is the same);
# on a device one pass takes every row
_HOST_ROWS = 1 << 14


def _row_chunks(t: torch.Tensor, rows: int) -> List[slice]:
    step = _HOST_ROWS if t.device.type == "cpu" else rows
    return [slice(i, i + step) for i in range(0, rows, step)]


def _quantize_rows(blocks: torch.Tensor, qmax: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = ieee_div(blocks.abs().amax(dim=1, keepdim=True), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -qmax - 1, qmax) \
        .to(torch.int8)
    return q, scale[:, 0]


def quantize_blockwise_reference(x: torch.Tensor, bits: int = 8,
                                 block: int = 256, pack: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the quantize kernel: ``(q, scale)``."""
    _check_pack(bits, block, pack)
    rows = _rows(x.numel(), block)
    qmax = 2.0 ** (bits - 1) - 1
    flat = x.reshape(rows, block)
    parts = [_quantize_rows(flat[c].float(), qmax)
             for c in _row_chunks(x, rows)]
    q, scale = parts[0] if len(parts) == 1 else (
        torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    q = pack_int4_offset(q) if pack else q.reshape(x.shape)
    return q, scale


def dequantize_blockwise_reference(q: torch.Tensor, scale: torch.Tensor,
                                   block: int = 256,
                                   dtype: torch.dtype = torch.float32,
                                   packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the dequantize kernel: ``float(q) *
    scale[row]`` cast to ``dtype``, shaped like ``q`` (flat ``[2 *
    q.numel()]`` when ``packed``)."""
    vals = unpack_int4_offset(q) if packed else q
    rows = _rows(vals.numel(), block)
    out = vals.reshape(rows, block).float() * scale.reshape(rows, 1)
    return out.reshape(vals.shape).to(dtype)


def _launch_error(lib, what: str, err: int) -> RuntimeError:
    return RuntimeError(f"{what} kernel launch failed: "
                        f"{lib.dst_quant_error_string(err).decode()} "
                        f"(cudaError {err})")


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")


def quantize_blockwise(x: torch.Tensor, bits: int = 8, block: int = 256,
                       pack: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric blockwise quantization: ``(q, scale)`` (layout in the
    module docstring).

    On CUDA tensors this launches the hand-written kernel on PyTorch's
    current stream and adds one to ``quantize_blockwise.launches``; it
    takes fp32/fp16/bf16, an even block up to 4096 and a contiguous input,
    and raises on anything else. On CPU tensors it runs
    :func:`quantize_blockwise_reference`."""
    if x.device.type == "cpu":
        return quantize_blockwise_reference(x, bits, block, pack)
    _check_cuda(x, "quantize_blockwise")
    _check_pack(bits, block, pack)
    rows = _rows(x.numel(), block)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_blockwise takes fp32/fp16/bf16, got "
                        f"{x.dtype}")
    if block % 2 or block > MAX_BLOCK:
        raise ValueError(f"the CUDA kernel takes an even block up to "
                         f"{MAX_BLOCK}, got {block}")
    lib = _library()
    q = torch.empty((x.numel() // 2,) if pack else x.shape,
                    dtype=torch.uint8 if pack else torch.int8,
                    device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    err = lib.dst_quantize_blockwise(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, block, bits,
        int(pack), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise _launch_error(lib, "quantize_blockwise", err)
    quantize_blockwise.launches += 1
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         block: int = 256,
                         dtype: torch.dtype = torch.float32,
                         packed: bool = False) -> torch.Tensor:
    """``float(q) * scale[row]`` in ``dtype``, shaped like ``q`` (flat
    ``[2 * q.numel()]`` when ``packed``).

    On CUDA tensors this launches the hand-written kernel and adds one to
    ``dequantize_blockwise.launches``; it raises on what the kernel does
    not take. On CPU tensors it runs
    :func:`dequantize_blockwise_reference`."""
    if q.device.type == "cpu":
        return dequantize_blockwise_reference(q, scale, block, dtype, packed)
    _check_cuda(q, "dequantize_blockwise")
    if q.dtype != (torch.uint8 if packed else torch.int8):
        raise TypeError(f"dequantize_blockwise takes an "
                        f"{'uint8 (packed)' if packed else 'int8'} payload, "
                        f"got {q.dtype}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_blockwise writes fp32/fp16/bf16, got "
                        f"{dtype}")
    numel = q.numel() * (2 if packed else 1)
    rows = _rows(numel, block)
    if block % 2 or block > MAX_BLOCK:
        raise ValueError(f"the CUDA kernel takes an even block up to "
                         f"{MAX_BLOCK}, got {block}")
    if scale.shape != (rows,) or scale.dtype != torch.float32 \
            or scale.device != q.device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous fp32 [{rows}] on "
                         f"{q.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    lib = _library()
    out = torch.empty((numel,) if packed else q.shape, dtype=dtype,
                      device=q.device)
    err = lib.dst_dequantize_blockwise(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, block,
        int(packed), _DTYPE_CODE[dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _launch_error(lib, "dequantize_blockwise", err)
    dequantize_blockwise.launches += 1
    return out


quantize_blockwise.launches = 0
dequantize_blockwise.launches = 0

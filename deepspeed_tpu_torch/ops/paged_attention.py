"""Paged attention over a paged KV pool: the Hopper kernels, their plain
PyTorch version, the work list that splits a call between the kernels,
and the wrapper.

Ports ``deepspeed_tpu/ops/pallas/paged_attention.py`` (``paged_attention``,
Pallas body ``_kernel``) for floating-point and quantized pools. The
kernels are CUDA C++ in ``deepspeed_tpu_torch/csrc/paged_attention.cu``
(see its header for the design and what bounds them), built by ``nvcc``
at first use and called through ``ctypes`` (:mod:`.op_builder`).

Layout contract (the JAX package's, unchanged):
  q:         [T, hq, hd]                one query per ragged token
  k_pool:    [n_pages, hkv, block, hd]
  v_pool:    [n_pages, hkv, block, hd]
  tables:    [T, max_pages] int32 per token, or [n_seqs, max_pages] with
             ``seq_slots`` [T] int32 naming each token's row
  positions: [T] int32                  absolute position of each token
Output:      [T, hq, hd] in q's dtype.

On fp pools the probabilities are rounded to V's dtype before P.V (the
TPU kernel's rounding point, ``paged_attention.py:123``). Quantized pools
(``k_scale``/``v_scale`` fp32 [n_pages, hkv, block] and ``kv_bits`` 8 or
4, as ``ops/quantizer.py::quantize_kv`` writes them): the pools are int8
[n_pages, hkv, block, hd], or nibble-packed uint8 [n_pages, hkv, block,
hd // 2] at ``kv_bits=4``. Pages are dequantized in the read, and q, both
products and the probabilities are fp32 (the JAX kernel's rounding for
quantized pools); the output is cast to q's dtype.

On the card a call runs a work list (:func:`plan_paged_work`): runs of at
least ``MIN_TILE_RUN`` consecutive lanes of one sequence (prefill chunks)
become tile items of up to 64 lanes where :func:`paged_tile_path` takes
the pool (TMA + wgmma, a page read once per tile); every other lane
becomes lane items, split over spans of pages so that a call fills the
card, whose partials a combine pass merges in a fixed order.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import op_builder
from .quantizer import dequantize_kv

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
MAX_BLOCK = 64
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
TILE_LANES = 64        # rows of a tile item: one consumer warpgroup's
MIN_TILE_RUN = 16      # shorter runs of one sequence take lane items
SPLIT_BLOCKS = 1056    # lane-item blocks a call aims at: 8 on each of 132 SMs


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
        # q, pools, tables, slots, positions, tiles; n_tiles, out; 11 ints
        # of geometry; scale, dtype, stream
        lib.dst_paged_attention_tiles.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])
        lib.dst_paged_attention_tiles.restype = ctypes.c_int
        # q, pools, scales, tables, slots, positions, items; n_items;
        # lanes; n_lanes; part, part_ml, out; geometry; scale, dtype,
        # kv_bits, stream
        lib.dst_paged_attention_split.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.dst_paged_attention_split.restype = ctypes.c_int
        lib.dst_paged_tile_smem.argtypes = [ctypes.c_int]
        lib.dst_paged_tile_smem.restype = ctypes.c_int
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
    -1e30, and reduced with an fp32 softmax; on fp pools P is rounded to
    the pool's dtype before P.V (quantized pools keep it fp32). A row that
    sees no key gives 0, as the kernel's ``l == 0`` guard does. Pages past
    ``live_pages`` are not read (callers keep every position below
    ``live_pages * block``)."""
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
    if k_scale is None:          # fp pools: P in V's dtype before P.V
        p = p.to(v_pool.dtype).float()
    out = torch.einsum("tgqk,tgkd->tgqd", p, vals.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(T, hq, hd).to(q.dtype)


def paged_tile_path(dtype: torch.dtype, hd: int, block: int,
                    quantized: bool) -> bool:
    """Whether tile items (TMA + wgmma) take the prefill runs of a call:
    bf16/fp16 fp pools at head_dim 64 or 128 (one or two 128-byte swizzle
    atoms a row) with pages of 8-64 rows (each page's box lands on a whole
    swizzle pattern); calls with ``seq_slots`` only. ``paged_attention.cu``
    checks the same and refuses the rest; every other lane takes lane
    items."""
    return (not quantized and dtype in (torch.bfloat16, torch.float16)
            and hd in (64, 128) and block in (8, 16, 32, 64))


def paged_work_arrays(seq_slots: Optional[np.ndarray], T: int, walk: int,
                      hkv: int, tiles: bool, pad: Optional[np.ndarray] = None):
    """The work list of a call, as numpy int32 arrays (tiles [n, 2]: first
    lane and lanes; items [n, 3]: lane, first page, end page; lanes [n,
    3]: lane, first item, items). With ``tiles``, each run of at least
    ``MIN_TILE_RUN`` consecutive lanes on one ``seq_slots`` row is cut
    into tile items of up to ``TILE_LANES``; the other lanes (all of them
    without ``tiles`` or ``seq_slots``) become lane items that split the
    page walk [0, ``walk``) into near-equal spans, as many as bring those
    lanes x ``hkv`` kv-heads to ``SPLIT_BLOCKS`` blocks. A span past a
    lane's own walk is empty in the kernel. Lanes that ``pad`` marks (an
    engine's padding lanes, at position 0) take one lane item over the
    whole walk each and count for neither tiles nor splits."""
    pad = np.zeros(T, bool) if pad is None else np.asarray(pad, bool)
    tile_rows, lane_ids = [], []
    if tiles and seq_slots is not None and T:
        # a padding lane breaks a run: it never joins a tile
        slots = np.where(pad, -1, np.asarray(seq_slots).reshape(-1))
        cuts = np.flatnonzero(np.diff(slots)) + 1
        for lo, hi in zip([0, *cuts.tolist()], [*cuts.tolist(), T]):
            if hi - lo >= MIN_TILE_RUN and not pad[lo]:
                tile_rows += [(t0, min(TILE_LANES, hi - t0))
                              for t0 in range(lo, hi, TILE_LANES)]
            else:
                lane_ids += range(lo, hi)
    else:
        lane_ids = list(range(T))
    real = sum(not pad[t] for t in lane_ids)
    splits = min(walk, max(1, -(-SPLIT_BLOCKS // max(1, real * hkv))))
    cuts = [k * walk // splits for k in range(splits + 1)]
    spans = list(zip(cuts[:-1], cuts[1:]))
    items, lanes = [], []
    for t in lane_ids:
        lanes.append((t, len(items), 1 if pad[t] else len(spans)))
        items += [(t, 0, walk)] if pad[t] else [(t, p0, p1)
                                               for p0, p1 in spans]

    def arr(rows, width):
        return np.asarray(rows, np.int32).reshape(-1, width)
    return arr(tile_rows, 2), arr(items, 3), arr(lanes, 3)


def _takes_tiles(has_slots: bool, dtype: torch.dtype, k_pool,
                 quantized: bool, scale: Optional[float]) -> bool:
    """Whether a call may run tile items: it names each lane's table row
    (``seq_slots``), its scale is positive (the tile kernel folds it into
    exp2; lane items take any scale) and :func:`paged_tile_path` takes its
    pool. The one place that decides it, for the planner and the
    wrapper."""
    _, _, block, hd = k_pool.shape
    return (has_slots and (scale is None or scale > 0)
            and paged_tile_path(dtype, hd, block, quantized))


@dataclass(frozen=True)
class PagedWork:
    """A call's work list on the device (``plan``: the tiles, items and
    lanes of :func:`paged_work_arrays`, back to back, int32), how many of
    its lanes are padding, and the call geometry it was built for
    (:func:`check_paged_work`)."""
    plan: torch.Tensor
    n_tiles: int
    n_items: int
    n_lanes: int
    T: int
    walk: int
    hkv: int
    n_pad: int = 0


def plan_paged_work(seq_slots: Optional[np.ndarray], T: int, walk: int,
                    k_pool, *, dtype: torch.dtype, quantized: bool = False,
                    scale: Optional[float] = None,
                    pad: Optional[np.ndarray] = None) -> PagedWork:
    """The work list of :func:`paged_work_arrays` for a call with q of
    ``dtype`` over ``k_pool`` (``quantized`` with scales), copied to the
    pool's device once; prefill runs take tile items where
    :func:`_takes_tiles` allows. ``walk`` is the page-walk bound
    min(live_pages, max_pages); the ragged engine builds one per put from
    the host's slot array (its padding lanes as ``pad``) and shares it
    between its layers."""
    tiles = _takes_tiles(seq_slots is not None, dtype, k_pool, quantized,
                         scale)
    t, i, l = paged_work_arrays(seq_slots, T, walk, k_pool.shape[1], tiles,
                                pad)
    flat = np.concatenate([t.ravel(), i.ravel(), l.ravel()]).astype(np.int32)
    plan = torch.from_numpy(flat).to(k_pool.device)
    n_pad = 0 if pad is None else int(np.count_nonzero(pad))
    return PagedWork(plan, len(t), len(i), len(l), T, walk,
                     k_pool.shape[1], n_pad)


def check_paged_work(work: PagedWork, T: int, walk: int, hkv: int,
                     tiles: bool) -> None:
    """Raises unless ``work`` fits a call of T lanes, page walk ``walk``
    and ``hkv`` kv-heads that may run tile items where ``tiles``
    (:func:`_takes_tiles`): a list without tile items fits any such
    call."""
    if (work.T, work.walk, work.hkv) != (T, walk, hkv):
        raise ValueError(f"work list for (T, walk, hkv) = "
                         f"{(work.T, work.walk, work.hkv)}, call has "
                         f"{(T, walk, hkv)}")
    if work.n_tiles and not tiles:
        raise ValueError(f"work list has {work.n_tiles} tile items, but "
                         f"this call takes none (paged_tile_path)")


def paged_attention(q, k_pool, v_pool, tables, positions, *,
                    seq_slots=None, scale: Optional[float] = None,
                    live_pages: Optional[int] = None, window: int = 0,
                    k_scale=None, v_scale=None, kv_bits: int = 8,
                    work: Optional[PagedWork] = None):
    """Attention of T ragged tokens over a paged KV pool (see the module
    docstring for the layout). ``live_pages`` bounds the page walk
    (callers keep every position below ``live_pages * block``);
    ``window`` > 0 bands attention to the trailing ``window`` positions.

    ``k_scale``/``v_scale`` with ``kv_bits`` switch to quantized pools
    (module docstring).

    On CUDA tensors this runs the work list ``work`` (or one planned here
    from ``seq_slots``, which costs a copy to the host): tile items on
    the tile kernel, then lane items on the split-K kernel and its
    combine pass, on PyTorch's current stream. It adds one to
    ``paged_attention.launches`` (fp pools), ``.int8_launches`` or
    ``.int4_launches`` a call, and to ``.tile_launches`` / ``.split_launches``
    when the call ran tile / lane items. It takes head_dim in (64, 128,
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
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if block > MAX_BLOCK or block & (block - 1):
        raise ValueError(f"the CUDA kernels take a power-of-two page size "
                         f"up to {MAX_BLOCK}, got {block}")
    args = [a for a in (q, k_pool, v_pool, tables, positions, seq_slots,
                        k_scale, v_scale) if a is not None]
    if not all(a.is_contiguous() for a in args):
        raise ValueError("paged_attention needs contiguous inputs")
    if any(a.data_ptr() % 16 for a in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    walk = _walk_bound(live_pages, tables.shape[1])
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    quantized = k_scale is not None
    if work is None:
        work = plan_paged_work(
            None if seq_slots is None else seq_slots.cpu().numpy(), T, walk,
            k_pool, dtype=q.dtype, quantized=quantized, scale=scale)
    check_paged_work(work, T, walk, hkv, _takes_tiles(
        seq_slots is not None, q.dtype, k_pool, quantized, scale))
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    slots_ptr = seq_slots.data_ptr() if seq_slots is not None else None
    geometry = (T, hq, hkv, hd, n_pages, block, tables.shape[1], walk,
                int(window), float(scale), _DTYPE_CODE[q.dtype])
    plan = work.plan.data_ptr()
    if work.n_tiles:
        _raise_on(lib, lib.dst_paged_attention_tiles(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), slots_ptr, positions.data_ptr(), plan,
            work.n_tiles, out.data_ptr(), *geometry, stream))
        paged_attention.tile_launches += 1
    if work.n_items:
        part = torch.empty((work.n_items, hq, hd), dtype=torch.float32,
                           device=q.device)
        part_ml = torch.empty((work.n_items, hq, 2), dtype=torch.float32,
                              device=q.device)
        items = plan + 4 * 2 * work.n_tiles
        _raise_on(lib, lib.dst_paged_attention_split(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            tables.data_ptr(), slots_ptr, positions.data_ptr(), items,
            work.n_items, items + 4 * 3 * work.n_items, work.n_lanes,
            part.data_ptr(), part_ml.data_ptr(), out.data_ptr(), *geometry,
            0 if k_scale is None else int(kv_bits), stream))
        paged_attention.split_launches += 1
    if k_scale is None:
        paged_attention.launches += 1
    elif kv_bits == 8:
        paged_attention.int8_launches += 1
    else:
        paged_attention.int4_launches += 1
    return out


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{lib.dst_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


# launch counters, bumped only where a kernel launches: one a call by pool
# type, and one a call that ran tile items / lane items
paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.int4_launches = 0
paged_attention.tile_launches = 0
paged_attention.split_launches = 0

"""Host-side ragged batch building: a native C++ path and a numpy one.

Ports ``deepspeed_tpu/ops/ragged_host.py``: it flattens the scheduled
per-sequence token chunks into the step batch and scatters per-sequence
block lists into the dense block table that the paged attention kernel
reads. ``native=True`` runs ``csrc/ragged_host.cpp`` (a copy of the JAX
package's ``csrc/ragged/ds_ragged_host.cpp``), built by the host C++
compiler at first use (:func:`~deepspeed_tpu_torch.ops.op_builder.
load_host`); a failed build raises — there is no silent fallback. The
engines on a CUDA device take the native path; CPU engines the numpy one.
Both give the same arrays bitwise.

``build_batch.native_launches`` / ``fill_tables.native_launches`` count
the calls that ran the native library.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .op_builder import load_host

        lib = load_host("ragged_host")
        # int32 buffers go by address (``_ptr``): every array handed over
        # is made here, int32 and C-contiguous
        ptr, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.ds_ragged_build_batch.restype = None
        lib.ds_ragged_build_batch.argtypes = [i32] + [ptr] * 8
        lib.ds_ragged_fill_tables.restype = i32
        lib.ds_ragged_fill_tables.argtypes = [i32] + [ptr] * 3 + [i32, ptr]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def build_batch(chunks: Sequence[Sequence[int]], seens: Sequence[int],
                slots: Sequence[int], T: int, pad_slot: int = -1,
                native: bool = False,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten scheduled per-sequence token chunks into the step batch.

    Returns (flat_tokens [T], flat_slot [T] (= pad_slot on unused lanes),
    flat_pos [T], last_index [n] — flat index of each chunk's final token).
    """
    n = len(chunks)
    lens = np.fromiter((len(c) for c in chunks), np.int32, count=n)
    offsets = np.zeros((n + 1,), np.int32)
    np.cumsum(lens, out=offsets[1:])
    if n and int(offsets[-1]) > T:
        raise ValueError(
            f"scheduled tokens {int(offsets[-1])} exceed batch width {T}")
    # one C-level conversion per chunk (not per token), then one concat
    concat = np.concatenate(
        [np.asarray(c, np.int32) for c in chunks]) if n else \
        np.zeros((0,), np.int32)
    seens = np.ascontiguousarray(seens, np.int32)
    slots_a = np.ascontiguousarray(slots, np.int32)
    flat_tokens = np.zeros((T,), np.int32)
    flat_slot = np.full((T,), pad_slot, np.int32)
    flat_pos = np.zeros((T,), np.int32)
    last_index = np.zeros((n,), np.int32)

    if native:
        # the C loop trusts its arrays: one seen and one slot a chunk
        if len(seens) != n or len(slots_a) != n:
            raise ValueError(f"{n} chunks but {len(seens)} seens and "
                             f"{len(slots_a)} slots")
        _lib().ds_ragged_build_batch(
            n, _ptr(concat), _ptr(offsets), _ptr(seens), _ptr(slots_a),
            _ptr(flat_tokens), _ptr(flat_slot), _ptr(flat_pos),
            _ptr(last_index))
        build_batch.native_launches += 1
        return flat_tokens, flat_slot, flat_pos, last_index

    cursor = 0
    for i in range(n):
        take = int(offsets[i + 1] - offsets[i])
        flat_tokens[cursor:cursor + take] = concat[offsets[i]:offsets[i + 1]]
        flat_slot[cursor:cursor + take] = slots_a[i]
        flat_pos[cursor:cursor + take] = np.arange(
            seens[i], seens[i] + take, dtype=np.int32)
        cursor += take
        last_index[i] = cursor - 1
    return flat_tokens, flat_slot, flat_pos, last_index


def fill_tables(block_lists: Sequence[Sequence[int]], slots: Sequence[int],
                max_seqs: int, max_pages: int,
                native: bool = False) -> np.ndarray:
    """Scatter per-sequence block lists into the dense [max_seqs,
    max_pages] table (zero-padded rows). A sequence owning more than
    max_pages blocks is an engine invariant violation — raise rather than
    truncate into wrong attention reads."""
    n = len(block_lists)
    tables = np.zeros((max_seqs, max_pages), np.int32)
    lens = np.fromiter((len(b) for b in block_lists), np.int32, count=n)
    if n and int(lens.max()) > max_pages:
        raise ValueError(
            f"sequence owns {int(lens.max())} blocks > max_pages {max_pages}")
    offsets = np.zeros((n + 1,), np.int32)
    np.cumsum(lens, out=offsets[1:])
    concat = np.concatenate(
        [np.asarray(b, np.int32) for b in block_lists]) if n else \
        np.zeros((0,), np.int32)
    slots_a = np.ascontiguousarray(slots, np.int32)

    if native:
        # the C loop writes row slots[i]: every slot must name a row
        if len(slots_a) != n or (n and not (
                0 <= int(slots_a.min()) and int(slots_a.max()) < max_seqs)):
            raise ValueError(f"slots {slots_a.tolist()} do not name {n} rows "
                             f"of a [{max_seqs}, {max_pages}] table")
        overflowed = _lib().ds_ragged_fill_tables(
            n, _ptr(concat), _ptr(offsets), _ptr(slots_a), max_pages,
            _ptr(tables))
        fill_tables.native_launches += 1
        if overflowed:  # unreachable past the pre-check above
            raise ValueError(f"{overflowed} block lists exceed max_pages")
        return tables

    for i in range(n):
        tables[slots_a[i], :lens[i]] = concat[offsets[i]:offsets[i + 1]]
    return tables


build_batch.native_launches = 0
fill_tables.native_launches = 0

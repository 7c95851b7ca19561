// Host-side ragged batch construction for the continuous-batching engine.
// A copy of csrc/ragged/ds_ragged_host.cpp (the JAX package's library),
// built by deepspeed_tpu_torch/ops/op_builder.py's load_host.
//
// Parity target: the reference keeps FastGen's batch building native —
// inference/v2/ragged/csrc/fast_host_buffer.cpp builds the flattened
// token/metadata buffers the ragged kernels consume. Here the same role:
// given the scheduled per-sequence chunks (concatenated tokens + offsets)
// fill the flat [T] token/slot/position lanes, and scatter per-sequence
// block lists into the dense [max_seqs, max_pages] table the paged
// attention kernel prefetches.
//
// Plain C ABI for ctypes (ops/ragged_host.py); no torch, no pybind.

#include <cstdint>

extern "C" {

// tokens_concat: all scheduled chunks back-to-back; offsets: [n+1] chunk
// boundaries; seens/slots: [n] per scheduled sequence. Fills
// flat_tokens/flat_slot/flat_pos (caller-allocated [T], pre-filled with
// padding) and last_index [n] = flat index of each sequence's final token.
void ds_ragged_build_batch(int32_t n,
                           const int32_t* tokens_concat,
                           const int32_t* offsets,
                           const int32_t* seens,
                           const int32_t* slots,
                           int32_t* flat_tokens,
                           int32_t* flat_slot,
                           int32_t* flat_pos,
                           int32_t* last_index) {
  int32_t cursor = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t take = offsets[i + 1] - offsets[i];
    const int32_t* chunk = tokens_concat + offsets[i];
    const int32_t seen = seens[i];
    const int32_t slot = slots[i];
    for (int32_t j = 0; j < take; ++j) {
      flat_tokens[cursor + j] = chunk[j];
      flat_slot[cursor + j] = slot;
      flat_pos[cursor + j] = seen + j;
    }
    cursor += take;
    last_index[i] = cursor - 1;
  }
}

// blocks_concat: every live sequence's block list back-to-back; offsets:
// [n+1]; slots: [n]. Scatters into tables [max_seqs * max_pages]
// (caller-zeroed), row-major by slot. Returns the number of sequences
// whose block list exceeded max_pages — such rows are written only up to
// max_pages (no OOB), and a non-zero return is an engine invariant
// violation the wrapper raises on (never silently truncate into wrong
// attention reads).
int32_t ds_ragged_fill_tables(int32_t n,
                              const int32_t* blocks_concat,
                              const int32_t* offsets,
                              const int32_t* slots,
                              int32_t max_pages,
                              int32_t* tables) {
  int32_t overflowed = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t count = offsets[i + 1] - offsets[i];
    if (count > max_pages) ++overflowed;
    const int32_t* blocks = blocks_concat + offsets[i];
    int32_t* row = tables + static_cast<int64_t>(slots[i]) * max_pages;
    const int32_t lim = count < max_pages ? count : max_pages;
    for (int32_t j = 0; j < lim; ++j) {
      row[j] = blocks[j];
    }
  }
  return overflowed;
}

}  // extern "C"

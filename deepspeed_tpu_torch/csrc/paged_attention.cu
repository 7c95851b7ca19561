// Paged attention over a paged KV pool, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (`paged_attention`, body `_kernel`) for floating-point pools (fp32, fp16,
// bf16) and quantized ones (below). Same function as the plain PyTorch version
// `deepspeed_tpu_torch/ops/paged_attention.py::paged_attention_reference`:
//
//   q [T, hq, hd], k_pool/v_pool [n_pages, hkv, block, hd], tables
//   [rows, max_pages] int32 (row = seq_slots[t], or t when seq_slots is
//   null), positions [T] int32. Token t attends to key rows k of its page
//   list with k <= pos and, for window > 0, k > pos - window. The page walk
//   is bounded by min(pos / block + 1, live_pages, max_pages) ("walk");
//   rows beyond are ignored. GQA: q-head h reads kv-head h / (hq / hkv),
//   never expanded. Masking uses -1e30, softmax and accumulation are fp32,
//   a row that sees no key writes 0 (the l == 0 guard), and the output has
//   q's dtype. On fp pools P is rounded to V's dtype before P.V (the TPU
//   kernel's :123).
//
// Quantized pools (TPU kernel the same `_kernel` with kv_bits 8/4,
// paged_attention.py:91-105): k_pool/v_pool hold int8 payloads [n_pages,
// hkv, block, hd], or int4 nibbles uint8 [n_pages, hkv, block, hd / 2]
// (channel 2c in the low nibble, 2c+1 in the high one, two's complement),
// with fp32 scales k_scale/v_scale [n_pages, hkv, block] (one per
// head-vector, ops/quantizer.py::quantize_kv). Each element is
// dequantized as float(payload) * scale where it is read; q, both
// products and P stay fp32 (the JAX kernel's rounding for quantized
// pools). They move half (int8) or a quarter (int4) of a bf16 pool's
// payload bytes, plus 4 bytes of scale per head-vector.
//
// What bounds it on the H100: HBM bytes at decode (each (token, kv-head)
// reads its live pages once and does 4 flops per element read, far below
// the ~295 flops/byte where the tensor cores would bind); at prefill a
// chunk of n tokens of one sequence shares its pages, so the bytes are the
// pages once and the work is n times the decode's: operations, on the
// tensor cores.
//
// Design. A call's lanes come as a work list (ops/paged_attention.py
// `plan_paged_work`, built on the host from seq_slots once per engine put
// and shared by all layers) of two kinds of item:
// - tile items (`paged_tile_kernel`): up to 64 consecutive lanes of one
//   sequence (a prefill chunk), bf16/fp16 pools at hd 64 or 128 with
//   block 8-64. One block per (tile, q-head) runs attn_fwd.cuh's wgmma
//   mainloop, the flash forward's: a producer warp reads the sequence's
//   page-table entries and loads each page of a 64-key tile by TMA (a 2-D
//   tensor map over the pool as [n_pages * hkv * block, hd] rows, one box
//   of `block` rows per page and per 64-channel swizzle atom) into a ring
//   of K/V stages; one consumer warpgroup (64 rows) does S = Q.K^T, the
//   online softmax with each row masked by its own position, and
//   O += P.V by wgmma m64n64k16. A page is read once per tile and q-head
//   instead of once per token; GQA heads of a group re-read their
//   kv-head's pages from L2. Pages past the walk are zero-filled by TMA
//   (a coordinate past the pool) and masked.
// - lane items (`paged_split_kernel` + `paged_combine_kernel`): every
//   other lane (decode lanes, short runs, fp32 pools, hd 256, block < 8,
//   quantized pools). Split-K over pages: an item is (lane, span of
//   pages), one block per (item, kv-head) with the group's q rows; its
//   pages (block * hd contiguous elements of one kv-head) come by 1-D
//   bulk copies, 64 keys' worth a stage, into a ring of 1-4 stages; with
//   six or more small blocks an SM, one block's copies are in flight
//   while the others do q.k and p.v in fp32 on SIMT (decode does 4 flops
//   a byte). Each item writes fp32 partials (m, l, acc) to scratch; the
//   combine pass merges a lane's spans in a fixed order. No atomics: two
//   runs give equal bits.
// `paged_attention_kernel`, one block per (token, kv-head) walking its
// pages one at a time (the first design), stays as the yardstick the new
// kernels are timed against; no wrapper path calls it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "attn_fwd.cuh"  // the forward mainloop, wgmma helpers, hopper.cuh

namespace {

using namespace attn;

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the rounding point of a product's operand
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool visible(int krow, int pos, int window) {
  return krow <= pos && (window <= 0 || krow > pos - window);
}

// The signed (32 - R)-bit field of w whose top bit is bit 31 - L: shift it
// to the top as unsigned, then arithmetic-shift it down.
template <int L, int R>
__device__ __forceinline__ int sext(unsigned w) {
  return static_cast<int>(w << L) >> R;
}

// One 4-byte word of a quantized pool, dequantized with its row's scale
// into 4 (int8) or 8 (int4 nibbles, channel 2c low) fp32 values at d
// (16-byte aligned). Sign extension by shifts keeps the word in registers.
template <int BITS>
__device__ __forceinline__ void dequant_word(unsigned w, float sc, float* d) {
  if constexpr (BITS == 8) {
    *reinterpret_cast<float4*>(d) = make_float4(
        static_cast<float>(sext<24, 24>(w)) * sc,
        static_cast<float>(sext<16, 24>(w)) * sc,
        static_cast<float>(sext<8, 24>(w)) * sc,
        static_cast<float>(sext<0, 24>(w)) * sc);
  } else {
    *reinterpret_cast<float4*>(d) = make_float4(
        static_cast<float>(sext<28, 28>(w)) * sc,
        static_cast<float>(sext<24, 28>(w)) * sc,
        static_cast<float>(sext<20, 28>(w)) * sc,
        static_cast<float>(sext<16, 28>(w)) * sc);
    *reinterpret_cast<float4*>(d + 4) = make_float4(
        static_cast<float>(sext<12, 28>(w)) * sc,
        static_cast<float>(sext<8, 28>(w)) * sc,
        static_cast<float>(sext<4, 28>(w)) * sc,
        static_cast<float>(sext<0, 28>(w)) * sc);
  }
}

// Stage one page of one kv-head of K and of V into shared memory as S, both
// in one loop so each thread keeps two loads in flight. BITS 0 copies the
// fp payload 16 bytes a thread per step. BITS 8/4 read 4 bytes a thread per
// step (4 int8 or 8 int4 values: every thread of the block has work on a
// 16 x 128 page) and write them dequantized; hd is a multiple of 8, so a
// word never crosses a row.
template <typename P, typename S, int BITS>
__device__ __forceinline__ void stage_pages(
    const P* __restrict__ ksrc, const P* __restrict__ vsrc,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    S* __restrict__ kdst, S* __restrict__ vdst, int page_elems, int hd,
    int tid) {
  if constexpr (BITS == 0) {
    const int n16 = page_elems * static_cast<int>(sizeof(P)) / 16;
    const uint4* k16 = reinterpret_cast<const uint4*>(ksrc);
    const uint4* v16 = reinterpret_cast<const uint4*>(vsrc);
    uint4* kd = reinterpret_cast<uint4*>(kdst);
    uint4* vd = reinterpret_cast<uint4*>(vdst);
    for (int i = tid; i < n16; i += kThreads) {
      kd[i] = k16[i];
      vd[i] = v16[i];
    }
  } else {
    constexpr int per_word = BITS == 8 ? 4 : 8;
    const int n4 = page_elems / per_word;
    const unsigned* k4 = reinterpret_cast<const unsigned*>(ksrc);
    const unsigned* v4 = reinterpret_cast<const unsigned*>(vsrc);
    for (int i = tid; i < n4; i += kThreads) {
      const unsigned kw = k4[i];
      const unsigned vw = v4[i];
      const int e0 = i * per_word;
      const int r = e0 / hd;
      dequant_word<BITS>(kw, ksc[r], kdst + e0);
      dequant_word<BITS>(vw, vsc[r], vdst + e0);
    }
  }
}

// T: q/out type. P: pool payload type (T, int8, or uint8 nibbles). S: the
// staged page type (T for fp pools, fp32 for quantized ones). BITS: 0, 8, 4.
template <typename T, typename P, typename S, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ seq_slots,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int hq, int hkv, int hd, int n_pages, int block,
                       int max_pages, int live_pages, int window,
                       float scale) {
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int page_elems = block * hd;
  // payload elements of one page of one kv-head (int4 packs two per byte)
  const int page_payload = BITS == 4 ? page_elems / 2 : page_elems;

  // shared layout: K page, V page (16-byte aligned, first), then fp32
  // q rows [group][hd], acc [group][hd], scores/probs [group][block],
  // running max, running sum, correction [group] each
  extern __shared__ __align__(16) unsigned char smem[];
  S* k_s = reinterpret_cast<S*>(smem);
  S* v_s = k_s + page_elems;
  float* q_s = reinterpret_cast<float*>(v_s + page_elems);
  float* acc_s = q_s + group * hd;
  float* p_s = acc_s + group * hd;
  float* m_s = p_s + group * block;
  float* l_s = m_s + group;
  float* c_s = l_s + group;

  const int pos = positions[t];
  const int row = seq_slots != nullptr ? seq_slots[t] : t;
  const int* trow = tables + static_cast<long long>(row) * max_pages;
  const long long q_off =
      (static_cast<long long>(t) * hq + static_cast<long long>(g) * group) * hd;

  for (int e = tid; e < group * hd; e += kThreads) {
    q_s[e] = to_float(q[q_off + e]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < group; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // page walk: [lo, hi) — the causal limit, the live-pages bound and,
  // with a window, the first page of the band
  int hi = pos >= 0 ? pos / block + 1 : 0;
  hi = min(hi, min(live_pages, max_pages));
  int lo = 0;
  if (window > 0) {
    const int first = pos - window + 1;
    lo = first > 0 ? first / block : 0;
  }
  __syncthreads();

  for (int j = lo; j < hi; ++j) {
    // jnp indexing clamps an out-of-range page id; so does this kernel,
    // so a bad table entry reads a wrong page instead of faulting
    const int page = min(max(trow[j], 0), n_pages - 1);
    const long long slot = static_cast<long long>(page) * hkv + g;
    const float* ksc = BITS ? k_scale + slot * block : nullptr;
    const float* vsc = BITS ? v_scale + slot * block : nullptr;
    stage_pages<P, S, BITS>(k_pool + slot * page_payload,
                            v_pool + slot * page_payload, ksc, vsc, k_s, v_s,
                            page_elems, hd, tid);
    __syncthreads();

    // scores: one warp per (query row, key row) pair, lanes split hd
    for (int pr = warp; pr < group * block; pr += nwarps) {
      const int i = pr / block;
      const int r = pr - i * block;
      const float* qi = q_s + i * hd;
      const S* kr = k_s + r * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += qi[d] * to_float(kr[d]);
      dot = warp_sum(dot);
      if (lane == 0) p_s[pr] = dot * scale;
    }
    __syncthreads();

    // online softmax: one warp per query row
    const int row0 = j * block;
    for (int i = warp; i < group; i += nwarps) {
      float* si = p_s + i * block;
      float mt = kNegInf;
      for (int r = lane; r < block; r += 32)
        if (visible(row0 + r, pos, window)) mt = fmaxf(mt, si[r]);
      mt = warp_max(mt);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int r = lane; r < block; r += 32) {
        const float p =
            visible(row0 + r, pos, window) ? expf(si[r] - m_new) : 0.f;
        si[r] = round_to<S>(p);  // fp pools: P in V's dtype; S is fp32 else
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[i] = corr;
        m_s[i] = m_new;
        l_s[i] = l_s[i] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: one thread per (query row, channel)
    for (int e = tid; e < group * hd; e += kThreads) {
      const int i = e / hd;
      const int d = e - i * hd;
      const float* pi = p_s + i * block;
      float a = acc_s[e] * c_s[i];
      for (int r = 0; r < block; ++r) a += pi[r] * to_float(v_s[r * hd + d]);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < group * hd; e += kThreads) {
    const float l = l_s[e / hd];
    out[q_off + e] = from_float<T>(l == 0.f ? 0.f : acc_s[e] / l);
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* seq_slots;
  const int* positions;
  void* out;
  int T, hq, hkv, hd, n_pages, block, max_pages, live_pages, window;
  float scale;
};

template <typename T, typename P, typename S, int BITS>
int launch(const Args& a, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  const size_t smem =
      2 * static_cast<size_t>(a.block) * a.hd * sizeof(S) +
      sizeof(float) * (2 * static_cast<size_t>(group) * a.hd +
                       static_cast<size_t>(group) * a.block + 3 * group);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_attention_kernel<T, P, S, BITS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.T, a.hkv), dim3(kThreads), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
      static_cast<const P*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.seq_slots, a.positions, static_cast<T*>(a.out), a.hq, a.hkv, a.hd,
      a.n_pages, a.block, a.max_pages, a.live_pages, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_dtype(const Args& a, int dtype, cudaStream_t s) {
  using P = std::conditional_t<BITS == 8, signed char, unsigned char>;
  switch (dtype) {
    case 0:
      return launch<float, P, float, BITS>(a, s);
    case 1:
      return launch<__half, P, float, BITS>(a, s);
    default:
      return launch<__nv_bfloat16, P, float, BITS>(a, s);
  }
}

bool bad_geometry(int hq, int hkv, int hd, int n_pages, int block,
                  int max_pages, int dtype) {
  return hkv < 1 || hq % hkv != 0 || !(hd == 64 || hd == 128 || hd == 256) ||
         block < 1 || block > 64 || (block & (block - 1)) != 0 ||
         n_pages < 1 || max_pages < 1 || dtype < 0 || dtype > 2;
}

// ------------------------------------------- Hopper path: tile items
// A tile item is up to 64 consecutive lanes of one sequence; its block
// (one per tile and q-head) is one consumer warpgroup (warps 0-3) and one
// producer warp (warp 4). Two or more blocks share an SM.
constexpr int kTileLanes = 64;
constexpr int kTileThreads = 128 + 32;

template <int D>
struct TileLayout {
  static constexpr int H = D / 64;                     // swizzle atoms a row
  static constexpr int RING = H * kRows64;             // Q: [H][64][128 B]
  // two stages at d 128 keep two blocks on an SM
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int STAGE = 2 * H * kRows64;        // K halves, V halves
  static constexpr int STATS = RING + STAGES * STAGE;  // min, max position
  static constexpr int BARS = STATS + 16;
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
};
static_assert(TileLayout<128>::SMEM <= 232448, "shared memory of a block");

struct PagedArgs {
  int T, hq, hkv, hd, n_pages, block, max_pages, walk, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kTileThreads, 2)
paged_tile_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const int* __restrict__ tables,
                  const int* __restrict__ seq_slots,
                  const int* __restrict__ positions,
                  const int* __restrict__ tiles, T* __restrict__ out,
                  PagedArgs a) {
  using L = TileLayout<D>;
  constexpr int H = L::H, S = L::STAGES;
  extern __shared__ __align__(1024) unsigned char ring_raw[];
  const uint32_t raw = smem_addr(ring_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* stats = reinterpret_cast<int*>(ring_raw + (base - raw) + L::STATS);
  const uint32_t bars = base + L::BARS;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);
  const int t = threadIdx.x % 128;
  const int h = blockIdx.y, hk = h / (a.hq / a.hkv);
  const int t0 = tiles[2 * blockIdx.x], n = tiles[2 * blockIdx.x + 1];
  const int* trow =
      tables + static_cast<long long>(seq_slots[t0]) * a.max_pages;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
    stats[0] = 0x7fffffff;
    stats[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int ps = positions[t0 + threadIdx.x];
    atomicMin(stats, ps);
    atomicMax(stats + 1, ps);
  }
  __syncthreads();
  // the tile's keys: [lo_key, hi_key) covers every row's visible keys
  const int pmin = stats[0], pmax = stats[1];
  const int walk_keys = a.walk * a.block;
  const int hi_key = min(pmax + 1, walk_keys);
  const int lo_key = a.window > 0 ? max(pmin - a.window + 1, 0) : 0;
  const int jlo = lo_key / 64;
  const int jhi = hi_key > 0 ? (hi_key + 63) / 64 : 0;

  if (wg == 1) {
    // ---- producer warp: Q once; lane i loads page i of each kv tile
    const int ppt = 64 / a.block;
    const int lo_page = lo_key / a.block;
    const int hi_page = (hi_key + a.block - 1) / a.block;
    const int past = a.n_pages * a.hkv * a.block;  // TMA reads zeros there
    if (t == 0) {
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_expect_tx(qbar, H * kRows64);
      for (int hh = 0; hh < H; ++hh)
        tma_load_4d(base + hh * kRows64, &tm_q, qbar, 64 * hh, h, t0, 0);
    }
    for (int j = jlo; j < jhi; ++j) {
      const int i = j - jlo, s = i % S, pg = j * ppt + t;
      int row = past;
      if (t < ppt && pg >= lo_page && pg < hi_page)
        row = (min(max(trow[pg], 0), a.n_pages - 1) * a.hkv + hk) * a.block;
      mbar_wait(empty(s), ((i / S) & 1) ^ 1);
      if (t == 0) mbar_expect_tx(full(s), L::STAGE);
      __syncwarp();
      if (t < ppt) {
        const uint32_t st = base + L::RING + s * L::STAGE + t * a.block * 128;
        for (int hh = 0; hh < H; ++hh) {
          tma_load_2d(st + hh * kRows64, &tm_k, full(s), 64 * hh, row);
          tma_load_2d(st + (H + hh) * kRows64, &tm_v, full(s), 64 * hh, row);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: the tile's 64 rows, each masked by its own
  // position (rows past n see nothing and are not written)
  const int lane = t & 31;
  const int rloc = 16 * (t >> 5) + (lane >> 2);  // rows rloc, rloc + 8
  int pos[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
    pos[ri] = rloc + 8 * ri < n ? positions[t0 + rloc + 8 * ri] : -1;
  float o[H][32];
#pragma unroll
  for (int hh = 0; hh < H; ++hh)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[hh][x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  auto stage = [&](int i) {
    mbar_wait(full(i % S), (i / S) & 1);
    return base + L::RING + (i % S) * L::STAGE;
  };
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i % S));
  };
  auto masked = [&](int i) {
    const int k0 = (jlo + i) * 64;
    return !(k0 + 63 < walk_keys && k0 + 63 <= pmin &&
             (a.window <= 0 || k0 > pmax - a.window));
  };
  auto vis = [&](int i, int ri, int col) {
    const int key = (jlo + i) * 64 + col;
    return key < walk_keys && key <= pos[ri] &&
           (a.window <= 0 || key > pos[ri] - a.window);
  };
  fwd_mainloop<T, D>(o, m, l, base, kRows64, kRows64, max(jhi - jlo, 0),
                     a.scale * kLog2e, stage, release, masked, vis);
  fwd_finish<D>(o, l);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = rloc + 8 * ri;
    if (r < n)
      fwd_store_row<T, D>(
          out + (static_cast<long long>(t0 + r) * a.hq + h) * D, o, ri);
  }
}

// ------------------------------------------------ lane items: split-K
constexpr int kSplitThreads = 128;
// a stage holds 64 keys (64 / block pages); the ring's budget of 32 KB
// gives bf16 pages at hd 128 one stage a block and quantized ones two or
// four, and leaves room for six or more blocks an SM: on the H100 more
// blocks in flight beat deeper rings (PERF.md, section 6)
constexpr int kSplitKeys = 64;
constexpr int kSplitRingBytes = 32 * 1024;

__host__ __device__ inline int split_pages(int block) {
  return block < kSplitKeys ? kSplitKeys / block : 1;
}

// a staged row of hd channels: bytes, and channels per 16-byte chunk
template <typename P, int BITS>
struct Payload {
  static constexpr int E =
      BITS ? 128 / BITS : 16 / static_cast<int>(sizeof(P));
  static __host__ __device__ int row_bytes(int hd) {
    return BITS ? hd * BITS / 8 : hd * static_cast<int>(sizeof(P));
  }
};

// the E channels of 16-byte chunk c of a staged row as fp32; quantized
// payloads times the row's scale sc (float(payload) * scale, as
// quantize_kv's inverse)
template <typename P, int BITS>
__device__ __forceinline__ void decode_chunk(const unsigned char* row, int c,
                                             float sc,
                                             float (&d)[Payload<P, BITS>::E]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * c);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (BITS == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[4 * i] = static_cast<float>(sext<24, 24>(w[i])) * sc;
      d[4 * i + 1] = static_cast<float>(sext<16, 24>(w[i])) * sc;
      d[4 * i + 2] = static_cast<float>(sext<8, 24>(w[i])) * sc;
      d[4 * i + 3] = static_cast<float>(sext<0, 24>(w[i])) * sc;
    }
  } else if constexpr (BITS == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[8 * i] = static_cast<float>(sext<28, 28>(w[i])) * sc;
      d[8 * i + 1] = static_cast<float>(sext<24, 28>(w[i])) * sc;
      d[8 * i + 2] = static_cast<float>(sext<20, 28>(w[i])) * sc;
      d[8 * i + 3] = static_cast<float>(sext<16, 28>(w[i])) * sc;
      d[8 * i + 4] = static_cast<float>(sext<12, 28>(w[i])) * sc;
      d[8 * i + 5] = static_cast<float>(sext<8, 28>(w[i])) * sc;
      d[8 * i + 6] = static_cast<float>(sext<4, 28>(w[i])) * sc;
      d[8 * i + 7] = static_cast<float>(sext<0, 28>(w[i])) * sc;
    }
  } else {
    const P* e = reinterpret_cast<const P*>(w);
#pragma unroll
    for (int i = 0; i < Payload<P, BITS>::E; ++i) d[i] = to_float(e[i]);
  }
}

// channel ch of a staged row as fp32 (quantized: the payload, unscaled)
template <typename P, int BITS>
__device__ __forceinline__ float element(const unsigned char* row, int ch) {
  if constexpr (BITS == 8) {
    return static_cast<float>(reinterpret_cast<const signed char*>(row)[ch]);
  } else if constexpr (BITS == 4) {
    const unsigned b = row[ch >> 1];
    const int nib = (ch & 1) ? static_cast<int>(b >> 4)
                             : static_cast<int>(b & 15u);
    return static_cast<float>((nib ^ 8) - 8);
  } else {
    return to_float(reinterpret_cast<const P*>(row)[ch]);
  }
}

// One lane item (lane, pages [p0, p1)) and one kv-head: the group's q
// rows in fp32 against the item's pages of the lane's walk, staged by bulk
// copies `pps` pages (up to 64 keys) a stage into a ring of `stages`;
// writes the unnormalised acc and the (m, l) of each q-head to the item's
// partials.
template <typename QT, typename P, int BITS>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const QT* __restrict__ q,
                   const unsigned char* __restrict__ k_pool,
                   const unsigned char* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ seq_slots,
                   const int* __restrict__ positions,
                   const int* __restrict__ items, float* __restrict__ part,
                   float* __restrict__ part_ml, PagedArgs a, int stages) {
  using PL = Payload<P, BITS>;
  constexpr int E = PL::E;
  const int item = blockIdx.x, g = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, block = a.block;
  const int row_bytes = PL::row_bytes(hd);
  const int page_bytes = block * row_bytes;
  const int pps = split_pages(block), ks = pps * block;  // a stage's keys
  const int stage_bytes = pps * page_bytes;

  // shared: the ring's mbarriers (64 B), the ring [stages][K pages, V
  // pages], then fp32 q rows and acc [group][hd], scores [group][ks],
  // running max, sum and correction [group], K and V scales [ks]
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);
  unsigned char* ring = smem + 64;
  float* q_s = reinterpret_cast<float*>(ring + stages * 2 * stage_bytes);
  float* acc_s = q_s + group * hd;
  float* p_s = acc_s + group * hd;
  float* m_s = p_s + group * ks;
  float* l_s = m_s + group;
  float* c_s = l_s + group;
  float* ks_s = c_s + group;
  float* vs_s = ks_s + ks;

  const int lane_t = items[3 * item];
  const int pos = positions[lane_t];
  const int srow = seq_slots != nullptr ? seq_slots[lane_t] : lane_t;
  const int* trow = tables + static_cast<long long>(srow) * a.max_pages;
  // this item's share of the lane's page walk
  int hi = pos >= 0 ? pos / block + 1 : 0;
  hi = min(min(hi, a.walk), items[3 * item + 2]);
  int lo = 0;
  if (a.window > 0) {
    const int first = pos - a.window + 1;
    lo = first > 0 ? first / block : 0;
  }
  lo = max(lo, items[3 * item + 1]);
  const int nst = hi > lo ? (hi - lo + pps - 1) / pps : 0;  // stages walked

  const long long q_off =
      (static_cast<long long>(lane_t) * a.hq + static_cast<long long>(g) *
                                                   group) * hd;
  for (int e = tid; e < group * hd; e += kSplitThreads) {
    q_s[e] = to_float(q[q_off + e]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < group; i += kSplitThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto page_of = [&](int pg) { return min(max(trow[pg], 0), a.n_pages - 1); };
  // the pages of stage i: K pages, then V pages, each block * hd
  // contiguous elements of one kv-head, side by side
  auto issue = [&](int i) {
    const int s = i % stages, first = lo + i * pps;
    const int cnt = min(pps, hi - first);
    const uint32_t dst = smem_addr(ring + s * 2 * stage_bytes);
    mbar_expect_tx(bars + 8 * s, 2 * cnt * page_bytes);
    for (int j = 0; j < cnt; ++j) {
      const long long off =
          (static_cast<long long>(page_of(first + j)) * a.hkv + g) *
          page_bytes;
      bulk_load(dst + j * page_bytes, k_pool + off, page_bytes, bars + 8 * s);
      bulk_load(dst + stage_bytes + j * page_bytes, v_pool + off, page_bytes,
                bars + 8 * s);
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(stages, nst); ++i) issue(i);

  const int sub = tid & 7, nch = hd / E;
  for (int i = 0; i < nst; ++i) {
    const int s = i % stages, first = lo + i * pps;
    const int keys = min(pps, hi - first) * block, key0 = first * block;
    const unsigned char* kst = ring + s * 2 * stage_bytes;
    const unsigned char* vst = kst + stage_bytes;
    if constexpr (BITS != 0) {
      for (int k = tid; k < keys; k += kSplitThreads) {
        const long long at =
            (static_cast<long long>(page_of(first + k / block)) * a.hkv + g) *
                block + k % block;
        ks_s[k] = k_scale[at];
        vs_s[k] = v_scale[at];
      }
    }
    mbar_wait(bars + 8 * s, (i / stages) & 1);
    if constexpr (BITS != 0) __syncthreads();

    // scores: 8 threads a (row, key) pair, each over every 8th chunk
    for (int b0 = 0; b0 < group * keys; b0 += kSplitThreads / 8) {
      const int pr = b0 + (tid >> 3);
      const int r = pr / keys, key = pr - r * keys;
      float dot = 0.f;
      if (pr < group * keys) {
        const unsigned char* kr = kst + key * row_bytes;
        const float sc = BITS ? ks_s[key] : 1.f;
        const float* qr = q_s + r * hd;
        for (int c = sub; c < nch; c += 8) {
          float kv[E];
          decode_chunk<P, BITS>(kr, c, sc, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[c * E + e], kv[e], dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (pr < group * keys && sub == 0)
        p_s[r * ks + key] =
            visible(key0 + key, pos, a.window) ? dot * a.scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per q row; fp pools round P to V's dtype
    for (int r = warp; r < group; r += kSplitThreads / 32) {
      float* sr = p_s + r * ks;
      float mt = kNegInf;
      for (int c = lane; c < keys; c += 32) mt = fmaxf(mt, sr[c]);
      mt = warp_max(mt);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int c = lane; c < keys; c += 32) {
        const float x = sr[c];
        const float e = x <= 0.5f * kNegInf ? 0.f : expf(x - m_new);
        sum += e;
        if constexpr (BITS == 0)
          sr[c] = round_to<P>(e);
        else
          sr[c] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + p.V: one thread per (q row, channel)
    for (int e = tid; e < group * hd; e += kSplitThreads) {
      const int r = e / hd, ch = e - r * hd;
      const float* pr = p_s + r * ks;
      float acc = acc_s[e] * c_s[r];
      for (int key = 0; key < keys; ++key) {
        float vv = element<P, BITS>(vst + key * row_bytes, ch);
        if constexpr (BITS != 0) vv *= vs_s[key];
        acc = fmaf(pr[key], vv, acc);
      }
      acc_s[e] = acc;
    }
    __syncthreads();
    // every thread is done with stage s: refill it
    if (tid == 0 && i + stages < nst) issue(i + stages);
  }

  const long long at = static_cast<long long>(item) * a.hq +
                       static_cast<long long>(g) * group;
  for (int e = tid; e < group * hd; e += kSplitThreads)
    part[at * hd + e] = acc_s[e];
  for (int r = tid; r < group; r += kSplitThreads) {
    part_ml[2 * (at + r)] = m_s[r];
    part_ml[2 * (at + r) + 1] = l_s[r];
  }
}

// A lane's output from its items' partials, merged in item order:
// out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), M = max_i m_i;
// 0 where no item saw a key
template <typename QT>
__global__ void __launch_bounds__(kSplitThreads)
paged_combine_kernel(const float* __restrict__ part,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ lanes, QT* __restrict__ out,
                     int hq, int hd) {
  const int li = blockIdx.x, h = blockIdx.y;
  const int lane_t = lanes[3 * li], first = lanes[3 * li + 1];
  const int cnt = lanes[3 * li + 2];
  float mx = kNegInf;
  for (int i = 0; i < cnt; ++i)
    mx = fmaxf(mx, part_ml[2 * (static_cast<long long>(first + i) * hq + h)]);
  for (int ch = threadIdx.x; ch < hd; ch += kSplitThreads) {
    float sum = 0.f, acc = 0.f;
    for (int i = 0; i < cnt; ++i) {
      const long long at = static_cast<long long>(first + i) * hq + h;
      const float w = expf(part_ml[2 * at] - mx);
      sum = fmaf(part_ml[2 * at + 1], w, sum);
      acc = fmaf(part[at * hd + ch], w, acc);
    }
    out[(static_cast<long long>(lane_t) * hq + h) * hd + ch] =
        from_float<QT>(sum == 0.f ? 0.f : acc / sum);
  }
}

// ----------------------------------------------- the new paths' launch
template <typename T, int D>
int launch_tiles(const void* q, const void* k_pool, const void* v_pool,
                 const int* tables, const int* seq_slots,
                 const int* positions, const int* tiles, int n_tiles,
                 void* out, const PagedArgs& a, cudaStream_t stream) {
  using L = TileLayout<D>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int rows = a.n_pages * a.hkv * a.block;
  CUtensorMap tq, tk, tv;
  int err = encode_heads<T>(&tq, q, 1, a.T, a.hq, D, kTileLanes);
  if (!err) err = encode_2d(&tk, type, 2, k_pool, rows, D, a.block, 64, true);
  if (!err) err = encode_2d(&tv, type, 2, v_pool, rows, D, a.block, 64, true);
  if (err) return err;
  auto kernel = paged_tile_kernel<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(n_tiles, a.hq), kTileThreads, L::SMEM, stream>>>(
      tq, tk, tv, tables, seq_slots, positions, tiles, static_cast<T*>(out),
      a);
  return static_cast<int>(cudaGetLastError());
}

// the ring's stages for stages of `stage_bytes`, and the block's dynamic
// shared memory
inline int split_stages(int stage_bytes) {
  return std::max(1, std::min(4, kSplitRingBytes / (2 * stage_bytes)));
}
inline size_t split_smem(int stages, int stage_bytes, int group, int hd,
                         int keys) {
  return 64 + static_cast<size_t>(stages) * 2 * stage_bytes +
         sizeof(float) * (2 * static_cast<size_t>(group) * hd +
                          static_cast<size_t>(group) * keys + 3 * group +
                          2 * keys);
}

template <typename QT, typename P, int BITS>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* seq_slots,
                 const int* positions, const int* items, int n_items,
                 const int* lanes, int n_lanes, float* part, float* part_ml,
                 void* out, const PagedArgs& a, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  const int pps = split_pages(a.block);
  const int stage_bytes =
      pps * a.block * Payload<P, BITS>::row_bytes(a.hd);
  const int stages = split_stages(stage_bytes);
  const size_t smem =
      split_smem(stages, stage_bytes, group, a.hd, pps * a.block);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_split_kernel<QT, P, BITS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(n_items, a.hkv), kSplitThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const unsigned char*>(k_pool),
      static_cast<const unsigned char*>(v_pool), k_scale, v_scale, tables,
      seq_slots, positions, items, part, part_ml, a, stages);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  paged_combine_kernel<QT><<<dim3(n_lanes, a.hq), kSplitThreads, 0, stream>>>(
      part, part_ml, lanes, static_cast<QT*>(out), a.hq, a.hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_split_bits(int kv_bits, const void* q, const void* k_pool,
                      const void* v_pool, const float* k_scale,
                      const float* v_scale, const int* tables,
                      const int* seq_slots, const int* positions,
                      const int* items, int n_items, const int* lanes,
                      int n_lanes, float* part, float* part_ml, void* out,
                      const PagedArgs& a, cudaStream_t s) {
  switch (kv_bits) {
    case 8:
      return launch_split<QT, signed char, 8>(
          q, k_pool, v_pool, k_scale, v_scale, tables, seq_slots, positions,
          items, n_items, lanes, n_lanes, part, part_ml, out, a, s);
    case 4:
      return launch_split<QT, unsigned char, 4>(
          q, k_pool, v_pool, k_scale, v_scale, tables, seq_slots, positions,
          items, n_items, lanes, n_lanes, part, part_ml, out, a, s);
    default:
      return launch_split<QT, QT, 0>(
          q, k_pool, v_pool, k_scale, v_scale, tables, seq_slots, positions,
          items, n_items, lanes, n_lanes, part, part_ml, out, a, s);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = fp16, 2 = bf16 (q, pools and out). Returns a
// cudaError_t value (0 = ok). Launches on `stream` and does not synchronise.
extern "C" int dst_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const int* tables,
                                   const int* seq_slots, const int* positions,
                                   void* out, int T_, int hq, int hkv, int hd,
                                   int n_pages, int block, int max_pages,
                                   int live_pages, int window, float scale,
                                   int dtype, void* stream) {
  if (bad_geometry(hq, hkv, hd, n_pages, block, max_pages, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_ == 0) return 0;
  const Args a{q, k_pool, v_pool, nullptr, nullptr, tables, seq_slots,
               positions, out, T_, hq, hkv, hd, n_pages, block, max_pages,
               live_pages, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float, float, 0>(a, s);
    case 1:
      return launch<__half, __half, __half, 0>(a, s);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, 0>(a, s);
  }
}

// Quantized pools: kv_bits 8 (int8 payload [.., hd]) or 4 (uint8 nibbles
// [.., hd / 2]) with fp32 scales [n_pages, hkv, block]; dtype is q's and
// out's (0 = fp32, 1 = fp16, 2 = bf16).
extern "C" int dst_paged_attention_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* seq_slots, const int* positions, void* out, int T_, int hq,
    int hkv, int hd, int n_pages, int block, int max_pages, int live_pages,
    int window, float scale, int dtype, int kv_bits, void* stream) {
  if (bad_geometry(hq, hkv, hd, n_pages, block, max_pages, dtype) ||
      (kv_bits != 8 && kv_bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_ == 0) return 0;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, seq_slots,
               positions, out, T_, hq, hkv, hd, n_pages, block, max_pages,
               live_pages, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_bits == 8 ? launch_dtype<8>(a, dtype, s)
                      : launch_dtype<4>(a, dtype, s);
}

// Tile items (`paged_tile_kernel`): `tiles` [n_tiles, 2] int32 (first lane,
// lanes <= 64), every lane of a tile on one seq_slots row. Takes bf16/fp16
// (dtype 1, 2) at hd 64 or 128, block 8-64, a positive scale and 16-byte
// aligned q and pools; returns cudaErrorInvalidValue on anything else
// (ops/paged_attention.py `paged_tile_path` states the same).
extern "C" int dst_paged_attention_tiles(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* seq_slots, const int* positions, const int* tiles,
    int n_tiles, void* out, int T_, int hq, int hkv, int hd, int n_pages,
    int block, int max_pages, int walk, int window, float scale, int dtype,
    void* stream) {
  if (bad_geometry(hq, hkv, hd, n_pages, block, max_pages, dtype) ||
      !(dtype == 1 || dtype == 2) || !(hd == 64 || hd == 128) || block < 8 ||
      !(scale > 0.f) || seq_slots == nullptr || !hopper::aligned16(q) ||
      !hopper::aligned16(k_pool) || !hopper::aligned16(v_pool) || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const PagedArgs a{T_, hq, hkv, hd, n_pages, block, max_pages, walk, window,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return hd == 64 ? launch_tiles<__half, 64>(q, k_pool, v_pool, tables,
                                                seq_slots, positions, tiles,
                                                n_tiles, out, a, s)
                    : launch_tiles<__half, 128>(q, k_pool, v_pool, tables,
                                                 seq_slots, positions, tiles,
                                                 n_tiles, out, a, s);
  return hd == 64 ? launch_tiles<__nv_bfloat16, 64>(q, k_pool, v_pool, tables,
                                                     seq_slots, positions,
                                                     tiles, n_tiles, out, a, s)
                  : launch_tiles<__nv_bfloat16, 128>(
                        q, k_pool, v_pool, tables, seq_slots, positions, tiles,
                        n_tiles, out, a, s);
}

// Lane items (`paged_split_kernel`, then `paged_combine_kernel`): `items`
// [n_items, 3] int32 (lane, first page, end page), a lane's items
// consecutive; `lanes` [n_lanes, 3] int32 (lane, first item, items);
// scratch `part` [n_items, hq, hd] and `part_ml` [n_items, hq, 2] fp32.
// kv_bits 0 takes fp pools of q's dtype, 8 and 4 quantized pools with
// their fp32 scales.
extern "C" int dst_paged_attention_split(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* seq_slots, const int* positions, const int* items,
    int n_items, const int* lanes, int n_lanes, float* part, float* part_ml,
    void* out, int T_, int hq, int hkv, int hd, int n_pages, int block,
    int max_pages, int walk, int window, float scale, int dtype, int kv_bits,
    void* stream) {
  if (bad_geometry(hq, hkv, hd, n_pages, block, max_pages, dtype) ||
      !(kv_bits == 0 || kv_bits == 8 || kv_bits == 4) ||
      (kv_bits != 0 && (k_scale == nullptr || v_scale == nullptr)) ||
      !hopper::aligned16(k_pool) || !hopper::aligned16(v_pool) ||
      hkv > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return 0;
  const PagedArgs a{T_, hq, hkv, hd, n_pages, block, max_pages, walk, window,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_split_bits<float>(kv_bits, q, k_pool, v_pool, k_scale,
                                      v_scale, tables, seq_slots, positions,
                                      items, n_items, lanes, n_lanes, part,
                                      part_ml, out, a, s);
    case 1:
      return launch_split_bits<__half>(kv_bits, q, k_pool, v_pool, k_scale,
                                       v_scale, tables, seq_slots, positions,
                                       items, n_items, lanes, n_lanes, part,
                                       part_ml, out, a, s);
    default:
      return launch_split_bits<__nv_bfloat16>(
          kv_bits, q, k_pool, v_pool, k_scale, v_scale, tables, seq_slots,
          positions, items, n_items, lanes, n_lanes, part, part_ml, out, a, s);
  }
}

// dynamic shared memory of a tile block at hd 64 / 128, for the build report
extern "C" int dst_paged_tile_smem(int hd) {
  return hd == 64 ? TileLayout<64>::SMEM : TileLayout<128>::SMEM;
}

extern "C" const char* dst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

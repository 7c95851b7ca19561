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
//   is bounded by min(pos / block + 1, live_pages, max_pages); rows beyond
//   are ignored. GQA: q-head h reads kv-head h / (hq / hkv). Masking uses
//   -1e30, softmax and accumulation are fp32, a row that sees no key
//   writes 0 (the l == 0 guard), and the output has q's dtype.
//
// Quantized pools (`dst_paged_attention_quant`, TPU kernel the same
// `_kernel` with kv_bits 8/4, paged_attention.py:91-105): k_pool/v_pool hold
// int8 payloads [n_pages, hkv, block, hd], or int4 nibbles uint8 [n_pages,
// hkv, block, hd / 2] (channel 2c in the low nibble, 2c+1 in the high one,
// two's complement), with fp32 scales k_scale/v_scale [n_pages, hkv, block]
// (one per head-vector, ops/quantizer.py::quantize_kv). A page is
// dequantized while it is staged (4-byte loads, one word per thread per
// step), float(payload) * scale, into fp32 shared memory; q is cast to fp32, and both products and P stay fp32 (the JAX
// kernel's rounding for quantized pools, not the bf16 P of its fp pools).
// The page walk, masks, windows, seq_slots, live_pages and the l == 0 guard
// are the fp kernel's; only the staging differs. It moves half (int8) or a
// quarter (int4) of a bf16 pool's payload bytes, plus 4 bytes of scale per
// head-vector.
//
// What bounds it on the H100: HBM bytes. Every (token, kv-head) reads its
// live K and V pages once and does 4 flops per element read (q.k and p.v),
// far below the ~295 flops/byte where the tensor cores would bind.
//
// Design (simple and right first): one thread block per (token, kv-head).
// The block keeps the group's hq/hkv query rows in shared memory in fp32,
// walks its live pages in order, stages each K and V page in shared memory
// with 16-byte loads (one page of one kv-head is contiguous: block * hd
// elements), and keeps an fp32 online softmax (running max m, sum l,
// accumulator acc) per query row. A warp computes one q.k dot product at a
// time with its lanes split over hd; a thread owns one (row, channel)
// element of the accumulator. The block loads its own table entries, so no
// per-token table is ever materialised, and pages outside the causal limit
// or the window band are never read: the bytes moved are the bytes the
// function needs. Later work: split-K over pages (flash-decoding) so a long
// context uses more than one SM per (token, kv-head); one q tile per prefill
// chunk so a page is read once for all its tokens; cp.async/TMA double
// buffering; mma/wgmma for the q.k and p.v products.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
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
        si[r] = p;
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

extern "C" const char* dst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

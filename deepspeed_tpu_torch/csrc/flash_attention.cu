// Flash attention, forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   forward  `_flash_forward`       pallas_call at :200 (body `_fwd_kernel` :72)
//   dq       `_flash_backward`      pallas_call at :354 (body `_dq_kernel` :234)
//   dk/dv    `_flash_backward`      pallas_call at :386 (body `_dkv_kernel` :272)
// Same functions as the plain PyTorch versions in
// deepspeed_tpu_torch/ops/flash_attention.py (`flash_attention_forward_reference`,
// `flash_attention_backward_reference`):
//
//   q [b, sq, hq, d], k/v [b, skv, hkv, d] (fp32, fp16 or bf16, contiguous),
//   out [b, sq, hq, d] in q's dtype, lse / delta [b, hq, sq] fp32. q-head h
//   reads kv-head h / (hq / hkv) (GQA, never expanded). Causal masking is
//   aligned to the END of the kv sequence: query row i sits at position
//   i + skv - sq and sees key k when k <= that position and, with window > 0,
//   k > position - window. Masked logits are -1e30 and give probability 0; a
//   row that sees no key writes 0 and LSE 1e30. Rows and keys past sq / skv
//   (the ragged tail of the last tile) are masked here, so any length works.
//
// Rounding points are the TPU kernels': Q.K^T, dO.V^T and every accumulator
// in fp32; P is rounded to V's dtype before P.V (:117) and to dO's dtype
// before P^T.dO (:306); dS is rounded to the input dtype before dS.K and
// dS^T.Q (:263, :311). The backward recomputes P from the LSE; delta =
// rowsum(dO * O) comes in from the wrapper (fp32, as :344 computes it).
//
// What bounds it on the H100: operations. At the training shape (b 4, s 2048,
// hq 32, hkv 4, d 64, causal) the forward does about 6.9e10 operations
// (4 d per visible (q-head, key) pair) against about 77 MB of q, k, v, out
// and lse: some 900 operations per byte, three times the ~295 where the
// tensor cores stop waiting for HBM. dq does 6 d and dk/dv 8 d per pair.
// So the products belong on the tensor cores.
//
// Design (simple and right first). The TPU grid walks kv tiles in order and
// carries the softmax state in VMEM scratch; here each thread block owns one
// output tile and loops over the tiles it needs itself, so nothing crosses
// blocks:
// - forward: one block per (q tile of 64 rows, q-head, batch). It stages its
//   Q tile once, then each K/V tile of the range the causal band and the
//   window allow (`_tile_runs` :61; tiles above the diagonal or below the
//   band are never loaded), and carries an fp32 online softmax (running max
//   m, sum l) across tiles.
// - dq: one block per (q tile, q-head, batch), the same kv-tile walk.
// - dk/dv: one block per (kv tile, kv-head, batch). It keeps its K and V
//   tiles, loops over the group's q-heads and, for each, over the q tiles
//   that reach this kv tile (`_q_tile_clamp` :164), and sums dK and dV in
//   fp32 registers. No atomics: every output element is written once by one
//   block, so two runs give bitwise-equal gradients.
// Two instruction paths share that structure:
// - bf16/fp16 at d 64 and 128 (the training path): four warps per block,
//   mma.sync m16n8k16 on T operands staged in shared memory, fp32
//   accumulators; P and dS pass from the score accumulators straight into
//   the next product's A operand (see the tensor-core section below).
// - fp32, and d 256: 256 threads on a 16 x 16 grid, scalar fp32 FMA over
//   tiles converted to fp32 in shared memory (rows padded by one float);
//   kv tiles are 32 rows at d 256 so dk/dv stays under 227 KB.
// Above 48 KB of shared memory the launcher raises the dynamic limit.
// Later work: wgmma on bf16/fp16 tiles fed by TMA into a ring of K/V stages,
// FA3-style warp specialisation (a producer warp for the copies, consumer
// warpgroups for the products, softmax overlapped with the next product),
// and a persistent schedule that balances the causal triangle across SMs.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // a 16 x 16 thread grid over every tile
constexpr int kBQ = 64;        // q rows per tile

template <int D>
struct Shape {
  static constexpr int BK = D == 256 ? 32 : 64;  // kv rows per tile
  static constexpr int LD = D + 1;               // padded row of a [rows][D] tile
  static constexpr int LS = BK + 1;              // padded row of a [kBQ][BK] tile
  static constexpr int RI = kBQ / 16;            // q rows per thread
  static constexpr int CJ = BK / 16;             // kv rows per thread
  static constexpr int CD = D / 16;              // channels per thread
};

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

struct Problem {
  int sq, skv, hq, hkv, causal, window;
  float scale;
  __device__ __forceinline__ int diag() const { return skv - sq; }
  // query row `row` sees key `col`
  __device__ __forceinline__ bool visible(int row, int col) const {
    if (row >= sq || col >= skv) return false;
    if (!causal) return true;
    const int qp = row + skv - sq;
    return col <= qp && (window <= 0 || col > qp - window);
  }
};

// rows [r0, r0 + R) of head h of a [b, S, H, D] tensor into a padded fp32
// tile [R][D + 1] in shared memory, 16 bytes per load; rows >= S read 0
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int S, int H, int h) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < R * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * V;
    float* d = dst + r * (D + 1) + c;
    const int row = r0 + r;
    if (row < S) {
      const long long off =
          ((static_cast<long long>(b) * S + row) * H + h) * D + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + off);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = 0.f;
    }
  }
}

// rows [r0, r0 + kBQ) of a [b, hq, sq] fp32 row statistic; rows >= sq get
// `fill`
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int b, int h, int r0, int sq, int hq,
                                          float fill) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int row = r0 + r;
    dst[r] = row < sq
                 ? src[(static_cast<long long>(b) * hq + h) * sq + row]
                 : fill;
  }
}

// kv tiles [lo, hi) that q rows [r0, r1] reach (`_tile_runs` :61)
__device__ __forceinline__ void kv_tile_range(const Problem& p, int r0, int r1,
                                              int bk, int* lo, int* hi) {
  const int nk = (p.skv + bk - 1) / bk;
  *lo = 0;
  *hi = nk;
  if (!p.causal) return;
  const int last = r1 + p.diag();  // last key the last row sees
  *hi = last < 0 ? 0 : min(nk, last / bk + 1);
  if (p.window > 0) {
    const int first = r0 + p.diag() - p.window + 1;  // first key of row r0
    *lo = first > 0 ? first / bk : 0;
  }
}

// q tiles of bq rows [lo, hi) that reach kv rows [k0, k1] (`_q_tile_clamp`
// :164)
__device__ __forceinline__ void q_tile_range(const Problem& p, int k0, int k1,
                                             int bq, int* lo, int* hi) {
  const int nq = (p.sq + bq - 1) / bq;
  *lo = 0;
  *hi = nq;
  if (!p.causal) return;
  const int first = k0 - p.diag();  // first row that sees key k0
  *lo = first > 0 ? min(nq, first / bq) : 0;
  if (p.window > 0) {
    const int last = k1 + p.window - p.diag() - 1;  // last row that sees k1
    *hi = last < 0 ? 0 : min(nq, last / bq + 1);
  }
}

// ---------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Problem p) {
  using S = Shape<D>;
  constexpr int BK = S::BK, LD = S::LD, LS = S::LS;
  constexpr int RI = S::RI, CJ = S::CJ, CD = S::CD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = qt * kBQ;
  const int r1 = min(r0 + kBQ, p.sq) - 1;

  extern __shared__ float smem[];
  float* q_s = smem;             // [kBQ][LD]
  float* k_s = q_s + kBQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* p_s = v_s + BK * LD;    // [kBQ][LS] scores, then probabilities
  float* m_s = p_s + kBQ * LS;   // [kBQ] running max
  float* l_s = m_s + kBQ;        // [kBQ] running sum
  float* c_s = l_s + kBQ;        // [kBQ] correction of this tile

  load_tile<T, D, kBQ>(q_s, q, b, r0, p.sq, p.hq, h);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  int lo, hi;
  kv_tile_range(p, r0, r1, BK, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, BK>(k_s, k, b, k0, p.skv, p.hkv, hk);
    load_tile<T, D, BK>(v_s, v, b, k0, p.skv, p.hkv, hk);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = k_s[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        p_s[r * LS + col] =
            p.visible(r0 + r, k0 + col) ? s[i][c] * p.scale : kNegInf;
      }
    __syncthreads();

    // online softmax, one warp per row; P is rounded to V's dtype for P.V
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* sr = p_s + r * LS;
      float mt = kNegInf;
      for (int c = lane; c < BK; c += 32) mt = fmaxf(mt, sr[c]);
      mt = warp_max(mt);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mt);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float x = sr[c];
        const float e = x <= 0.5f * kNegInf ? 0.f : expf(x - m_new);
        sum += e;
        sr[c] = round_to<T>(e);
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

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = p_s[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = v_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = r0 + r;
    if (row >= p.sq) continue;
    const float l = l_s[r];
    T* o = out + ((static_cast<long long>(b) * p.sq + row) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[tx + 16 * c] = from_float<T>(l == 0.f ? 0.f : acc[i][c] / l);
  }
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int row = r0 + r;
    if (row >= p.sq) continue;
    const float l = l_s[r];
    lse[(static_cast<long long>(b) * p.hq + h) * p.sq + row] =
        l == 0.f ? -kNegInf : m_s[r] + logf(l);
  }
}

// scores S (scaled, fp32) and dP = dO.V^T of the thread's [RI][CJ] patch,
// turned into P = exp(S - lse) and dS = P (dP - delta) scale, masked to 0
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const Problem& p, const float* q_s, const float* do_s, const float* k_s,
    const float* v_s, const float* lse_s, const float* delta_s, int r0, int k0,
    int tx, int ty, float (&pr)[Shape<D>::RI][Shape<D>::CJ],
    float (&ds)[Shape<D>::RI][Shape<D>::CJ]) {
  using S = Shape<D>;
  constexpr int LD = S::LD, RI = S::RI, CJ = S::CJ;
  float s[RI][CJ], dp[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], dov[RI], kv[CJ], vv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = q_s[(ty + 16 * i) * LD + d];
      dov[i] = do_s[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      kv[c] = k_s[(tx + 16 * c) * LD + d];
      vv[c] = v_s[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const float e = p.visible(r0 + r, k0 + tx + 16 * c)
                          ? expf(s[i][c] * p.scale - lse_s[r])
                          : 0.f;
      pr[i][c] = e;
      ds[i][c] = e * (dp[i][c] - delta_s[r]) * p.scale;
    }
  }
}

// ---------------------------------------------------------------- dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_backward_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         Problem p) {
  using S = Shape<D>;
  constexpr int BK = S::BK, LD = S::LD, LS = S::LS;
  constexpr int RI = S::RI, CJ = S::CJ, CD = S::CD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = qt * kBQ;
  const int r1 = min(r0 + kBQ, p.sq) - 1;

  extern __shared__ float smem[];
  float* q_s = smem;                // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;     // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;     // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* ds_s = v_s + BK * LD;      // [kBQ][LS]
  float* lse_s = ds_s + kBQ * LS;   // [kBQ]
  float* delta_s = lse_s + kBQ;     // [kBQ]

  load_tile<T, D, kBQ>(q_s, q, b, r0, p.sq, p.hq, h);
  load_tile<T, D, kBQ>(do_s, dout, b, r0, p.sq, p.hq, h);
  load_rows(lse_s, lse, b, h, r0, p.sq, p.hq, -kNegInf);
  load_rows(delta_s, delta, b, h, r0, p.sq, p.hq, 0.f);
  float acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  int lo, hi;
  kv_tile_range(p, r0, r1, BK, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<T, D, BK>(k_s, k, b, k0, p.skv, p.hkv, hk);
    load_tile<T, D, BK>(v_s, v, b, k0, p.skv, p.hkv, hk);
    __syncthreads();
    float pr[RI][CJ], ds[RI][CJ];
    probs_and_dscores<D>(p, q_s, do_s, k_s, v_s, lse_s, delta_s, r0, k0, tx,
                         ty, pr, ds);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c)
        ds_s[(ty + 16 * i) * LS + tx + 16 * c] = round_to<T>(ds[i][c]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RI], kv[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = ds_s[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = k_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= p.sq) continue;
    T* o = dq + ((static_cast<long long>(b) * p.sq + row) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------- dk/dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_backward_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, Problem p) {
  using S = Shape<D>;
  constexpr int BK = S::BK, LD = S::LD, LS = S::LS;
  constexpr int RI = S::RI, CJ = S::CJ, CD = S::CD;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * BK;
  const int k1 = min(k0 + BK, p.skv) - 1;

  extern __shared__ float smem[];
  float* k_s = smem;                // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* q_s = v_s + BK * LD;       // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;     // [kBQ][LD]
  float* p_s = do_s + kBQ * LD;     // [kBQ][LS] P in dO's dtype
  float* ds_s = p_s + kBQ * LS;     // [kBQ][LS] dS in Q's dtype
  float* lse_s = ds_s + kBQ * LS;   // [kBQ]
  float* delta_s = lse_s + kBQ;     // [kBQ]

  load_tile<T, D, BK>(k_s, k, b, k0, p.skv, p.hkv, hk);
  load_tile<T, D, BK>(v_s, v, b, k0, p.skv, p.hkv, hk);
  // this thread's dK / dV patch: kv rows ty + 16 i, channels tx + 16 c
  float dk_acc[CJ][CD], dv_acc[CJ][CD];
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int lo, hi;
  q_tile_range(p, k0, k1, kBQ, &lo, &hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = lo; qt < hi; ++qt) {
      const int r0 = qt * kBQ;
      __syncthreads();
      load_tile<T, D, kBQ>(q_s, q, b, r0, p.sq, p.hq, h);
      load_tile<T, D, kBQ>(do_s, dout, b, r0, p.sq, p.hq, h);
      load_rows(lse_s, lse, b, h, r0, p.sq, p.hq, -kNegInf);
      load_rows(delta_s, delta, b, h, r0, p.sq, p.hq, 0.f);
      __syncthreads();
      float pr[RI][CJ], ds[RI][CJ];
      probs_and_dscores<D>(p, q_s, do_s, k_s, v_s, lse_s, delta_s, r0, k0, tx,
                           ty, pr, ds);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          const int at = (ty + 16 * i) * LS + tx + 16 * c;
          p_s[at] = round_to<T>(pr[i][c]);
          ds_s[at] = round_to<T>(ds[i][c]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over this tile's q rows
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pv[CJ], dsv[CJ], dov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < CJ; ++i) {
          pv[i] = p_s[r * LS + ty + 16 * i];
          dsv[i] = ds_s[r * LS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dov[c] = do_s[r * LD + tx + 16 * c];
          qv[c] = q_s[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < CJ; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.skv) continue;
    const long long off =
        ((static_cast<long long>(b) * p.skv + row) * p.hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[off + tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// ------------------------------------------------ tensor-core (mma.sync) path
// bf16/fp16 at head_dim 64 and 128. Four warps per block; each warp owns 16
// rows of the M side of every product and runs m16n8k16 mma.sync with fp32
// accumulators. Operands are staged in shared memory as T (rows padded by 8
// elements, so the 32-bit fragment loads of a warp hit 32 distinct banks);
// a product whose B operand runs along the other axis gets a transposed
// copy of its tile. The score tile's accumulator layout is the A operand's
// layout, so P and dS go from registers into the next product, rounded to
// T there — the rounding points of the scalar path and of the TPU kernels.
constexpr int kMmaThreads = 128;
constexpr int kMT = 64;  // q rows (forward, dq) or keys (dk/dv) per block
constexpr int kMQ = 32;  // q rows per step of the dk/dv walk

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, row-major) . b (16 x 8, col-major), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [row, row + 16) x cols [col, col + 16) of a row-major
// [.][ld] tile of T
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int ld,
                                       int row, int col) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p0 = tile + (row + g) * ld + col + 2 * t;
  a[0] = ld32(p0);
  a[1] = ld32(p0 + 8 * ld);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p0 + 8 * ld + 8);
}

// c += A . B^T for the 8 rows [n, n + 8) of a row-major [.][ld] tile B
// (k along the row, from col)
template <typename T>
__device__ __forceinline__ void mma_bt(float (&c)[4], const uint32_t (&a)[4],
                                       const T* tile, int ld, int n, int col) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const T* p0 = tile + (n + g) * ld + col + 2 * t;
  mma16816<T>(c, a, ld32(p0), ld32(p0 + 8));
}

// A fragment for the 16 columns [16 kk, 16 kk + 16) of a score tile held
// in accumulators (n tiles 2 kk and 2 kk + 1), rounded to T
template <typename T, int N>
__device__ __forceinline__ void scores_as_a(uint32_t (&a)[4],
                                            const float (&s)[N][4], int kk) {
  a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// rows [r0, r0 + R) of head h of a [b, S, H, D] tensor into a [R][LD] tile
// of T (16 bytes per copy); rows >= S read 0
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int b, int r0, int S, int H, int h) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < R * PER_ROW; i += kMmaThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * V;
    const int row = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      raw = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * S + row) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

// the same rows transposed into a [D][LD] tile: dst[c][r]
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void stage_cols(T* dst, const T* __restrict__ src,
                                           int b, int r0, int S, int H, int h) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < R * PER_ROW; i += kMmaThreads) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * V;
    const int row = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      raw = *reinterpret_cast<const uint4*>(
          src + ((static_cast<long long>(b) * S + row) * H + h) * D + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[(c + j) * LD + r] = e[j];
  }
}

// rows [r0, r0 + R) of a [b, hq, sq] fp32 row statistic; rows >= sq get fill
template <int R>
__device__ __forceinline__ void stage_stat(float* dst,
                                           const float* __restrict__ src,
                                           int b, int h, int r0, int sq,
                                           int hq, float fill) {
  for (int r = threadIdx.x; r < R; r += kMmaThreads) {
    const int row = r0 + r;
    dst[r] = row < sq ? src[(static_cast<long long>(b) * hq + h) * sq + row]
                      : fill;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_forward_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, Problem p) {
  constexpr int LD = D + 8, LT = kMT + 8, NT = kMT / 8, CD = D / 8;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first row
  const int r0 = qt * kMT;
  const int r1 = min(r0 + kMT, p.sq) - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kMT][LD]
  T* k_s = q_s + kMT * LD;                  // [kMT][LD]
  T* vt_s = k_s + kMT * LD;                 // [D][LT], V transposed

  stage_rows<T, D, kMT, LD>(q_s, q, b, r0, p.sq, p.hq, h);
  float o[CD][4];
#pragma unroll
  for (int c = 0; c < CD; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int lo, hi;
  kv_tile_range(p, r0, r1, kMT, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kMT;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D, kMT, LD>(k_s, k, b, k0, p.skv, p.hkv, hk);
    stage_cols<T, D, kMT, LT>(vt_s, v, b, k0, p.skv, p.hkv, hk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      load_a<T>(a, q_s, LD, wr, kd * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_bt<T>(s[n], a, k_s, LD, n * 8, kd * 16);
    }
    // scale and mask, then the online softmax of this thread's two rows
    // (each row's 64 scores sit in the 4 threads of a quad)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + wr + g + 8 * i;
      float mt = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + n * 8 + 2 * t + e;
          const float x =
              p.visible(row, col) ? s[n][2 * i + e] * p.scale : kNegInf;
          s[n][2 * i + e] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * i + e];
          const float ex = x <= 0.5f * kNegInf ? 0.f : expf(x - m_new);
          s[n][2 * i + e] = ex;
          sum += ex;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        o[c][2 * i] *= corr;
        o[c][2 * i + 1] *= corr;
      }
    }
    // O += P V with P rounded to V's dtype
#pragma unroll
    for (int kk = 0; kk < kMT / 16; ++kk) {
      uint32_t a[4];
      scores_as_a<T, NT>(a, s, kk);
#pragma unroll
      for (int c = 0; c < CD; ++c) mma_bt<T>(o[c], a, vt_s, LT, c * 8, kk * 16);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wr + g + 8 * i;
    if (row >= p.sq) continue;
    const float li = l[i];
    T* orow = out + ((static_cast<long long>(b) * p.sq + row) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8 + 2 * t) =
          pack2<T>(li == 0.f ? 0.f : o[c][2 * i] / li,
                   li == 0.f ? 0.f : o[c][2 * i + 1] / li);
    if (t == 0)
      lse[(static_cast<long long>(b) * p.hq + h) * p.sq + row] =
          li == 0.f ? -kNegInf : m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_backward_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, Problem p) {
  constexpr int LD = D + 8, LT = kMT + 8, NT = kMT / 8, CD = D / 8;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int r0 = qt * kMT;
  const int r1 = min(r0 + kMT, p.sq) - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kMT][LD]
  T* do_s = q_s + kMT * LD;                 // [kMT][LD]
  T* k_s = do_s + kMT * LD;                 // [kMT][LD]
  T* v_s = k_s + kMT * LD;                  // [kMT][LD]
  T* kt_s = v_s + kMT * LD;                 // [D][LT], K transposed
  float* lse_s = reinterpret_cast<float*>(kt_s + D * LT);  // [kMT]
  float* delta_s = lse_s + kMT;                            // [kMT]

  stage_rows<T, D, kMT, LD>(q_s, q, b, r0, p.sq, p.hq, h);
  stage_rows<T, D, kMT, LD>(do_s, dout, b, r0, p.sq, p.hq, h);
  stage_stat<kMT>(lse_s, lse, b, h, r0, p.sq, p.hq, -kNegInf);
  stage_stat<kMT>(delta_s, delta, b, h, r0, p.sq, p.hq, 0.f);
  float acc[CD][4];
#pragma unroll
  for (int c = 0; c < CD; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  int lo, hi;
  kv_tile_range(p, r0, r1, kMT, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kMT;
    __syncthreads();
    stage_rows<T, D, kMT, LD>(k_s, k, b, k0, p.skv, p.hkv, hk);
    stage_rows<T, D, kMT, LD>(v_s, v, b, k0, p.skv, p.hkv, hk);
    stage_cols<T, D, kMT, LT>(kt_s, k, b, k0, p.skv, p.hkv, hk);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t aq[4], ado[4];
      load_a<T>(aq, q_s, LD, wr, kd * 16);
      load_a<T>(ado, do_s, LD, wr, kd * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_bt<T>(s[n], aq, k_s, LD, n * 8, kd * 16);
        mma_bt<T>(dp[n], ado, v_s, LD, n * 8, kd * 16);
      }
    }
    // P = exp(S - lse), dS = P (dP - delta) scale, masked to 0
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + 8 * (e >> 1);
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float pr = p.visible(r0 + rl, col)
                             ? expf(s[n][e] * p.scale - lse_s[rl])
                             : 0.f;
        s[n][e] = pr * (dp[n][e] - delta_s[rl]) * p.scale;
      }
    // dQ += dS K with dS rounded to the input dtype
#pragma unroll
    for (int kk = 0; kk < kMT / 16; ++kk) {
      uint32_t a[4];
      scores_as_a<T, NT>(a, s, kk);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        mma_bt<T>(acc[c], a, kt_s, LT, c * 8, kk * 16);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wr + g + 8 * i;
    if (row >= p.sq) continue;
    T* o = dq + ((static_cast<long long>(b) * p.sq + row) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      *reinterpret_cast<uint32_t*>(o + c * 8 + 2 * t) =
          pack2<T>(acc[c][2 * i], acc[c][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_backward_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv,
                              Problem p) {
  constexpr int LD = D + 8, LQ = kMQ + 8, NQ = kMQ / 8, CD = D / 8;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // this warp's first key
  const int k0 = kt * kMT;
  const int k1 = min(k0 + kMT, p.skv) - 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kMT][LD]
  T* v_s = k_s + kMT * LD;                  // [kMT][LD]
  T* q_s = v_s + kMT * LD;                  // [kMQ][LD]
  T* do_s = q_s + kMQ * LD;                 // [kMQ][LD]
  T* qt_s = do_s + kMQ * LD;                // [D][LQ], Q transposed
  T* dot_s = qt_s + D * LQ;                 // [D][LQ], dO transposed
  float* lse_s = reinterpret_cast<float*>(dot_s + D * LQ);  // [kMQ]
  float* delta_s = lse_s + kMQ;                             // [kMQ]

  stage_rows<T, D, kMT, LD>(k_s, k, b, k0, p.skv, p.hkv, hk);
  stage_rows<T, D, kMT, LD>(v_s, v, b, k0, p.skv, p.hkv, hk);
  float dk_acc[CD][4], dv_acc[CD][4];
#pragma unroll
  for (int c = 0; c < CD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  int lo, hi;
  q_tile_range(p, k0, k1, kMQ, &lo, &hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int qt = lo; qt < hi; ++qt) {
      const int r0 = qt * kMQ;
      __syncthreads();
      stage_rows<T, D, kMQ, LD>(q_s, q, b, r0, p.sq, p.hq, h);
      stage_rows<T, D, kMQ, LD>(do_s, dout, b, r0, p.sq, p.hq, h);
      stage_cols<T, D, kMQ, LQ>(qt_s, q, b, r0, p.sq, p.hq, h);
      stage_cols<T, D, kMQ, LQ>(dot_s, dout, b, r0, p.sq, p.hq, h);
      stage_stat<kMQ>(lse_s, lse, b, h, r0, p.sq, p.hq, -kNegInf);
      stage_stat<kMQ>(delta_s, delta, b, h, r0, p.sq, p.hq, 0.f);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys x kMQ rows
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t ak[4], av[4];
        load_a<T>(ak, k_s, LD, wr, kd * 16);
        load_a<T>(av, v_s, LD, wr, kd * 16);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          mma_bt<T>(st[n], ak, q_s, LD, n * 8, kd * 16);
          mma_bt<T>(dpt[n], av, do_s, LD, n * 8, kd * 16);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + wr + g + 8 * (e >> 1);
          const int ql = n * 8 + 2 * t + (e & 1);
          const float pr = p.visible(r0 + ql, key)
                               ? expf(st[n][e] * p.scale - lse_s[ql])
                               : 0.f;
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - delta_s[ql]) * p.scale;
        }
      // dV += P^T dO (P in dO's dtype), dK += dS^T Q (dS in Q's dtype)
#pragma unroll
      for (int kk = 0; kk < kMQ / 16; ++kk) {
        uint32_t ap[4], ads[4];
        scores_as_a<T, NQ>(ap, st, kk);
        scores_as_a<T, NQ>(ads, dpt, kk);
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          mma_bt<T>(dv_acc[c], ap, dot_s, LQ, c * 8, kk * 16);
          mma_bt<T>(dk_acc[c], ads, qt_s, LQ, c * 8, kk * 16);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wr + g + 8 * i;
    if (row >= p.skv) continue;
    const long long off =
        ((static_cast<long long>(b) * p.skv + row) * p.hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      *reinterpret_cast<uint32_t*>(dk + off + c * 8 + 2 * t) =
          pack2<T>(dk_acc[c][2 * i], dk_acc[c][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + c * 8 + 2 * t) =
          pack2<T>(dv_acc[c][2 * i], dv_acc[c][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <int D>
size_t forward_smem() {
  using S = Shape<D>;
  return sizeof(float) * (kBQ * S::LD + 2 * S::BK * S::LD + kBQ * S::LS +
                          3 * kBQ);
}
template <int D>
size_t dq_smem() {
  using S = Shape<D>;
  return sizeof(float) * (2 * kBQ * S::LD + 2 * S::BK * S::LD +
                          kBQ * S::LS + 2 * kBQ);
}
template <int D>
size_t dkv_smem() {
  using S = Shape<D>;
  return sizeof(float) * (2 * S::BK * S::LD + 2 * kBQ * S::LD +
                          2 * kBQ * S::LS + 2 * kBQ);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

enum class Which { kForward, kDq, kDkv };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out, *dk, *dv;
  float* lse_out;
  int b;
};

// bf16/fp16 at head_dim 64 and 128 take the tensor-core kernels
template <typename T, int D>
struct UseMma {
  static constexpr bool value = D <= 128;
};
template <int D>
struct UseMma<float, D> {
  static constexpr bool value = false;
};

template <typename T, int D>
size_t forward_mma_smem() {
  return sizeof(T) * (2 * kMT * (D + 8) + D * (kMT + 8));
}
template <typename T, int D>
size_t dq_mma_smem() {
  return sizeof(T) * (4 * kMT * (D + 8) + D * (kMT + 8)) +
         sizeof(float) * 2 * kMT;
}
template <typename T, int D>
size_t dkv_mma_smem() {
  return sizeof(T) * (2 * kMT * (D + 8) + 2 * kMQ * (D + 8) +
                      2 * D * (kMQ + 8)) +
         sizeof(float) * 2 * kMQ;
}

// one launch, after raising the dynamic shared-memory limit if needed
template <typename Kernel, typename... KArgs>
int go(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
       KArgs... args) {
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return 0;
}

static_assert(kMT == kBQ, "the q grid is shared by both paths");

template <typename T, int D>
int launch(Which which, const Args& a, const Problem& p, cudaStream_t s) {
  constexpr bool mma = UseMma<T, D>::value;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* out = static_cast<T*>(a.out);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const dim3 q_grid((p.sq + kBQ - 1) / kBQ, p.hq, a.b);
  const int kv_rows = mma ? kMT : Shape<D>::BK;
  const dim3 kv_grid((p.skv + kv_rows - 1) / kv_rows, p.hkv, a.b);
  int err = 0;
  switch (which) {
    case Which::kForward:
      if constexpr (mma)
        err = go(flash_forward_mma_kernel<T, D>, q_grid, kMmaThreads,
                 forward_mma_smem<T, D>(), s, q, k, v, out, a.lse_out, p);
      else
        err = go(flash_forward_kernel<T, D>, q_grid, kThreads,
                 forward_smem<D>(), s, q, k, v, out, a.lse_out, p);
      break;
    case Which::kDq:
      if constexpr (mma)
        err = go(flash_backward_dq_mma_kernel<T, D>, q_grid, kMmaThreads,
                 dq_mma_smem<T, D>(), s, q, k, v, dout, a.lse_in, a.delta,
                 out, p);
      else
        err = go(flash_backward_dq_kernel<T, D>, q_grid, kThreads,
                 dq_smem<D>(), s, q, k, v, dout, a.lse_in, a.delta, out, p);
      break;
    case Which::kDkv:
      if constexpr (mma)
        err = go(flash_backward_dkv_mma_kernel<T, D>, kv_grid, kMmaThreads,
                 dkv_mma_smem<T, D>(), s, q, k, v, dout, a.lse_in, a.delta,
                 dk, dv, p);
      else
        err = go(flash_backward_dkv_kernel<T, D>, kv_grid, kThreads,
                 dkv_smem<D>(), s, q, k, v, dout, a.lse_in, a.delta, dk, dv,
                 p);
      break;
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(Which which, const Args& a, const Problem& p, int d,
             cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(which, a, p, s);
    case 128:
      return launch<T, 128>(which, a, p, s);
    default:
      return launch<T, 256>(which, a, p, s);
  }
}

int dispatch(Which which, const Args& a, int sq, int skv, int hq, int hkv,
             int d, int causal, int window, float scale, int dtype,
             void* stream) {
  if (a.b < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv != 0 ||
      !(d == 64 || d == 128 || d == 256) || dtype < 0 || dtype > 2 ||
      window < 0 || (window > 0 && !causal) || a.b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{sq, skv, hq, hkv, causal ? 1 : 0, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(which, a, p, d, s);
    case 1:
      return launch_d<__half>(which, a, p, d, s);
    default:
      return launch_d<__nv_bfloat16>(which, a, p, d, s);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = fp16, 2 = bf16. Each returns a cudaError_t value
// (0 = ok), launches on `stream` and does not synchronise. Pointers are
// contiguous, 16-byte aligned tensors in the layouts of the header.
extern "C" int dst_flash_forward(const void* q, const void* k, const void* v,
                                 void* out, float* lse, int b, int sq, int skv,
                                 int hq, int hkv, int d, int causal,
                                 int window, float scale, int dtype,
                                 void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, nullptr, lse, b};
  return dispatch(Which::kForward, a, sq, skv, hq, hkv, d, causal, window,
                  scale, dtype, stream);
}

extern "C" int dst_flash_backward_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int b, int sq, int skv, int hq,
                                     int hkv, int d, int causal, int window,
                                     float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, b};
  return dispatch(Which::kDq, a, sq, skv, hq, hkv, d, causal, window, scale,
                  dtype, stream);
}

extern "C" int dst_flash_backward_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr, b};
  return dispatch(Which::kDkv, a, sq, skv, hq, hkv, d, causal, window, scale,
                  dtype, stream);
}

extern "C" const char* dst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused matmul kernels of the compressed collectives, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/fused_collectives.py:
//   dequant_matmul   (`_dequant_matmul_kernel`, pallas_call :122)
//   matmul_pallas    (`_matmul_kernel`, pallas_call :156)
//   matmul_quantize  (`_matmul_quantize_kernel`, pallas_call :239)
// Same functions as the plain PyTorch versions in
// deepspeed_tpu_torch/ops/fused_collectives.py:
//
//   matmul:          out[m, n] = sum_k A[m, k] * B[k, n] in fp32
//   dequant_matmul:  B[k, n] = to_T(float(q[k*n + j]) * scale[(k*n + j) /
//                    block]), q int8 or int4 nibbles (pack_int4 layout:
//                    two's complement, element 2i in the low nibble), then
//                    the matmul; the dequantized tile is bitwise the plain
//                    dequantize_blockwise's
//   matmul_quantize: the matmul (A = a or a^T with `trans_a`), then each
//                    block of `block` consecutive row-major elements of the
//                    fp32 product quantized with quant.cu's arithmetic:
//                    scale = absmax / qmax (IEEE), 0 -> 1;
//                    q = clamp(rint(x / scale), -qmax-1, qmax); int4 packed.
//
// Rounding contract: every output element is one fp32 accumulation over the
// FULL contraction, in k order (16-wide mma steps for bf16/fp16, one fmaf
// per k for fp32, never TF32), with no split-K. So an element's value does
// not depend on the m/n tiling, two runs are bitwise equal, and the
// quantize epilogue sees exactly the matmul kernel's product.
//
// What bounds them on the H100: at the ZeRO-3 path's shapes (m 2048, k 4096,
// n 5504 / 11008, bf16) the tensor-core operations, ~93-185 GFLOP against
// ~85 MB. Design, simple and right first: a 256-thread block owns a 128 x
// 128 output tile (64 x 256 for the quantize epilogue, so that a block owns
// whole 256-wide quantization blocks); each of its 8 warps owns a 32 x 64
// piece and runs mma.sync m16n8k16 with fp32 accumulators over 32-deep k
// steps staged in shared memory: A row-major (or a^T as it lies, for
// `trans_a`), B row-major, rows padded by 8 elements, fragments by 32-bit
// loads or ldmatrix .trans. Staging uses 16-byte loads where rows split
// into aligned 8-element pieces, else single elements. The weight is
// dequantized while it is staged (the prologue: 8 payload values, one
// scale, one 16-byte store). fp32 operands take a 256-thread scalar-FMA
// kernel. The quantize epilogue writes the fp32 tile to shared memory and
// gives each (row, block) to a warp: shuffle absmax, IEEE divide, rintf,
// pack. A block that does not divide 256 or the row length takes a second
// pass in this file (matmul to an fp32 scratch, then the quantize kernel).
// Later work: cp.async / TMA double buffering, wgmma, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;        // output rows per block, fp32
constexpr int kBKh = 32;       // k per stage, bf16/fp16
constexpr int kBKf = 16;       // k per stage, fp32
constexpr int kQuantBN = 256;  // columns per block of the quantize epilogue

enum BMode { kDense = 0, kInt8 = 1, kInt4 = 2 };

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

// the operands of one product: A is a [m, k] (or a [k, m] read transposed),
// B is b [k, n] or the quantized payload of a [k, n] weight
template <typename T>
struct Operands {
  const T* a;
  const void* b;        // T, int8 or packed int4
  const float* scales;  // dequantize: one per `block` flat elements of B
  int m, n, k;
  int block;
};

template <typename T, int MODE>
__device__ __forceinline__ T load_b(const Operands<T>& op, int kk, int j) {
  const long long f = static_cast<long long>(kk) * op.n + j;
  if constexpr (MODE == kDense) return static_cast<const T*>(op.b)[f];
  int q;
  if constexpr (MODE == kInt8) {
    q = static_cast<const int8_t*>(op.b)[f];
  } else {
    const int byte = static_cast<const uint8_t*>(op.b)[f >> 1];
    const int nib = (f & 1) ? (byte >> 4) : (byte & 0xF);
    q = nib >= 8 ? nib - 16 : nib;
  }
  // float(q) * scale in fp32, then one rounding to T: the plain dequantize
  return from_float<T>(static_cast<float>(q) * op.scales[f / op.block]);
}

template <typename T, bool TRANS_A>
__device__ __forceinline__ T load_a(const Operands<T>& op, int i, int kk) {
  return TRANS_A ? op.a[static_cast<long long>(kk) * op.m + i]
                 : op.a[static_cast<long long>(i) * op.k + kk];
}

// ------------------------------------------------------------ epilogues
struct Store {
  float* out;
  int ldo;
};

struct Quant {
  void* payload;  // int8 [rows, block] or uint8 [rows, block / 2]
  float* scales;  // [rows]
  int bits, block;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int quant_one(float x, float scale, float qmax) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(r, -qmax - 1.f), qmax));
}

// quantize the `block` fp32 values at x as quantization row `row`, by one
// warp
__device__ __forceinline__ void quantize_row(const float* x, long long row,
                                             const Quant& q) {
  const int lane = threadIdx.x & 31;
  const float qmax = static_cast<float>((1 << (q.bits - 1)) - 1);
  const int pairs = q.block / 2;
  float amax = 0.f;
  for (int p = lane; p < pairs; p += 32)
    amax = fmaxf(amax, fmaxf(fabsf(x[2 * p]), fabsf(x[2 * p + 1])));
  amax = warp_max(amax);
  float s = __fdiv_rn(amax, qmax);
  if (s == 0.f) s = 1.f;
  if (lane == 0) q.scales[row] = s;
  if (q.bits == 4) {
    uint8_t* out = static_cast<uint8_t*>(q.payload) + row * pairs;
    for (int p = lane; p < pairs; p += 32) {
      const int lo = quant_one(x[2 * p], s, qmax) & 0xF;
      const int hi = quant_one(x[2 * p + 1], s, qmax) & 0xF;
      out[p] = static_cast<uint8_t>(lo | (hi << 4));
    }
  } else {
    int8_t* out = static_cast<int8_t*>(q.payload) + row * q.block;
    for (int p = lane; p < pairs; p += 32) {
      out[2 * p] = static_cast<int8_t>(quant_one(x[2 * p], s, qmax));
      out[2 * p + 1] = static_cast<int8_t>(quant_one(x[2 * p + 1], s, qmax));
    }
  }
}

// the block's fp32 output tile ctile [BM][BN + 4] -> whole quantization
// blocks (the launcher guarantees block | BN and block | n)
template <int BM, int BN, int THREADS>
__device__ void quantize_tile(const float* ctile, int m0, int n0, int m,
                              int n, const Quant& q) {
  const int warp = threadIdx.x >> 5;
  const int segs = BN / q.block;
  for (int t = warp; t < BM * segs; t += THREADS / 32) {
    const int r = t / segs, c = (t - r * segs) * q.block;
    if (m0 + r >= m || n0 + c >= n) continue;
    const long long row =
        (static_cast<long long>(m0 + r) * n + n0 + c) / q.block;
    quantize_row(ctile + r * (BN + 4) + c, row, q);
  }
}

// ---------------------------------------------------- tensor-core path
__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices, transposed: lane l gives the row address of
// matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

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

// Tile shapes of the tensor-core kernel: a block of WM x WN warps owns a
// BM x BN output tile; each warp a (BM / WM) x (BN / WN) piece of it.
template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;  // m16 tiles per warp
  static constexpr int NT = BN / WN / 8;   // n8 tiles per warp
  static constexpr int LDA = kBKh + 8;     // As [BM][LDA] (a row-major)
  static constexpr int LDAT = BM + 8;      // As [kBKh][LDAT] (a^T staged)
  static constexpr int LDB = BN + 8;       // Bs [kBKh][LDB]
};
using PlainTile = Tile<128, 128, 4, 2>;
using QuantTile = Tile<64, kQuantBN, 2, 4>;

// 8 consecutive B values of row kk from column j (j % 8 == 0, all in
// bounds) as 16 bytes of T: a vector load, or a dequantize of 8 (int8) or
// 4 (int4) payload bytes with one scale (block % 8 == 0)
template <typename T, int MODE>
__device__ __forceinline__ uint4 load_b8(const Operands<T>& op, int kk,
                                         int j) {
  const long long f = static_cast<long long>(kk) * op.n + j;
  if constexpr (MODE == kDense) {
    return *reinterpret_cast<const uint4*>(static_cast<const T*>(op.b) + f);
  } else {
    const float s = op.scales[f / op.block];
    int q[8];
    if constexpr (MODE == kInt8) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(op.b) + f);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = v[e];
    } else {
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(op.b) + (f >> 1));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int nib = (raw >> (4 * e)) & 0xF;
        q[e] = nib >= 8 ? nib - 16 : nib;
      }
    }
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = from_float<T>(static_cast<float>(q[e]) * s);
    return out;
  }
}

// Stage one 32-deep k step. VEC: 16-byte loads (the launcher checked
// alignment and divisibility); else one element at a time. Out of range
// reads 0. A: As[r][c] = A[m0 + r][k0 + c]; with TRANS_A, AsT[c][r] (the
// layout of a [k, m]). B: Bs[c][j] = B[k0 + c][n0 + j].
template <typename T, typename TL, bool TRANS_A, int MODE, bool VEC>
__device__ __forceinline__ void stage(const Operands<T>& op, T* As, T* Bs,
                                      int m0, int n0, int k0) {
  const T zero = from_float<T>(0.f);
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (TRANS_A) {
    if constexpr (VEC) {
      for (int idx = threadIdx.x; idx < kBKh * TL::BM / 8;
           idx += TL::THREADS) {
        const int c = idx / (TL::BM / 8), r = (idx % (TL::BM / 8)) * 8;
        const int gk = k0 + c, gi = m0 + r;
        *reinterpret_cast<uint4*>(As + c * TL::LDAT + r) =
            (gk < op.k && gi < op.m)
                ? *reinterpret_cast<const uint4*>(
                      op.a + static_cast<long long>(gk) * op.m + gi)
                : z4;
      }
    } else {
      for (int idx = threadIdx.x; idx < kBKh * TL::BM; idx += TL::THREADS) {
        const int c = idx / TL::BM, r = idx % TL::BM;
        const int gk = k0 + c, gi = m0 + r;
        As[c * TL::LDAT + r] =
            (gk < op.k && gi < op.m) ? load_a<T, true>(op, gi, gk) : zero;
      }
    }
  } else {
    if constexpr (VEC) {
      for (int idx = threadIdx.x; idx < TL::BM * kBKh / 8;
           idx += TL::THREADS) {
        const int r = idx / (kBKh / 8), c = (idx % (kBKh / 8)) * 8;
        const int gi = m0 + r, gk = k0 + c;
        *reinterpret_cast<uint4*>(As + r * TL::LDA + c) =
            (gi < op.m && gk < op.k)
                ? *reinterpret_cast<const uint4*>(
                      op.a + static_cast<long long>(gi) * op.k + gk)
                : z4;
      }
    } else {
      for (int idx = threadIdx.x; idx < TL::BM * kBKh; idx += TL::THREADS) {
        const int r = idx / kBKh, c = idx % kBKh;
        const int gi = m0 + r, gk = k0 + c;
        As[r * TL::LDA + c] =
            (gi < op.m && gk < op.k) ? load_a<T, false>(op, gi, gk) : zero;
      }
    }
  }
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < kBKh * TL::BN / 8; idx += TL::THREADS) {
      const int c = idx / (TL::BN / 8), j = (idx % (TL::BN / 8)) * 8;
      const int gk = k0 + c, gj = n0 + j;
      *reinterpret_cast<uint4*>(Bs + c * TL::LDB + j) =
          (gk < op.k && gj < op.n) ? load_b8<T, MODE>(op, gk, gj) : z4;
    }
  } else {
    for (int idx = threadIdx.x; idx < kBKh * TL::BN; idx += TL::THREADS) {
      const int c = idx / TL::BN, j = idx % TL::BN;
      const int gk = k0 + c, gj = n0 + j;
      Bs[c * TL::LDB + j] =
          (gk < op.k && gj < op.n) ? load_b<T, MODE>(op, gk, gj) : zero;
    }
  }
}

template <typename TL, bool TRANS_A>
__host__ __device__ constexpr int a_stage_elems() {
  return TRANS_A ? kBKh * TL::LDAT : TL::BM * TL::LDA;
}

// A block owns the BM x BN output tile at (blockIdx.y, blockIdx.x) and
// walks the whole contraction in 32-deep steps staged in shared memory;
// each warp multiplies its piece with mma.sync m16n8k16 (fp32
// accumulators). A fragments: 32-bit loads from row-major As, or ldmatrix
// .trans from the staged a^T; B fragments: ldmatrix .trans from the
// row-major Bs (rows padded by 8 elements, so the eight row addresses of
// a matrix fall in distinct banks).
template <typename T, typename TL, bool TRANS_A, int MODE, bool QUANT,
          bool VEC>
__global__ void __launch_bounds__(TL::THREADS)
mma_kernel(Operands<T> op, Store st, Quant qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + a_stage_elems<TL, TRANS_A>();
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / TL::WN) * (TL::BM / TL::WM);
  const int wn0 = (warp % TL::WN) * (TL::BN / TL::WN);
  const int g = lane >> 2, t = lane & 3;
  float acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // ldmatrix row of this lane within its 8x8 matrix, and which matrix
  const int lr = lane & 7, lm = lane >> 3;

  for (int k0 = 0; k0 < op.k; k0 += kBKh) {
    stage<T, TL, TRANS_A, MODE, VEC>(op, As, Bs, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKh; kk += 16) {
      uint32_t af[TL::MT][4];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt) {
        const int r = wm0 + 16 * mt;
        if constexpr (TRANS_A) {
          // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
          // (m 8-15, k 8-15): rows of a^T are k
          ldsm_x4_t(af[mt], As + (kk + (lm >> 1) * 8 + lr) * TL::LDAT + r +
                                (lm & 1) * 8);
        } else {
          const T* pa = As + (r + g) * TL::LDA + kk + 2 * t;
          af[mt][0] = ld32(pa);
          af[mt][1] = ld32(pa + 8 * TL::LDA);
          af[mt][2] = ld32(pa + 8);
          af[mt][3] = ld32(pa + 8 * TL::LDA + 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < TL::NT; nt += 2) {
        // matrices (k 0-7, n), (k 8-15, n), (k 0-7, n+8), (k 8-15, n+8)
        uint32_t bf[4];
        ldsm_x4_t(bf, Bs + (kk + (lm & 1) * 8 + lr) * TL::LDB + wn0 + 8 * nt +
                          (lm >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt) {
          mma16816<T>(acc[mt][nt], af[mt], bf[0], bf[1]);
          mma16816<T>(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (QUANT) {
    float* ctile = reinterpret_cast<float*>(smem);  // staging is done
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int r = wm0 + 16 * mt + g, c = wn0 + 8 * nt + 2 * t;
        ctile[r * (TL::BN + 4) + c] = acc[mt][nt][0];
        ctile[r * (TL::BN + 4) + c + 1] = acc[mt][nt][1];
        ctile[(r + 8) * (TL::BN + 4) + c] = acc[mt][nt][2];
        ctile[(r + 8) * (TL::BN + 4) + c + 1] = acc[mt][nt][3];
      }
    __syncthreads();
    quantize_tile<TL::BM, TL::BN, TL::THREADS>(ctile, m0, n0, op.m, op.n, qt);
  } else {
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int c = n0 + wn0 + 8 * nt + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm0 + 16 * mt + g + 8 * h;
          if (row >= op.m) continue;
          float* o = st.out + static_cast<long long>(row) * st.ldo;
          if (c < op.n) o[c] = acc[mt][nt][2 * h];
          if (c + 1 < op.n) o[c + 1] = acc[mt][nt][2 * h + 1];
        }
      }
  }
}

// ------------------------------------------------------- fp32 FMA path
constexpr int kFmaThreads = 256;

// As [kBKf][kBM] (k-major), Bs [kBKf][BN]; thread (tx, ty) of a 16 x 16
// grid owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < BN / 16)
template <int BN, bool TRANS_A, int MODE, bool QUANT>
__global__ void __launch_bounds__(kFmaThreads)
fma_kernel(Operands<float> op, Store st, Quant qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kBKf * kBM;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int TN = BN / 16;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < op.k; k0 += kBKf) {
    for (int idx = threadIdx.x; idx < kBM * kBKf; idx += kFmaThreads) {
      int r, c;
      if (TRANS_A) {
        c = idx / kBM;
        r = idx - c * kBM;
      } else {
        r = idx / kBKf;
        c = idx - r * kBKf;
      }
      const int gi = m0 + r, gk = k0 + c;
      As[c * kBM + r] = (gi < op.m && gk < op.k)
                            ? load_a<float, TRANS_A>(op, gi, gk) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BN * kBKf; idx += kFmaThreads) {
      const int c = idx / BN, j = idx - c * BN;
      const int gj = n0 + j, gk = k0 + c;
      Bs[c * BN + j] =
          (gj < op.n && gk < op.k) ? load_b<float, MODE>(op, gk, gj) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKf; ++kk) {
      float av[4], bv[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * kBM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (QUANT) {
    float* ctile = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        ctile[(ty + 16 * i) * (BN + 4) + tx + 16 * j] = acc[i][j];
    __syncthreads();
    quantize_tile<kBM, BN, kFmaThreads>(ctile, m0, n0, op.m, op.n, qt);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= op.m) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < op.n) st.out[static_cast<long long>(row) * st.ldo + col] = acc[i][j];
      }
    }
  }
}

// second pass of matmul_quantize: quantization rows of a flat fp32 product,
// a warp per row
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ x, long long rows, Quant q) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  quantize_row(x + row * q.block, row, q);
}

// ------------------------------------------------------------ launchers
template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, typename TL, bool TRANS_A, bool QUANT>
size_t mma_smem() {
  const size_t stage = (a_stage_elems<TL, TRANS_A>() +
                        static_cast<size_t>(kBKh) * TL::LDB) * sizeof(T);
  const size_t tile = QUANT ? static_cast<size_t>(TL::BM) * (TL::BN + 4) * 4
                            : 0;
  return stage > tile ? stage : tile;
}

template <int BN, bool QUANT>
size_t fma_smem() {
  const size_t stage = static_cast<size_t>(kBKf) * (kBM + BN) * 4;
  const size_t tile = QUANT ? static_cast<size_t>(kBM) * (BN + 4) * 4 : 0;
  return stage > tile ? stage : tile;
}

template <typename T, typename TL, bool TRANS_A, int MODE, bool QUANT,
          bool VEC>
int launch_mma_tile(const Operands<T>& op, Store st, Quant qt,
                    cudaStream_t s) {
  auto kernel = mma_kernel<T, TL, TRANS_A, MODE, QUANT, VEC>;
  const size_t bytes = mma_smem<T, TL, TRANS_A, QUANT>();
  int err = set_smem(kernel, bytes);
  if (err) return err;
  dim3 grid((op.n + TL::BN - 1) / TL::BN, (op.m + TL::BM - 1) / TL::BM);
  kernel<<<grid, TL::THREADS, bytes, s>>>(op, st, qt);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 16-byte staging when every row of A and B splits into whole aligned
// 8-element pieces (and a dequantized piece shares one scale)
template <typename T, bool TRANS_A, int MODE>
bool vec_ok(const Operands<T>& op) {
  const int b_align = MODE == kDense ? 16 : MODE == kInt8 ? 8 : 4;
  return (TRANS_A ? op.m : op.k) % 8 == 0 && op.n % 8 == 0 &&
         aligned(op.a, 16) && aligned(op.b, b_align) &&
         (MODE == kDense || op.block % 8 == 0);
}

template <typename T, bool TRANS_A, int MODE, bool QUANT>
int launch_mma(const Operands<T>& op, Store st, Quant qt, cudaStream_t s) {
  using TL = typename std::conditional<QUANT, QuantTile, PlainTile>::type;
  return vec_ok<T, TRANS_A, MODE>(op)
      ? launch_mma_tile<T, TL, TRANS_A, MODE, QUANT, true>(op, st, qt, s)
      : launch_mma_tile<T, TL, TRANS_A, MODE, QUANT, false>(op, st, qt, s);
}

template <int BN, bool TRANS_A, int MODE, bool QUANT>
int launch_fma(const Operands<float>& op, Store st, Quant qt, cudaStream_t s) {
  auto kernel = fma_kernel<BN, TRANS_A, MODE, QUANT>;
  const size_t bytes = fma_smem<BN, QUANT>();
  int err = set_smem(kernel, bytes);
  if (err) return err;
  dim3 grid((op.n + BN - 1) / BN, (op.m + kBM - 1) / kBM);
  kernel<<<grid, kFmaThreads, bytes, s>>>(op, st, qt);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 fp32, 1 fp16, 2 bf16; BN is the fp32 kernel's tile width
template <int BN, bool TRANS_A, int MODE, bool QUANT>
int dispatch(int dtype, const void* a, const void* b, const float* scales,
             int m, int n, int k, int block, Store st, Quant qt,
             cudaStream_t s) {
  switch (dtype) {
    case 0: {
      Operands<float> op{static_cast<const float*>(a), b, scales, m, n, k,
                         block};
      return launch_fma<BN, TRANS_A, MODE, QUANT>(op, st, qt, s);
    }
    case 1: {
      Operands<__half> op{static_cast<const __half*>(a), b, scales, m, n, k,
                          block};
      return launch_mma<__half, TRANS_A, MODE, QUANT>(op, st, qt, s);
    }
    case 2: {
      Operands<__nv_bfloat16> op{static_cast<const __nv_bfloat16*>(a), b,
                                 scales, m, n, k, block};
      return launch_mma<__nv_bfloat16, TRANS_A, MODE, QUANT>(op, st, qt, s);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad(int m, int n, int k, int dtype) {
  return m < 0 || n < 0 || k < 0 || dtype < 0 || dtype > 2;
}

}  // namespace

// out[m, ldo] (first n columns) = a[m, k] @ b[k, n], fp32 accumulation.
// Returns a cudaError_t value (0 = ok); launches on `stream`, no sync.
extern "C" int dst_fc_matmul(const void* a, const void* b, float* out, int m,
                             int n, int k, int ldo, int dtype, void* stream) {
  if (bad(m, n, k, dtype) || ldo < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  return dispatch<64, false, kDense, false>(
      dtype, a, b, nullptr, m, n, k, 1, Store{out, ldo}, Quant{},
      static_cast<cudaStream_t>(stream));
}

// out[m, ldo] (first n columns) = h[m, k] @ dequant(payload, scales)[k, n]:
// payload int8 [k*n] (bits 8) or packed uint8 [k*n/2] (bits 4), scales fp32
// [k*n/block]; the weight is dequantized to h's dtype.
extern "C" int dst_fc_dequant_matmul(const void* h, const void* payload,
                                     const float* scales, float* out, int m,
                                     int n, int k, int ldo, int bits,
                                     int block, int dtype, void* stream) {
  if (bad(m, n, k, dtype) || ldo < n || (bits != 4 && bits != 8) ||
      block < 2 || block % 2 ||
      (static_cast<long long>(k) * n) % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Store st{out, ldo};
  if (bits == 8)
    return dispatch<64, false, kInt8, false>(dtype, h, payload, scales, m, n,
                                             k, block, st, Quant{}, s);
  return dispatch<64, false, kInt4, false>(dtype, h, payload, scales, m, n, k,
                                           block, st, Quant{}, s);
}

// (payload, scales) of the blockwise quantization of A @ b, A = a [rows, k]
// or, with trans_a, a [k, rows] read transposed; b [k, n]. `scratch` (fp32
// [rows, n]) is used, and must be given, only when the block does not divide
// 256 and n: then the product goes there and a second pass quantizes it.
extern "C" int dst_fc_matmul_quantize(const void* a, const void* b,
                                      void* payload, float* scales,
                                      float* scratch, int rows, int n, int k,
                                      int trans_a, int bits, int block,
                                      int dtype, void* stream) {
  if (bad(rows, n, k, dtype) || (bits != 4 && bits != 8) || block < 2 ||
      block % 2 || (static_cast<long long>(rows) * n) % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Quant qt{payload, scales, bits, block};
  if (kQuantBN % block == 0 && n % block == 0) {
    return trans_a
        ? dispatch<kQuantBN, true, kDense, true>(dtype, a, b, nullptr, rows,
                                                 n, k, block, Store{}, qt, s)
        : dispatch<kQuantBN, false, kDense, true>(dtype, a, b, nullptr, rows,
                                                  n, k, block, Store{}, qt, s);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Store st{scratch, n};
  int err = trans_a
      ? dispatch<64, true, kDense, false>(dtype, a, b, nullptr, rows, n, k, 1,
                                          st, Quant{}, s)
      : dispatch<64, false, kDense, false>(dtype, a, b, nullptr, rows, n, k, 1,
                                           st, Quant{}, s);
  if (err) return err;
  const long long qrows = static_cast<long long>(rows) * n / block;
  const long long grid = (qrows + 7) / 8;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<<<static_cast<unsigned>(grid), 256, 0, s>>>(
      scratch, qrows, qt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dst_fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

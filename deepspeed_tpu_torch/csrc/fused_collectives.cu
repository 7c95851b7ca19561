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
// FULL contraction, in k order (16-wide mma / wgmma steps for bf16/fp16,
// one fmaf per k for fp32, never TF32), with no split-K. So an element's
// value does not depend on the m/n tiling or the output's row stride, two
// runs are bitwise equal, integer-valued operands give the exact product,
// and the quantize epilogue sees exactly the matmul kernel's product.
//
// What bounds them on the H100: at the ZeRO-3 path's shapes (m 2048, k 4096,
// n 5504 for rows 7/8; row 9's a^T [4096, 2048] x g [2048, 11008] -> int4)
// the tensor-core operations, ~93-185 GFLOP against ~61-85 MB. Row 9's
// quantize adds ~10 fp32 operations (an IEEE divide, rint, clamp, pack) an
// element, 0.45 G on the CUDA cores, and 22.5 MB of payload. Two designs:
// - The Hopper kernel (namespace hop) takes the bf16/fp16 products whose
//   operands TMA can read (16-byte aligned bases and row strides; see
//   `wgmma_ok` and `wgmma_quantize_ok`): a 384-thread block owns a 128 x
//   256 output tile; warp 0 keeps TMA loads of 64-deep stages in flight
//   into a ring of shared memory (128-byte swizzle, mbarriers); for
//   dequant_matmul warps 1-3 dequantize the raw payload stage into the
//   bf16/fp16 B stage; two consumer warpgroups run wgmma m64n256k16 with
//   fp32 accumulators in registers. Rows 7/8 store the accumulators
//   straight to `out`. Row 9's a^T is read as the [k, m] array lies: its
//   boxes are M-major and wgmma reads them through the transpose bit of A,
//   so nothing is staged transposed. Row 9 quantizes in the consumers'
//   registers, so the fp32 product never leaves them: a row's 256 columns
//   lie in one quad of a warp, a block's absmax is the thread's part and
//   two shuffles; the payload bytes of a row, scattered over the quad
//   (int4 byte 4 j + q from lane q), are gathered by a quad transpose of
//   shuffles into whole 16-byte pieces, one vector store each. Shuffles,
//   not a staging buffer: the ring's stages are free only once both
//   consumer warpgroups are done, and each warpgroup finishes on its own.
//   Its grid walks the m tiles first, so a wave shares B panels and all of
//   a^T stays in L2. The section below says more.
// - The mma.sync tile loop takes the rest of the 16-bit products: a
//   256-thread block owns a 128 x 128 output tile (64 x 256 for the
//   quantize epilogue, so that a block owns whole 256-wide quantization
//   blocks); each of its 8 warps owns a 32 x 64 piece and runs mma.sync
//   m16n8k16 with fp32 accumulators over 32-deep k steps staged in shared
//   memory: A row-major (or a^T as it lies, for `trans_a`), B row-major,
//   rows padded by 8 elements, fragments by 32-bit loads or ldmatrix
//   .trans. Staging uses 16-byte loads where rows split into aligned
//   8-element pieces, else single elements. The weight is dequantized
//   while it is staged (the prologue: 8 payload values, one scale, one
//   16-byte store). The quantize epilogue writes the fp32 tile to shared
//   memory and gives each (row, block) to a warp: shuffle absmax, IEEE
//   divide, rintf, pack. A block that does not divide 256 or the row
//   length takes a second pass in this file (matmul to an fp32 scratch,
//   then the quantize kernel).
// fp32 operands take a 256-thread scalar-FMA kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors, tensor maps

namespace {

using namespace hopper;

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

// ------------------------------------------- Hopper path: TMA + wgmma
// The bf16/fp16 products of dequant_matmul, matmul_pallas and
// matmul_quantize. A block of three warpgroups owns a BM x BN output tile
// and walks the whole contraction in 64-deep stages held in a ring of
// shared memory:
// - warp 0 is the producer: one thread issues the TMA loads of A (box 64 x
//   128, 128-byte swizzle, K-major for wgmma; for row 9's a^T two boxes of
//   64 k rows x 64 m of the [k, m] array, M-major: wgmma's transpose bit
//   for A) and of B (four boxes of 64 n x 64 k rows, 128-byte swizzle,
//   N-major: wgmma's transpose bit) or, for row 7, of the raw payload tile
//   (int8 64 x 256, packed int4 64 x 128 bytes, no swizzle);
// - for row 7, warps 1-3 are the converter: they dequantize the payload
//   stage into the swizzled B stage with load_b8's arithmetic, then fence
//   the generic proxy against the async one before they tell the
//   consumers. Each thread loads its pieces' scales a stage ahead, and
//   the payload of half its rows before it converts them: with one
//   converter warp a scheduler, the loads' latency, not the arithmetic,
//   sets its pace;
// - warpgroups 1 and 2 are the consumers, 64 rows of the tile each:
//   wgmma.mma_async m64n256k16 with fp32 accumulators in registers, one
//   wgmma group left in flight while the next stage is waited for; the
//   epilogue stores the accumulators straight to `out` at row stride
//   `ldo`, masking the ragged m and n edges, or (row 9) quantizes them
//   where they lie: quantize_rows.
// TMA fills zeros past the edges of A, B and the payload (whose scale is
// then 0), so a ragged k adds +0. Barriers per stage: full (A, and dense
// B, landed), pfull (payload landed), bready (the converter wrote B) and
// empty (both consumers are done with the stage: its A, B and payload are
// free). BM x BN = 128 x 256 (a 256 x 128 tile, two m64n128 a consumer,
// would halve the dequantize work per product, but ptxas spilled it).
// A measurement switch for row 7's converter, set by -D in scratch builds
// (chip_smoke.py times them to find the converter's share of the kernel):
// 2 (the kernel) converts and stores; 1 converts but stores only a value
// that never occurs (two all-ones halves: NaNs no finite q * s gives);
// 0 converts nothing, so the consumers multiply whatever the B stages hold.
#ifndef DST_FC_CONVERTER
#define DST_FC_CONVERTER 2
#endif

namespace hop {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kBoxN = 64;                   // one 128-byte swizzle atom
constexpr int kBoxBytes = BK * kBoxN * 2;   // 8 KB
constexpr int kThreads = 384;
// the converter, warps 1-3: thread ct keeps column piece ct % 32 (8
// columns) and takes rows ct / 32 + 3 i of each stage
constexpr int kConverters = 96;
constexpr int kRowStep = kConverters / (BN / 8);
constexpr int kConvRows = (BK + kRowStep - 1) / kRowStep;
constexpr int kConvBatch = (kConvRows + 1) / 2;  // rows loaded, then converted

template <int MODE>
struct Cfg {
  static constexpr bool DQ = MODE != kDense;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int P_ROW = MODE == kInt4 ? BN / 2 : BN;  // payload bytes
  static constexpr int P_BYTES = DQ ? BK * P_ROW : 0;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + P_BYTES;
  // as many stages as fit, up to 4: 4 dense, 3 int8, 4 int4
  static constexpr int FIT = (232448 - 1024 - 4 * 4 * 8) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // 1024 bytes of slack to align the ring to the 128-byte swizzle's period
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(STAGES) * STAGE_BYTES + 4 * STAGES * 8;
  static_assert(SMEM <= 232448, "shared memory of a block");
  // registers a thread after setmaxnreg: warpgroup 0 gives its spare ones
  // to the consumers; the ring's shared memory keeps one block on an SM,
  // whose 65536 registers hold the sum
  static constexpr int LOADER_REGS = DQ ? 152 : 40;
  static constexpr int CONSUMER_REGS = DQ ? 176 : 232;
  static_assert((LOADER_REGS + 2 * CONSUMER_REGS) * 128 <= 65536,
                "register budget");
};

struct Params {
  float* out;
  const float* scales;  // row 7: one per `block` flat weight elements
  int m, n, k, ldo;
  int block;  // row 7: of the weight; row 9: of the product
  int vec2;   // out and ldo allow 8-byte stores
  void* payload;   // row 9: int8 [m * n], or packed int4 [m * n / 2]
  float* qscales;  // row 9: [m * n / block]
  int vec16;       // row 9: the payload's rows allow 16-byte stores
};

#define DST_ACC128(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),          \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),          \
  "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),          \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),          \
  "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),          \
  "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),          \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),         \
  "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),     \
  "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),     \
  "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),     \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),     \
  "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),     \
  "+f"(d[126]), "+f"(d[127])

#define DST_D128                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "   \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d[64 x 256] += A[64 x 16] * B[16 x 256] (N-major: transpose bit of B
// set), fp32 accumulators; asynchronous until wgmma.wait_group. A is
// K-major, or M-major with TRANS_A (the transpose bit of A set: row 9's
// a^T, read as a [k, m] lies)
template <typename T, bool TRANS_A = false>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile("wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
                 DST_D128 ", %128, %129, 1, 1, 1, %130, 1;\n"
                 : DST_ACC128(d) : "l"(da), "l"(db), "n"(TRANS_A ? 1 : 0));
  } else {
    asm volatile("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 DST_D128 ", %128, %129, 1, 1, 1, %130, 1;\n"
                 : DST_ACC128(d) : "l"(da), "l"(db), "n"(TRANS_A ? 1 : 0));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive weight elements from their payload bytes and one scale,
// as 16 bytes of T: to_T(float(q) * s) each, load_b8's arithmetic. float(q)
// takes no conversion instruction: int8 q + 128 is the byte XOR 0x80, int4
// q + 8 the nibble XOR 8 (pack_int4's nibbles, element 2i low), and both
// come back exactly from 2^23 + (q + bias) - (2^23 + bias); so float(q) * s
// rounds once, then once more to T, as the plain dequantize does
template <typename T, int MODE>
__device__ __forceinline__ uint4 dequant8(uint2 raw, float s,
                                          uint32_t two23) {
  float v[8];
  if constexpr (MODE == kInt8) {
    const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
    v[0] = byte_in_two23<0>(lo, two23);
    v[1] = byte_in_two23<1>(lo, two23);
    v[2] = byte_in_two23<2>(lo, two23);
    v[3] = byte_in_two23<3>(lo, two23);
    v[4] = byte_in_two23<0>(hi, two23);
    v[5] = byte_in_two23<1>(hi, two23);
    v[6] = byte_in_two23<2>(hi, two23);
    v[7] = byte_in_two23<3>(hi, two23);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - 8388736.f) * s;
  } else {
    const uint32_t x = raw.x ^ 0x88888888u;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (__uint_as_float(((x >> (4 * e)) & 0xFu) | two23) - 8388616.f) *
             s;
  }
  return make_uint4(pack2<T>(v[0], v[1]), pack2<T>(v[2], v[3]),
                    pack2<T>(v[4], v[5]), pack2<T>(v[6], v[7]));
}

// The scales of a converter thread's pieces in the stage at k0: rows
// k0 + r0 + kRowStep i, columns gj .. gj + 7, one scale each (the launcher
// checked block % 8 == 0 and k * n < 2^31). The flat index f = gk * n + gj
// steps by kRowStep * n a row, so its quotient by `block` steps by dq with
// remainder dr: one division a stage, none a row. 0 outside the weight.
__device__ __forceinline__ void stage_scales(float (&sc)[kConvRows],
                                             const Params& p, int k0, int r0,
                                             int gj, uint32_t dq,
                                             uint32_t dr) {
  const uint32_t f = static_cast<uint32_t>(k0 + r0) * p.n + gj;
  const uint32_t blk = static_cast<uint32_t>(p.block);
  uint32_t q = f / blk, rem = f - q * blk;
#pragma unroll
  for (int i = 0; i < kConvRows; ++i) {
    const int gk = k0 + r0 + kRowStep * i;
    sc[i] = r0 + kRowStep * i < BK && gk < p.k && gj < p.n
                ? __ldg(p.scales + q) : 0.f;
    q += dq;
    rem += dr;
    if (rem >= blk) {
      rem -= blk;
      ++q;
    }
  }
}

// ---- row 9's epilogue: the blockwise quantize in the consumers' registers
// Words w[o .. o+3] of the four lanes of a quad, transposed across it:
// afterwards lane q's w[o + i] is lane i's w[o + q]. Two butterfly rounds
// of two shuffles each swap a lane-index bit with a word-index bit.
// (o a constant once the caller's loop is unrolled)
template <int N>
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[N], int o,
                                               int q) {
#pragma unroll
  for (int bit = 2; bit > 0; bit >>= 1) {
    const bool hi = q & bit;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i & bit) continue;
      // send the word whose index bit differs from the lane's, receive
      // the partner's into the same slot
      const uint32_t r = __shfl_xor_sync(0xffffffffu,
                                         hi ? w[o + i] : w[o + i + bit], bit);
      if (hi)
        w[o + i] = r;
      else
        w[o + i + bit] = r;
    }
  }
}

// The two rows of one consumer thread (d[4 j + 2 h + e]: row row0 + 8 h,
// column n0 + 8 j + 2 q + e, q = lane % 4, as the store epilogue reads
// them), quantized in blocks of 8 * BJ columns and stored. A block's 2 BJ
// values a row lie in this thread, the rest in its quad: the absmax takes
// two shuffles. Each element is quant_one of its scale (quant.cu's
// arithmetic), packed into payload words w (int4: byte e of w[i] is column
// pair j = 4 i + e, a whole byte; int8: half e of w[i] is pair j = 2 i +
// e); a quad transpose then gives each lane whole 16-byte pieces of the
// payload row (`piece` below), stored with one vector store each.
template <int BITS, int BJ>
__device__ __forceinline__ void quantize_rows(float (&d)[128],
                                              const Params& p, int row0,
                                              int n0, int q) {
  constexpr float kQmax = BITS == 8 ? 127.f : 7.f;
  constexpr int kWords = BITS == 8 ? 16 : 8;  // payload words a row
  constexpr int kSpan = BITS == 8 ? 16 : 32;  // columns a 16-byte piece
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool live = row < p.m;
    const long long flat = static_cast<long long>(row) * p.n;
    uint32_t w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int g = 0; g < 32 / BJ; ++g) {
      float amax = 0.f;
#pragma unroll
      for (int j = g * BJ; j < (g + 1) * BJ; ++j)
        amax = fmaxf(amax, fmaxf(fabsf(d[4 * j + 2 * h]),
                                 fabsf(d[4 * j + 2 * h + 1])));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      float s = __fdiv_rn(amax, kQmax);
      if (s == 0.f) s = 1.f;
      const int col = n0 + 8 * BJ * g;
      if (live && (g & 3) == q && col < p.n)
        p.qscales[static_cast<long long>(row) * (p.n / p.block) +
                  col / p.block] = s;
#pragma unroll
      for (int j = g * BJ; j < (g + 1) * BJ; ++j) {
        const uint32_t lo = quant_one(d[4 * j + 2 * h], s, kQmax);
        const uint32_t hi = quant_one(d[4 * j + 2 * h + 1], s, kQmax);
        if constexpr (BITS == 4)
          w[j >> 2] |= ((lo & 0xFu) | (hi & 0xFu) << 4) << (8 * (j & 3));
        else
          w[j >> 1] |= ((lo & 0xFFu) | (hi & 0xFFu) << 8) << (16 * (j & 1));
      }
    }
#pragma unroll
    for (int o = 0; o < kWords; o += 4) {
      quad_transpose(w, o, q);
      // w[o + i] is lane i's word of piece o + q: the payload row's bytes
      // 16 (o + q) .. + 15, interleaved lane by lane
      const uint32_t s0 = w[o], s1 = w[o + 1], s2 = w[o + 2], s3 = w[o + 3];
      uint4 v;
      if constexpr (BITS == 4) {  // byte e of each lane's word, in turn
        const uint32_t t0 = __byte_perm(s0, s1, 0x5140);
        const uint32_t t1 = __byte_perm(s2, s3, 0x5140);
        const uint32_t t2 = __byte_perm(s0, s1, 0x7362);
        const uint32_t t3 = __byte_perm(s2, s3, 0x7362);
        v = make_uint4(
            __byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
            __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
      } else {  // half e of each lane's word, in turn
        v = make_uint4(
            __byte_perm(s0, s1, 0x5410), __byte_perm(s2, s3, 0x5410),
            __byte_perm(s0, s1, 0x7632), __byte_perm(s2, s3, 0x7632));
      }
      const int piece = o + q, c0 = n0 + kSpan * piece;
      if (!live || c0 >= p.n) continue;
      unsigned char* dst = static_cast<unsigned char*>(p.payload) +
                           (flat + c0) * BITS / 8;
      if (p.vec16 && c0 + kSpan <= p.n) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {  // a 4-byte word never straddles n (n % 8 == 0)
        const uint32_t part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e * kSpan / 4 < p.n)
            reinterpret_cast<uint32_t*>(dst)[e] = part[e];
      }
    }
  }
}

template <int BITS>
__device__ __forceinline__ void quantize_tile_regs(float (&d)[128],
                                                   const Params& p, int row0,
                                                   int n0, int q) {
  switch (p.block) {  // the launcher took only these
    case 256: quantize_rows<BITS, 32>(d, p, row0, n0, q); break;
    case 128: quantize_rows<BITS, 16>(d, p, row0, n0, q); break;
    case 64: quantize_rows<BITS, 8>(d, p, row0, n0, q); break;
    case 32: quantize_rows<BITS, 4>(d, p, row0, n0, q); break;
    case 16: quantize_rows<BITS, 2>(d, p, row0, n0, q); break;
    default: quantize_rows<BITS, 1>(d, p, row0, n0, q); break;
  }
}

// MODE: B dense or dequantized (row 7). TRANS_A: A is a [k, m] (row 9's
// a^T). QBITS: 0 stores the fp32 product (rows 7, 8); 8 or 4 quantizes
// it (row 9).
template <typename T, int MODE, bool TRANS_A, int QBITS>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
             const __grid_constant__ CUtensorMap tm_b, Params p) {
  using C = Cfg<MODE>;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // stage s: A at base + s * STAGE_BYTES, B after it, then the payload
  const uint32_t bars = base + S * C::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto pfull = [&](int s) { return bars + 8 * (2 * S + s); };
  auto bready = [&](int s) { return bars + 8 * (3 * S + s); };
  // the warpgroup, broadcast from lane 0 so that the compiler sees
  // warp-uniform branches around setmaxnreg and wgmma (.sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);
  const int t = threadIdx.x % 128;
  // row 9 walks the m tiles first: a wave of blocks then shares a few B
  // panels, and all of A stays in L2 (the path's a^T is 16 MB, b 45 MB)
  const int m0 = (QBITS ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (QBITS ? blockIdx.y : blockIdx.x) * BN;
  const int nk = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
      if constexpr (C::DQ) {
        mbar_init(pfull(s), 1);
        mbar_init(bready(s), kConverters);  // every converter thread
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::LOADER_REGS));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));
  }
  if (wg == 0 && t < 32) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_b)) : "memory");
      for (int it = 0; it < nk; ++it) {
        const int s = it % S;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);
        const uint32_t sa = base + s * C::STAGE_BYTES;
        const int k0 = it * BK;
        mbar_expect_tx(full(s), C::A_BYTES + (C::DQ ? 0 : C::B_BYTES));
        if constexpr (TRANS_A) {  // two boxes of 64 k rows x 64 m
          tma_load_2d(sa, &tm_a, full(s), m0, k0);
          tma_load_2d(sa + kBoxBytes, &tm_a, full(s), m0 + kBoxN, k0);
        } else {
          tma_load_2d(sa, &tm_a, full(s), k0, m0);
        }
        if constexpr (C::DQ) {
          mbar_expect_tx(pfull(s), C::P_BYTES);
          tma_load_2d(sa + C::A_BYTES + C::B_BYTES, &tm_b, pfull(s),
                      MODE == kInt4 ? n0 / 2 : n0, k0);
        } else {
#pragma unroll
          for (int i = 0; i < BN / kBoxN; ++i)
            tma_load_2d(sa + C::A_BYTES + i * kBoxBytes, &tm_b, full(s),
                        n0 + i * kBoxN, k0);
        }
      }
    }
  } else if (wg == 0) {
    // ---- converter (warps 1-3): payload stage -> swizzled B stage; the
    // next stage's scales are loaded while this one is converted
    if constexpr (C::DQ) {
      constexpr int R = kConvRows;
      const int ct = t - 32, jp = ct % (BN / 8), r0 = ct / (BN / 8);
      const int gj = n0 + 8 * jp;
      const uint32_t step = static_cast<uint32_t>(kRowStep) * p.n;
      const uint32_t dq = step / p.block, dr = step % p.block;
      uint32_t two23;  // in a register, so that prmt takes its selector
      asm("mov.b32 %0, %1;" : "=r"(two23) : "n"(kTwo23));
      float cur[R], nxt[R];
      stage_scales(cur, p, 0, r0, gj, dq, dr);
      for (int it = 0; it < nk; ++it) {
        const int s = it % S;
        if (it + 1 < nk) stage_scales(nxt, p, (it + 1) * BK, r0, gj, dq, dr);
        mbar_wait(pfull(s), (it / S) & 1);
        unsigned char* __restrict__ bs =
            smem + s * C::STAGE_BYTES + C::A_BYTES;
        const unsigned char* __restrict__ ps = bs + C::B_BYTES;
        // half the rows' payload first, then their conversions, which are
        // independent of each other (one warp a scheduler needs the ILP)
#pragma unroll
        for (int i0 = 0; i0 < R; i0 += kConvBatch) {
          uint2 pay[kConvBatch];
#pragma unroll
          for (int b = 0; b < kConvBatch; ++b) {
            const int i = i0 + b, r = r0 + kRowStep * i;
            pay[b] = make_uint2(0u, 0u);
            if (i < R && r < BK) {
              if constexpr (MODE == kInt8)
                pay[b] = *reinterpret_cast<const uint2*>(ps + r * C::P_ROW +
                                                         8 * jp);
              else
                pay[b].x = *reinterpret_cast<const uint32_t*>(
                    ps + r * C::P_ROW + 4 * jp);
            }
          }
#pragma unroll
          for (int b = 0; b < kConvBatch; ++b) {
            const int i = i0 + b, r = r0 + kRowStep * i;
            if (i >= R || r >= BK || DST_FC_CONVERTER == 0) continue;
            const uint4 v = dequant8<T, MODE>(pay[b], cur[i], two23);
            // 128-byte swizzle: 16-byte chunk c of row r lands at c ^ (r % 8)
            if (DST_FC_CONVERTER == 2 || v.x == 0xFFFFFFFFu)
              *reinterpret_cast<uint4*>(bs + (jp >> 3) * kBoxBytes +
                                        r * 128 +
                                        (((jp & 7) ^ (r & 7)) << 4)) = v;
          }
        }
        // generic-proxy writes, read next by wgmma through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bready(s));
#pragma unroll
        for (int i = 0; i < R; ++i) cur[i] = nxt[i];
      }
    }
  } else {
    // ---- consumers: rows 64 c .. 64 c + 63 of the tile
    const int c = wg - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % S;
      const uint32_t ph = (it / S) & 1;
      mbar_wait(full(s), ph);
      if constexpr (C::DQ) mbar_wait(bready(s), ph);
      // this consumer's 64 rows of A: 64 rows of 128 bytes (K-major) or,
      // with TRANS_A, one 64-wide M atom, the box of 64 k rows at c
      const uint32_t sa = base + s * C::STAGE_BYTES + c * kBoxBytes;
      const uint32_t sb = base + s * C::STAGE_BYTES + C::A_BYTES;
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // k step kk: A 32 bytes along its 128-byte rows (K-major) or 16 rows
      // of 128 bytes (M-major), B 16 rows of 128 bytes
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256<T, TRANS_A>(
            d, TRANS_A ? wg_desc(sa + kk * 16 * 128, kBoxBytes, 1024)
                       : wg_desc(sa + 32 * kk, 16, 1024),
            wg_desc(sb + kk * 16 * 128, kBoxBytes, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's group is done: free it
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(d);
      if (it > 0 && (t & 31) == 0) mbar_arrive(empty((it - 1) % S));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    // d[4 j + e]: row 16 w + lane / 4 (+ 8 for e >= 2), column 8 j +
    // 2 (lane % 4) (+ 1 for odd e), w the warp within the warpgroup
    const int w = t >> 5, lane = t & 31;
    const int r0 = m0 + 64 * c + 16 * w + (lane >> 2);
    if constexpr (QBITS != 0) {
      quantize_tile_regs<QBITS>(d, p, r0, n0, lane & 3);
      return;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= p.m || col >= p.n) continue;
        float* o = p.out + static_cast<long long>(row) * p.ldo + col;
        const float lo = d[4 * j + 2 * h], hi = d[4 * j + 2 * h + 1];
        if (p.vec2 && col + 1 < p.n) {
          *reinterpret_cast<float2*>(o) = make_float2(lo, hi);
        } else {
          o[0] = lo;
          if (col + 1 < p.n) o[1] = hi;
        }
      }
    }
  }
}

#undef DST_ACC128
#undef DST_D128

}  // namespace hop

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

// ------------------------------------------- Hopper path: the launcher
// what the Hopper path takes (ops/fused_collectives.py `wgmma_path` states
// the same): bf16/fp16, TMA's 16-byte aligned bases and row strides, whole
// 8-element pieces a scale each, a 32-bit flat weight index; bits 0 = dense
bool wgmma_ok(int dtype, const void* a, const void* b, int m, int n, int k,
              int bits, int block) {
  if ((dtype != 1 && dtype != 2) || m < 1 || n < 1 || k < 1 || k % 8 ||
      n % 8 || !aligned(a, 16) || !aligned(b, 16))
    return false;
  if (bits == 0) return true;
  return block % 8 == 0 && n % (bits == 8 ? 16 : 32) == 0 &&
         static_cast<long long>(k) * n < (1LL << 31);
}

template <typename T, int MODE>
int launch_wgmma(const void* a, const void* b, const float* scales,
                 float* out, int m, int n, int k, int ldo, int block,
                 cudaStream_t s) {
  using C = hop::Cfg<MODE>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_a, tm_b;
  int err = encode_2d(&tm_a, type, 2, a, m, k, hop::BM, hop::BK, true);
  if (err) return err;
  err = MODE == kDense
      ? encode_2d(&tm_b, type, 2, b, k, n, hop::BK, hop::kBoxN, true)
      : encode_2d(&tm_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, k,
                  MODE == kInt8 ? n : n / 2, hop::BK, C::P_ROW, false);
  if (err) return err;
  auto kernel = hop::wgmma_kernel<T, MODE, false, 0>;
  err = set_smem(kernel, C::SMEM);
  if (err) return err;
  hop::Params p{out, scales, m, n, k, ldo, block,
                ldo % 2 == 0 && aligned(out, 8)};
  dim3 grid((n + hop::BN - 1) / hop::BN, (m + hop::BM - 1) / hop::BM);
  kernel<<<grid, hop::kThreads, C::SMEM, s>>>(tm_a, tm_b, p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch_wgmma(int dtype, const void* a, const void* b,
                   const float* scales, float* out, int m, int n, int k,
                   int ldo, int block, cudaStream_t s) {
  return dtype == 1
      ? launch_wgmma<__half, MODE>(a, b, scales, out, m, n, k, ldo, block, s)
      : launch_wgmma<__nv_bfloat16, MODE>(a, b, scales, out, m, n, k, ldo,
                                          block, s);
}

// what row 9's Hopper kernel takes (ops/fused_collectives.py
// `wgmma_quantize_path` states the same): bf16/fp16, 16-byte aligned bases,
// A's and B's rows whole 16-byte strides (a [rows, k], or [k, rows] with
// trans_a; b [k, n]), quantization blocks that tile the 256-wide output
// tile and the rows (block | 256, block | n, block % 8 == 0), and n tiles
// within the grid's 65535
bool wgmma_quantize_ok(int dtype, const void* a, const void* b, int rows,
                       int n, int k, int trans_a, int block) {
  return (dtype == 1 || dtype == 2) && rows >= 1 && n >= 1 && k >= 1 &&
         (trans_a ? rows : k) % 8 == 0 && n % 8 == 0 && aligned(a, 16) &&
         aligned(b, 16) && block >= 8 && block % 8 == 0 &&
         hop::BN % block == 0 && n % block == 0 &&
         (n + hop::BN - 1) / hop::BN <= 65535;
}

template <typename T, bool TRANS_A, int BITS>
int launch_wgmma_quantize(const void* a, const void* b, void* payload,
                          float* scales, int rows, int n, int k, int block,
                          cudaStream_t s) {
  using C = hop::Cfg<kDense>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_a, tm_b;
  // a^T: the [k, rows] array in boxes of 64 k rows x 64 rows (M-major)
  int err = TRANS_A
      ? encode_2d(&tm_a, type, 2, a, k, rows, hop::BK, hop::kBoxN, true)
      : encode_2d(&tm_a, type, 2, a, rows, k, hop::BM, hop::BK, true);
  if (err) return err;
  err = encode_2d(&tm_b, type, 2, b, k, n, hop::BK, hop::kBoxN, true);
  if (err) return err;
  auto kernel = hop::wgmma_kernel<T, kDense, TRANS_A, BITS>;
  err = set_smem(kernel, C::SMEM);
  if (err) return err;
  hop::Params p{};
  p.m = rows;
  p.n = n;
  p.k = k;
  p.block = block;
  p.payload = payload;
  p.qscales = scales;
  p.vec16 = n % (BITS == 8 ? 16 : 32) == 0 && aligned(payload, 16);
  // m tiles on x, the fastest in the order blocks start
  dim3 grid((rows + hop::BM - 1) / hop::BM, (n + hop::BN - 1) / hop::BN);
  kernel<<<grid, hop::kThreads, C::SMEM, s>>>(tm_a, tm_b, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma_quantize(const void* a, const void* b, void* payload,
                            float* scales, int rows, int n, int k,
                            int trans_a, int bits, int block,
                            cudaStream_t s) {
  if (trans_a)
    return bits == 8
        ? launch_wgmma_quantize<T, true, 8>(a, b, payload, scales, rows, n,
                                            k, block, s)
        : launch_wgmma_quantize<T, true, 4>(a, b, payload, scales, rows, n,
                                            k, block, s);
  return bits == 8
      ? launch_wgmma_quantize<T, false, 8>(a, b, payload, scales, rows, n, k,
                                           block, s)
      : launch_wgmma_quantize<T, false, 4>(a, b, payload, scales, rows, n, k,
                                           block, s);
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

// The same two products on the Hopper kernel (TMA + wgmma). They take only
// what `wgmma_ok` accepts and return cudaErrorInvalidValue otherwise: the
// caller decides the path (ops/fused_collectives.py `wgmma_path`), and
// nothing here gives way to the other kernels.
extern "C" int dst_fc_matmul_wgmma(const void* a, const void* b, float* out,
                                   int m, int n, int k, int ldo, int dtype,
                                   void* stream) {
  if (ldo < n || !wgmma_ok(dtype, a, b, m, n, k, 0, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_wgmma<kDense>(dtype, a, b, nullptr, out, m, n, k, ldo, 1,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int dst_fc_dequant_matmul_wgmma(const void* h, const void* payload,
                                           const float* scales, float* out,
                                           int m, int n, int k, int ldo,
                                           int bits, int block, int dtype,
                                           void* stream) {
  if (ldo < n || (bits != 4 && bits != 8) || block < 8 ||
      (static_cast<long long>(k) * n) % block != 0 ||
      !wgmma_ok(dtype, h, payload, m, n, k, bits, block))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bits == 8
      ? dispatch_wgmma<kInt8>(dtype, h, payload, scales, out, m, n, k, ldo,
                              block, s)
      : dispatch_wgmma<kInt4>(dtype, h, payload, scales, out, m, n, k, ldo,
                              block, s);
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

// The same on row 9's Hopper kernel (TMA + wgmma, the quantize in the
// consumers' registers). It takes only what `wgmma_quantize_ok` accepts and
// returns cudaErrorInvalidValue otherwise: the caller decides the path
// (ops/fused_collectives.py `wgmma_quantize_path`), and nothing here gives
// way to the kernel above. No scratch: every block takes one pass.
extern "C" int dst_fc_matmul_quantize_wgmma(const void* a, const void* b,
                                            void* payload, float* scales,
                                            int rows, int n, int k,
                                            int trans_a, int bits, int block,
                                            int dtype, void* stream) {
  if ((bits != 4 && bits != 8) ||
      !wgmma_quantize_ok(dtype, a, b, rows, n, k, trans_a, block))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? dispatch_wgmma_quantize<__half>(a, b, payload, scales, rows, n, k,
                                        trans_a, bits, block, s)
      : dispatch_wgmma_quantize<__nv_bfloat16>(a, b, payload, scales, rows,
                                               n, k, trans_a, bits, block, s);
}

// dynamic shared memory of the Hopper kernel a launch asks for (bits 0:
// a dense B, rows 8 and 9; 8 and 4: row 7's weight), for the build report
extern "C" int dst_fc_wgmma_smem(int bits) {
  return static_cast<int>(bits == 8   ? hop::Cfg<kInt8>::SMEM
                          : bits == 4 ? hop::Cfg<kInt4>::SMEM
                                      : hop::Cfg<kDense>::SMEM);
}

extern "C" const char* dst_fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

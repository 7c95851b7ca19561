// The attention forward's Hopper (sm_90a) mainloop, shared by
// flash_attention.cu (`flash_forward_wgmma_kernel`: K/V tiles of a
// contiguous sequence) and paged_attention.cu (`paged_tile_kernel`: K/V
// tiles gathered page by page through a page table). The two kernels
// differ in their producer, which fills a ring of K/V stages by TMA; what
// the consumer warpgroups do with the stages is `fwd_mainloop` below.
//
// Tiles lie in shared memory as TMA writes them with the 128-byte swizzle:
// rows of 64 16-bit channels, one swizzle atom wide (kRows64 bytes for 64
// rows). At head_dim 128 a row is two atoms, kept as two such tiles
// ("halves") at a fixed byte stride. S = Q.K^T reads Q and K K-major (the
// contraction runs over the channels, a k step of 16 channels is 32 bytes
// along the row); O += P.V reads V MN-major through wgmma's transpose bit
// (the contraction runs over the keys, down the rows), so no tile is ever
// copied transposed. The m64nNk16 accumulator layout of a warp is the
// m16n8k16 A-fragment layout, so P goes from the score accumulators into
// the P.V product's A registers, rounded to T there (`acc_as_a`).
//
// The wgmma helpers (m64n64k16, A from shared memory or registers) serve
// the flash backward too. Everything is inline, in namespace `attn`.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace attn {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows64 = 64 * 128;  // bytes of 64 rows of one swizzle atom

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

#define DST_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DST_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A from shared memory (K-major
// descriptor da), B from shared memory (descriptor db, MN-major when
// TRANS_B); accumulate 0 overwrites d. Asynchronous until wgmma_wait.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DST_D32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : DST_ACC32(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DST_D32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : DST_ACC32(d) : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
}

// d[64 x 64] += A[64 x 16] . B[16 x 64] with A from registers: warp w of
// the warpgroup holds rows 16 w .. 16 w + 15 in mma.sync's m16n8k16 A
// layout: a[0] row g, columns 2t and 2t + 1; a[1] row g + 8; a[2] and a[3]
// the same rows, columns 2t + 8 and 2t + 9; g = lane / 4, t = lane % 4
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DST_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : DST_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DST_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : DST_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(TRANS_B));
  }
}

#undef DST_ACC32
#undef DST_D32

// Accumulator element x = 4 j + e of a warp's m64n64 tile sits at row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2. The A fragment of k step
// kk (columns 16 kk .. 16 kk + 15) is then elements 8 kk .. 8 kk + 7 in
// pairs, rounded to T.
template <typename T>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4][4],
                                         const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// the descriptor of k step kk of a 64-row tile at shared address `tile`:
// K-major (k along the 128-byte rows) or MN-major (k down the rows)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return wg_desc(tile + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return wg_desc(tile + 2048 * kk, kRows64, 1024);
}

// S = Q.K^T of one kv tile of 64 keys for one consumer warpgroup of 64
// query rows, issued (asynchronous until wgmma_wait): q is the
// warpgroup's Q tile (its halves q_half bytes apart), k the stage's K tile
// (halves kv_half apart), both K-major
template <typename T, int D>
__device__ __forceinline__ void fwd_scores(float (&s)[32], uint32_t q,
                                           uint32_t q_half, uint32_t k,
                                           uint32_t kv_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, 0>(s, desc_k(q + (kk / 4) * q_half, kk % 4),
                   desc_k(k + (kk / 4) * kv_half, kk % 4), kk);
}

// O += P.V with P in A registers and the stage's V tile read MN-major,
// issued (asynchronous until wgmma_wait)
template <typename T, int D>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 64][32],
                                       const uint32_t (&a)[4][4], uint32_t v,
                                       uint32_t kv_half) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<T, 1>(o[hh], a[kk], desc_mn(v + hh * kv_half, kk));
}

// The online softmax of one tile's scores s for the thread's rows 16 w + g
// and 16 w + g + 8 (index ri 0, 1), keys 8 j + 2 t + e % 2 of the tile:
// with MASK, keys that `vis(ri, col)` refuses get -1e30; then, in base 2
// with scale * log2 e (sl2) folded in, s becomes P against the new running
// max m of the raw scores, l (the thread's part of the running sum; its
// quad's four parts add up in `fwd_finish`) is rescaled and grows, and
// corr is the factor that carries the output from the old max to the new.
// Needs a positive scale. A row that has seen no key keeps m = -1e30 and
// l = 0.
template <bool MASK, typename Vis>
__device__ __forceinline__ void fwd_softmax(float (&s)[32], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            float sl2, const Vis& vis) {
  const int tq = threadIdx.x & 3;
  if constexpr (MASK) {
#pragma unroll
    for (int x = 0; x < 32; ++x)
      if (!vis((x >> 1) & 1, 8 * (x >> 2) + 2 * tq + (x & 1))) s[x] = kNegInf;
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
  float base[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
    mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
    const float mn = fmaxf(m[ri], mx[ri]);
    // a row that has seen nothing yet exponentiates against 0, so its
    // -1e30 scores give exp2(-huge) = 0 and not exp2(0) = 1
    base[ri] = mn == kNegInf ? 0.f : mn * sl2;
    corr[ri] = exp2f(fmaf(m[ri], sl2, -base[ri]));
    m[ri] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int ri = (x >> 1) & 1;
    s[x] = exp2f(fmaf(s[x], sl2, -base[ri]));
    sum[ri] += s[x];
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) l[ri] = fmaf(l[ri], corr[ri], sum[ri]);
}

// fwd_softmax of tile i: masked(i) says whether it needs the mask,
// vis(i, ri, col) which keys it lets through
template <typename Masked, typename Vis>
__device__ __forceinline__ void fwd_softmax_tile(int i, float (&s)[32],
                                                 float (&m)[2], float (&l)[2],
                                                 float (&corr)[2], float sl2,
                                                 const Masked& masked,
                                                 const Vis& vis) {
  auto tile_vis = [&](int ri, int col) { return vis(i, ri, col); };
  if (masked(i))
    fwd_softmax<true>(s, m, l, corr, sl2, tile_vis);
  else
    fwd_softmax<false>(s, m, l, corr, sl2, tile_vis);
}

template <int D>
__device__ __forceinline__ void fwd_rescale(float (&o)[D / 64][32],
                                            const float (&corr)[2]) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[hh][x] *= corr[(x >> 1) & 1];
}

// A consumer warpgroup's walk over n kv tiles: stage(i) waits for tile
// i's stage and gives its K tile's address (V follows D / 64 halves
// later), release(i) frees it, masked(i) says whether tile i needs the
// mask and vis(i, ri, col) which keys it lets through. o, m and l carry
// the tiles' sum (fwd_softmax).
// Each tile's S product, softmax and P.V product run in turn; the two
// consumer warpgroups of a block overlap each other's softmax and
// products. (Issuing tile i's S product beside tile i-1's P.V read slower
// on the H100: PERF.md, section 6.)
template <typename T, int D, typename Stage, typename Release, typename Masked,
          typename Vis>
__device__ __forceinline__ void fwd_mainloop(
    float (&o)[D / 64][32], float (&m)[2], float (&l)[2], uint32_t q,
    uint32_t q_half, uint32_t kv_half, int n, float sl2, const Stage& stage,
    const Release& release, const Masked& masked, const Vis& vis) {
  float s[32], corr[2];
  uint32_t a[4][4];
  for (int i = 0; i < n; ++i) {
    const uint32_t k = stage(i);
    wgmma_fence();
    fwd_scores<T, D>(s, q, q_half, k, kv_half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fwd_softmax_tile(i, s, m, l, corr, sl2, masked, vis);
    fwd_rescale<D>(o, corr);
    acc_as_a<T>(a, s);
    wgmma_fence();
    fwd_pv<T, D>(o, a, k + (D / 64) * kv_half, kv_half);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) fence_acc(o[hh]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    release(i);
  }
}

// after the last tile: l summed over the quad, o divided by it (0 where a
// row saw no key: the l == 0 guard)
template <int D>
__device__ __forceinline__ void fwd_finish(float (&o)[D / 64][32],
                                           float (&l)[2]) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float li = l[(x >> 1) & 1];
      o[hh][x] = li == 0.f ? 0.f : o[hh][x] / li;
    }
}

// the thread's part of row ri (0, 1) of o into the row at `dst` (D values
// of T), 4 bytes a store
template <typename T, int D>
__device__ __forceinline__ void fwd_store_row(T* dst,
                                              const float (&o)[D / 64][32],
                                              int ri) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 64 * hh + 8 * jj + 2 * tq) =
          pack2<T>(o[hh][4 * jj + 2 * ri], o[hh][4 * jj + 2 * ri + 1]);
}

// ------------------------------------------------------------ host side
// The tensor map of a [b, s, heads, d] tensor of 16-bit T (d 64 or 128)
// as the 4-D array (d, heads, seq, batch), innermost first; box: `rows`
// rows of one head's 64 channels (one swizzle atom; d 128 takes two boxes
// a row, at channels 0 and 64).
template <typename T>
int encode_heads(CUtensorMap* map, const void* ptr, int b, int s, int heads,
                 int d, int rows) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_tiled(map, type, 4, ptr, dims, strides, box, true);
}

}  // namespace attn

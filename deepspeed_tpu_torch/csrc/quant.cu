// Blockwise symmetric quantize / dequantize, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/quant.py
// `quantize_blockwise_pallas` (body `_quant_kernel`) and
// `dequantize_blockwise_pallas` (body `_dequant_kernel`). Same functions as
// the plain PyTorch versions in deepspeed_tpu_torch/ops/quant.py:
//
//   quantize:   x [rows, block] (fp32/fp16/bf16, viewed flat) ->
//               scale[r] = absmax(float(x[r])) / qmax, 1 where that is 0;
//               q[r, i] = clamp(rint(float(x[r, i]) / scale[r]), -qmax-1, qmax)
//               with qmax = 2^(bits-1) - 1. q is int8 [rows, block], or,
//               with `pack`, offset-binary nibbles: byte k of a row holds
//               (q[2k] + 8) in its low nibble and (q[2k+1] + 8) in its high
//               one (the v1 inference engine's int4 weight layout).
//   dequantize: out[r, i] = to_dtype(float(q[r, i]) * scale[r]), reading
//               int8 q or, with `packed`, the nibbles above.
//
// Bitwise equal to the plain versions: the input is cast to fp32 before any
// arithmetic, the scale and the quotient are IEEE divisions (nvcc's default
// -prec-div=true; no fast-math, no reciprocal multiply), rintf rounds half
// to even like torch.round, and the output cast rounds to nearest even.
//
// What bounds them on the H100: HBM bytes. Each element is read once and
// written once with a handful of operations; the scale reduction is one
// warp's shuffle per row.
//
// Design (simple and right first): quantize gives each row to one warp
// (eight rows per 256-thread block); a lane takes element pairs p = lane,
// lane + 32, ... (one 4-byte bf16 load per pair), reduces its absmax, the
// warp reduces with shuffles, and a second pass over the row (now in L1)
// writes q. Dequantize is a grid-stride loop over element pairs, one pair
// per thread per step, two outputs written per pair. Later work: 16-byte
// vector loads, keeping a row in registers between the two passes, and
// fusing the dequantize into the GEMM's prologue (TPU row 7,
// `dequant_matmul`).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int quant_one(float x, float scale, float qmax) {
  // IEEE division and round-half-even, as (x / scale).round() in fp32
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(r, -qmax - 1.f), qmax));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, long long rows, int block,
                float qmax, int pack) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * block;
  const int pairs = block / 2;
  float amax = 0.f;
  for (int p = lane; p < pairs; p += 32) {
    amax = fmaxf(amax, fabsf(to_float(xr[2 * p])));
    amax = fmaxf(amax, fabsf(to_float(xr[2 * p + 1])));
  }
  amax = warp_max(amax);
  float s = __fdiv_rn(amax, qmax);
  if (s == 0.f) s = 1.f;
  if (lane == 0) scale[row] = s;
  if (pack) {
    uint8_t* qr = reinterpret_cast<uint8_t*>(q) + row * pairs;
    for (int p = lane; p < pairs; p += 32) {
      const int lo = quant_one(to_float(xr[2 * p]), s, qmax) + 8;
      const int hi = quant_one(to_float(xr[2 * p + 1]), s, qmax) + 8;
      qr[p] = static_cast<uint8_t>(lo | (hi << 4));
    }
  } else {
    int8_t* qr = q + row * block;
    for (int p = lane; p < pairs; p += 32) {
      qr[2 * p] = static_cast<int8_t>(quant_one(to_float(xr[2 * p]), s, qmax));
      qr[2 * p + 1] =
          static_cast<int8_t>(quant_one(to_float(xr[2 * p + 1]), s, qmax));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scale, T* __restrict__ out,
                  long long n_pairs, int block, int packed) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int pairs_per_row = block / 2;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < n_pairs; p += stride) {
    const float s = scale[p / pairs_per_row];
    float a, b;
    if (packed) {
      const int byte = reinterpret_cast<const uint8_t*>(q)[p];
      a = static_cast<float>((byte & 0xF) - 8);
      b = static_cast<float>((byte >> 4) - 8);
    } else {
      a = static_cast<float>(q[2 * p]);
      b = static_cast<float>(q[2 * p + 1]);
    }
    out[2 * p] = from_float<T>(a * s);
    out[2 * p + 1] = from_float<T>(b * s);
  }
}

template <typename T>
int launch_quantize(const void* x, void* q, float* scale, long long rows,
                    int block, float qmax, int pack, cudaStream_t stream) {
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), scale, rows, block,
      qmax, pack);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequantize(const void* q, const float* scale, void* out,
                      long long rows, int block, int packed,
                      cudaStream_t stream) {
  const long long n_pairs = rows * (block / 2);
  // enough blocks to fill the card several times over; the loop covers
  // the rest
  long long grid = (n_pairs + kThreads - 1) / kThreads;
  if (grid > 132LL * 64) grid = 132LL * 64;
  dequantize_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), scale, static_cast<T*>(out), n_pairs,
      block, packed);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(long long rows, int block, int bits) {
  return rows < 0 || block < 2 || block % 2 != 0 || block > 4096 ||
         (bits != 4 && bits != 8);
}

}  // namespace

// dtype: 0 = fp32, 1 = fp16, 2 = bf16. pack = 1 writes offset-binary int4
// nibbles (needs bits = 4). Returns a cudaError_t value (0 = ok). Launches
// on `stream` and does not synchronise.
extern "C" int dst_quantize_blockwise(const void* x, void* q, float* scale,
                                      long long rows, int block, int bits,
                                      int pack, int dtype, void* stream) {
  if (bad_geometry(rows, block, bits) || (pack && bits != 4) || dtype < 0 ||
      dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_quantize<float>(x, q, scale, rows, block, qmax, pack, s);
    case 1:
      return launch_quantize<__half>(x, q, scale, rows, block, qmax, pack, s);
    default:
      return launch_quantize<__nv_bfloat16>(x, q, scale, rows, block, qmax,
                                            pack, s);
  }
}

// dtype of `out` as above; packed = 1 reads offset-binary int4 nibbles.
extern "C" int dst_dequantize_blockwise(const void* q, const float* scale,
                                        void* out, long long rows, int block,
                                        int packed, int dtype, void* stream) {
  if (bad_geometry(rows, block, 8) || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dequantize<float>(q, scale, out, rows, block, packed, s);
    case 1:
      return launch_dequantize<__half>(q, scale, out, rows, block, packed, s);
    default:
      return launch_dequantize<__nv_bfloat16>(q, scale, out, rows, block,
                                              packed, s);
  }
}

extern "C" const char* dst_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Tiles and the kernels around the dot of the split-K weight-streaming dot
// of several launches, B15's dense_mlp (dense_matmul.cu).
// The kernels sit in an unnamed namespace, so each source that includes
// this header gets its own copy and the shared library links.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace md {
namespace qmm {

constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // contraction rows per pipeline stage
constexpr int NW = 4;        // warps per block
constexpr int NT = 32 * NW;
constexpr int STAGES = 4;
constexpr int LDX = BK + 8;  // bf16 x tile row stride (elements)
constexpr int LDW = BN + 8;  // bf16 weight tile row stride (elements)
constexpr int ROW_GROUP = 128;

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16(acc * scale) [+ res, added in bf16]; the dense dots pass s = 1 (bf16
// weights have no scale), which leaves acc as it is
__device__ __forceinline__ __nv_bfloat16 finish(float acc, float s, const __nv_bfloat16* res) {
  float y = bf16_round(acc * s);
  if (res != nullptr) y += __bfloat162float(*res);
  return __float2bfloat16(y);
}

// Sum the splits' partials in split order, then scale and finish: plain
// (+ residual) over [M, Out], or the SiLU gate over [M, Out / 2] pairing
// column n with column Out / 2 + n.  scale null: the partials need none
// (the dense dots).
__global__ void qmm_epilogue_kernel(const float* part, int split, size_t part_stride,
                                    const float* scale, const __nv_bfloat16* res,
                                    __nv_bfloat16* out, int M, int Out, int gate) {
  const int Fo = gate ? Out / 2 : Out;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * Fo) return;
  const int m = (int)(idx / Fo), n = (int)(idx % Fo);
  const float* p = part + (size_t)m * Out + n;
  float acc = 0.f;
  for (int s = 0; s < split; ++s) acc += p[s * part_stride];
  if (!gate) {
    out[idx] = finish(acc, scale != nullptr ? scale[n] : 1.f,
                      res != nullptr ? res + idx : nullptr);
    return;
  }
  float acc_u = 0.f;
  for (int s = 0; s < split; ++s) acc_u += p[s * part_stride + Fo];
  // the gate and up outputs are rounded to bf16 first, then gated in f32
  const float gv = bf16_round(scale != nullptr ? acc * scale[n] : acc);
  const float uv = bf16_round(scale != nullptr ? acc_u * scale[Fo + n] : acc_u);
  out[idx] = __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);
}

// xn[m] = bf16(bf16(x[m] * rsqrt(mean(x[m]^2) + eps)) * w), one block a row;
// the mean of squares in f32.
__global__ void rms_norm_rows_kernel(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     __nv_bfloat16* xn, int In, float eps) {
  __shared__ float red[32];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * In;
  __nv_bfloat16* yr = xn + (size_t)blockIdx.x * In;
  float ss = 0.f;
  for (int k = threadIdx.x; k < In; k += blockDim.x) {
    const float f = __bfloat162float(xr[k]);
    ss += f * f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = 1.f / sqrtf(red[0] / (float)In + eps);
  for (int k = threadIdx.x; k < In; k += blockDim.x) {
    const float nv = bf16_round(__bfloat162float(xr[k]) * r);
    yr[k] = __float2bfloat16(nv * __bfloat162float(w[k]));
  }
}

}  // namespace
}  // namespace qmm
}  // namespace md

// S1: the coupled-Gumbel sampled head.  For each row r of logits [R, V]
// (float32, rows `row_stride` floats apart), the lowest column v that
// maximizes logits[r, v] / div + g[r, v], where g[r] is the Gumbel noise
// row of magicdec_tpu/ops/sampling.py coupled_gumbel: the row key
// fold_in(fold_in(key, salt[r]), idx[r]), element v's random bits the xor
// of threefry2x32(row key, (0, v)), the uniform u in [tiny, 1) from their
// top 23 bits, g = -log(-log(u)) (jax.random.gumbel, mode "low").
//
// Replaces no Pallas kernel: the JAX package samples with plain jnp
// (ops/sampling.py:70 gumbel_sample_tokens), which XLA fuses.  Bound: the
// integer ALU, the hash's 20 rounds of add / rotate / xor on two words an
// element (about 75 integer operations), beside two accurate logf, an IEEE
// division and the compare; the R * V * 4 bytes read take far less.
// Design: a grid of (nsplit, R) blocks of 256 threads, nsplit chosen by the
// wrapper so that a few rows still fill the card; thread 0 derives the row
// key once a block (two fold_ins); threads stride the block's columns,
// hash, perturb and keep a running (max, lowest index) in registers; warp
// shuffles and shared memory reduce the block; with nsplit > 1 each block
// writes its partial and the row's last block (a finished count a row,
// reset by that block) reduces the partials.  An exact max with the lowest
// index on ties: the token depends on neither the split nor the rows a
// launch carries.  Built without --use_fast_math: the division is IEEE and
// logf the accurate one, so g differs from XLA's by an ulp or so.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal: u's lower bound

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Threefry-2x32 with 20 rounds (jax/_src/prng.py _threefry2x32_lowering):
// the counter (x0, x1) hashed in place under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// (v, i) beats (bv, bi): a larger value, or the same value at a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block's (max, lowest index), valid in thread 0.  Every thread calls
// it; a second call needs a __syncthreads() after the first one's reads.
__device__ __forceinline__ void block_argmax(float& v, int& i) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -INFINITY;
    i = lane < kWarps ? si[lane] : INT_MAX;
    warp_argmax(v, i);
  }
}

__global__ void __launch_bounds__(kThreads)
    gumbel_argmax_kernel(const float* __restrict__ logits, const long long* __restrict__ key,
                         const int* __restrict__ salt, const int* __restrict__ idx,
                         int* __restrict__ out, float* __restrict__ pval,
                         int* __restrict__ pidx, int* __restrict__ count, int V,
                         long long row_stride, int nsplit, float div) {
  const int row = blockIdx.y, split = blockIdx.x;
  __shared__ uint32_t rkey[2];
  __shared__ bool last;
  if (threadIdx.x == 0) {
    uint32_t a = 0, b = (uint32_t)salt[row];  // fold_in(key, salt)
    threefry2x32((uint32_t)key[0], (uint32_t)key[1], a, b);
    uint32_t c = 0, d = (uint32_t)idx[row];   // fold_in(., idx)
    threefry2x32(a, b, c, d);
    rkey[0] = c;
    rkey[1] = d;
  }
  __syncthreads();
  const uint32_t k0 = rkey[0], k1 = rkey[1];
  const int chunk = (V + nsplit - 1) / nsplit;
  const int begin = split * chunk, end = min(V, begin + chunk);
  const float* x = logits + (long long)row * row_stride;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int v = begin + (int)threadIdx.x; v < end; v += kThreads) {
    uint32_t c0 = 0, c1 = (uint32_t)v;  // the counter (v >> 32, v)
    threefry2x32(k0, k1, c0, c1);
    // jax.random.uniform: mantissa bits of [1, 2), minus 1, times
    // (1 - tiny), which rounds to 1, plus tiny, at least tiny
    const float f = __uint_as_float(((c0 ^ c1) >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
    const float g = -logf(-logf(u));
    const float val = __fadd_rn(__fdiv_rn(__ldg(x + v), div), g);
    if (beats(val, v, best, bi)) {
      best = val;
      bi = v;
    }
  }
  block_argmax(best, bi);
  if (nsplit == 1) {
    if (threadIdx.x == 0) out[row] = bi;
    return;
  }
  if (threadIdx.x == 0) {
    pval[row * nsplit + split] = best;
    pidx[row * nsplit + split] = bi;
    __threadfence();
    last = atomicAdd(count + row, 1) == nsplit - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  best = -INFINITY;
  bi = INT_MAX;
  for (int s = threadIdx.x; s < nsplit; s += kThreads) {
    const float pv = __ldcg(pval + row * nsplit + s);
    const int pi = __ldcg(pidx + row * nsplit + s);
    if (beats(pv, pi, best, bi)) {
      best = pv;
      bi = pi;
    }
  }
  block_argmax(best, bi);
  if (threadIdx.x == 0) {
    out[row] = bi;
    count[row] = 0;
  }
}

}  // namespace

// S1 (kernels/sampling.py gumbel_argmax): out [R] int32; pval / pidx
// [R * nsplit] and count [R] (zero between launches) are the wrapper's
// scratch.
extern "C" int md_gumbel_argmax(const void* logits, const void* key, const void* salt,
                                const void* idx, void* out, void* pval, void* pidx,
                                void* count, int R, int V, int row_stride, int nsplit,
                                float div, void* stream) {
  if (R <= 0 || R > 65535 || V <= 0 || nsplit < 1 || row_stride < V)
    return (int)cudaErrorInvalidValue;
  dim3 grid(nsplit, R);
  gumbel_argmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(key),
      static_cast<const int*>(salt), static_cast<const int*>(idx), static_cast<int*>(out),
      static_cast<float*>(pval), static_cast<int*>(pidx), static_cast<int*>(count), V,
      (long long)row_stride, nsplit, div);
  return (int)cudaGetLastError();
}

// B15 dense_mlp: the target's whole bf16 FFN block in its decode and verify
// passes (dense_matmul_fused, one dot a call, runs on dense_matmul_sm90.cu).
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py dense_mlp_pallas
// (_dense_mlp_kernel): the whole dense FFN block,
//   gated = bf16(g * sigmoid(g) * u),  g = bf16(xn @ w13[:, :F]),
//                                      u = bf16(xn @ w13[:, F:]),
//   y = [res +] bf16(gated @ w2),      xn = rms_norm(x) * norm_w,
// bf16 x and weights, f32 accumulation, the norm computed in f32 and cast
// to bf16 before the bf16 multiply by norm_w, a residual added in bf16.
//
// Bound: HBM bytes of the bf16 weight.  At M <= 512 rows a weight byte
// feeds M flops, at most 512, and at the decode rows (M = decode_rows: 128
// at B=32, gamma=3) 128, under the ~295 flop/byte at which the bf16 tensor
// cores limit.  The design is the int8 dots' (quant_matmul.cu) with bf16
// weight tiles and no scale:
// - dmm_partial_kernel: a block owns BN = 128 output columns and a range of
//   the contraction (split-K, fixed by the wrapper from In and Out alone so
//   that narrow matrices still fill the 132 SMs); warp w of 4 owns the 32
//   columns [32w, 32w + 32).  bf16 weight tiles of BK = 64 rows and the
//   matching x tiles land by 16-byte cp.async, STAGES = 4 deep, straight
//   into the tile that ldmatrix (.trans for the weight) reads: no conversion.
//   mma.sync m16n8k16, bf16 in, f32 accumulate.  Rows are tiled by 16 (MT
//   tiles, at most 128 rows a launch).
// - Row invariance (the greedy spec == AR contract): the autoregressive step
//   pads its B live rows with zero rows to decode_rows, while verify fills
//   them with real tokens.  A row's bits here depend on its own data only:
//   each row's sums run over the contraction in one order whatever M and
//   MT are, the split plan comes from the weight's shape, the splits'
//   partials are added in split order by qmm_epilogue_kernel (no float
//   atomics), and the norm is one block a row.
// - dense_mlp is rms_norm_rows_kernel, the w13 dot with the gate epilogue
//   (column n paired with column F + n of the same partials) into a bf16
//   [M, F] scratch, then the w2 dot with the residual: phase 2 needs every
//   gated column of a row, so the phases are launches.
#include "attention_common.cuh"
#include "matmul_common.cuh"

namespace md {
namespace dmm {

using namespace qmm;

struct Args {
  const __nv_bfloat16* x;    // [M, In], the launch's rows
  const __nv_bfloat16* w;    // [In, Out]
  const __nv_bfloat16* res;  // [M, Out] or null
  __nv_bfloat16* out;        // [M, Out] when the block finishes (part == null)
  float* part;               // [split, Mtot, Out] partial sums, or null
  size_t part_stride;        // elements between splits (Mtot * Out)
  int M, In, Out, kchunk;
};

template <int MT>
constexpr int smem_bytes() {
  return STAGES * MT * 16 * LDX * 2 + STAGES * BK * LDW * 2;
}

// Grid (Out / BN, split), NT threads.  Split s covers contraction rows
// [s * kchunk, min(In, (s + 1) * kchunk)).
template <int MT>
__global__ void __launch_bounds__(NT) dmm_partial_kernel(Args a) {
  constexpr int R = MT * 16;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = Xs + STAGES * R * LDX;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int k0 = split * a.kchunk;
  const int k1 = min(a.In, k0 + a.kchunk);
  const int ntiles = k1 > k0 ? (k1 - k0) / BK : 0;
  const int wc = warp * 32;  // the warp's first column in the block's tile

  // start copying contraction tile t into stage st: the x rows (rows past M
  // zero-filled) and the block's BK x BN weight tile, 16 bytes a copy
  auto issue = [&](int st, int t) {
    const int kt = k0 + t * BK;
    __nv_bfloat16* xs = Xs + st * R * LDX;
    for (int i = threadIdx.x; i < R * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = i % (BK / 8);
      const bool valid = r < a.M;
      cp_async16(xs + r * LDX + c8 * 8, valid ? a.x + (size_t)r * a.In + kt + c8 * 8 : a.x,
                 valid);
    }
    __nv_bfloat16* ws = Ws + st * BK * LDW;
    for (int i = threadIdx.x; i < BK * (BN / 8); i += NT) {
      const int r = i / (BN / 8), c8 = i % (BN / 8);
      cp_async16(ws + r * LDW + c8 * 8, a.w + (size_t)(kt + r) * a.Out + n0 + c8 * 8, true);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) acc[mt][nb][0] = acc[mt][nb][1] = acc[mt][nb][2] = acc[mt][nb][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) issue(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    // every thread's copies of tile t are visible, and every warp is done
    // with tile t - 1, whose stage the next issue reuses
    __syncthreads();
    if (t + STAGES - 1 < ntiles) issue((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    const int st = t % STAGES;
    const __nv_bfloat16* ws = Ws + st * BK * LDW;
    const __nv_bfloat16* xs = Xs + st * R * LDX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B fragments of the warp's four 8-column blocks (weight rows are the
      // contraction, so they come transposed)
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_trans(b[h], ws + (kk * 16 + (mat & 1) * 8 + mrow) * LDW + wc + (2 * h + (mat >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, xs + (mt * 16 + mrow + (mat & 1) * 8) * LDX + kk * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16_16816(acc[mt][nb], af, b[nb >> 1][(nb & 1) * 2], b[nb >> 1][(nb & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = mt * 16 + g + 8 * i;
      if (m >= a.M) continue;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int n = n0 + wc + nb * 8 + 2 * t4;
        const float v0 = acc[mt][nb][2 * i], v1 = acc[mt][nb][2 * i + 1];
        if (a.part != nullptr) {
          *reinterpret_cast<float2*>(a.part + split * a.part_stride + (size_t)m * a.Out + n) =
              make_float2(v0, v1);
        } else {
          const size_t o = (size_t)m * a.Out + n;
          const __nv_bfloat16* r = a.res != nullptr ? a.res + o : nullptr;
          a.out[o] = finish(v0, 1.f, r);
          a.out[o + 1] = finish(v1, 1.f, r != nullptr ? r + 1 : nullptr);
        }
      }
    }
  }
}

template <int MT>
static cudaError_t launch_partial(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = smem_bytes<MT>();
  const cudaError_t err = cudaFuncSetAttribute(
      dmm_partial_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dmm_partial_kernel<MT><<<grid, NT, bytes, st>>>(a);
  return cudaSuccess;
}

// One dense dot with its prologue and epilogue, enqueued on `st`.  norm_w:
// rms-norm x first (into the [M, In] scratch xn); gate: w is the gate|up
// projection [In, 2F] and out is [M, F]; res: [M, Out] added in bf16.
// part: [split, M, Out] f32, needed unless split == 1 and no gate.
static cudaError_t run_dmm(const __nv_bfloat16* x, const __nv_bfloat16* w,
                           const __nv_bfloat16* norm_w, const __nv_bfloat16* res,
                           __nv_bfloat16* out, float* part, __nv_bfloat16* xn, int M, int In,
                           int Out, bool gate, int split, float eps, cudaStream_t st) {
  if (M < 1 || In % BK != 0 || Out % BN != 0 || split < 1 || (gate && res != nullptr))
    return cudaErrorInvalidValue;
  const bool direct = split == 1 && !gate;
  if (!direct && part == nullptr) return cudaErrorInvalidValue;
  const int tiles = In / BK;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return cudaErrorInvalidValue;  // an empty split
  if (norm_w != nullptr) {
    if (xn == nullptr) return cudaErrorInvalidValue;
    rms_norm_rows_kernel<<<M, 256, 0, st>>>(x, norm_w, xn, In, eps);
    x = xn;
  }
  for (int m0 = 0; m0 < M; m0 += ROW_GROUP) {
    Args a{};
    a.M = min(ROW_GROUP, M - m0);
    a.x = x + (size_t)m0 * In;
    a.w = w;
    a.res = direct && res != nullptr ? res + (size_t)m0 * Out : nullptr;
    a.out = direct ? out + (size_t)m0 * Out : nullptr;
    a.part = direct ? nullptr : part + (size_t)m0 * Out;
    a.part_stride = (size_t)M * Out;
    a.In = In;
    a.Out = Out;
    a.kchunk = per * BK;
    const dim3 grid(Out / BN, split);
    cudaError_t err;
    if (a.M <= 16)
      err = launch_partial<1>(a, grid, st);
    else if (a.M <= 32)
      err = launch_partial<2>(a, grid, st);
    else if (a.M <= 64)
      err = launch_partial<4>(a, grid, st);
    else
      err = launch_partial<8>(a, grid, st);
    if (err != cudaSuccess) return err;
  }
  if (!direct) {
    const size_t total = (size_t)M * (gate ? Out / 2 : Out);
    qmm_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, split, (size_t)M * Out, nullptr, res, out, M, Out, gate ? 1 : 0);
  }
  return cudaGetLastError();
}

}  // namespace dmm
}  // namespace md

using bf16 = __nv_bfloat16;

// B15 dense_mlp: out = [res +] bf16(gate(rms(x) * norm_w @ w13) @ w2).
// x [M, D]; w13 [D, 2F] (gate columns, then up), w2 [F, D], norm_w [D]; res
// [M, D] or null; scratch hn [M, D], gated [M, F] bf16 and part f32 holding
// the larger phase's splits.  Returns cudaGetLastError().
extern "C" int md_dense_mlp(const void* x, const void* w13, const void* w2, const void* norm_w,
                            const void* res, void* out, void* hn, void* gated, void* part, int M,
                            int D, int F, int split_13, int split_2, float eps, void* stream) {
  using md::dmm::run_dmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const cudaError_t err =
      run_dmm(static_cast<const bf16*>(x), static_cast<const bf16*>(w13),
              static_cast<const bf16*>(norm_w), nullptr, static_cast<bf16*>(gated), p,
              static_cast<bf16*>(hn), M, D, 2 * F, true, split_13, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_dmm(static_cast<const bf16*>(gated), static_cast<const bf16*>(w2), nullptr,
                      static_cast<const bf16*>(res), static_cast<bf16*>(out), p, nullptr, M, F,
                      D, false, split_2, eps, st);
}

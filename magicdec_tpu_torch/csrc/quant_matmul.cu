// B5, B9: the int8 weight-only dots of the draft's weight copy that run
// several dots a call, and B4-int4, B6-int4: its group-wise int4 dots.  B4
// and B6 (one int8 dot a call) run on quant_matmul_sm90.cu.
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py quant_layer_tail_pallas
// (_layer_tail_kernel: B5), quant_mlp_pallas (_mlp_kernel: B9, the FFN block
// alone, which the draft takes where B5 declines), quant_matmul_fused_pallas
// (nibble-plane branch: B4-int4) and quant_matmul_pallas (_int4_kernel:
// B6-int4).
// Each dot computes y = x[M, In] @ q[In, Out] * scale[Out]: bf16 x, int8 q
// with one f32 scale per output column, f32 accumulation, then the
// reference's epilogue: bf16(acc * scale), the same after an rms-norm of x,
// or as bf16(g * sigmoid(g) * u) over the gate|up halves of q, or plus a
// bf16 residual; B5 is a draft layer's whole post-attention tail,
//   h = x + bf16(a @ wo * so);  gated = gate(rms(h) * ffn_norm @ w13 * s13);
//   out = h + bf16(gated @ w2 * s2).
//
// Bound: HBM bytes of the int8 weight.  At M <= 256 rows a weight byte feeds
// 2M flops, far below the ~295 flop/byte at which the bf16 tensor cores
// limit, so the design is about streaming q at full bandwidth:
// - qmm_partial_kernel: a block owns BN = 128 output columns and a range of
//   the contraction (split-K, fixed by the wrapper from In and Out so that
//   narrow matrices still fill the 132 SMs); warp w of 4 owns the 32 columns
//   [32w, 32w + 32).  int8 weight tiles of BK = 64 rows and the matching x
//   tiles land by 16-byte cp.async, STAGES = 4 deep; each lane converts the
//   int8 chunks it copied itself to bf16 (i8x4_to_bf16x4: exact, byte
//   permutes and float adds, no conversion unit) into its warp's columns of a
//   bf16 tile, so the conversion needs no block barrier; ldmatrix (.trans
//   for the weight) feeds mma.sync m16n8k16, bf16 in, f32 accumulate.  Rows
//   are tiled by 16 (MT tiles, at most 128 rows a launch).
// - With one split and no gate the block finishes in registers.  Otherwise
//   each split writes f32 partial sums and qmm_epilogue_kernel adds them in
//   split order (no atomics, so the draft's tokens are the same on every
//   run) and applies scale, gate or residual; the gate pairs column n with
//   column F + n of the same partials.
// - rms_norm_rows_kernel: the norm prologue, once per dot, into a bf16
//   scratch that the dot then streams (the row statistic needs whole rows).
// - B5 enqueues its three phases from one entry point: phase 2 needs all of
//   h, so the phase boundaries are launch boundaries.  B9 is B5's phases 2
//   and 3 (the residual optional).
// - qmm4_partial_kernel (B4-int4, B6-int4): q packs contraction rows 2r
//   (low nibble) and 2r + 1 (high nibble) of column n in byte [r, n], with
//   one f32 scale per group of `group` contraction rows and column
//   ([In / group, Out]).  The reference computes acc += f32(x_g . q_g) * s_g
//   group by group, then casts once.  The same tile routine with BK4 = 128
//   contraction rows (64 packed rows, 8 KB a stage, as the int8 stage) a
//   stage, the group scales of the stage staged beside them: each lane
//   unpacks the packed chunks it copied into rows 2r and 2r + 1 of its
//   warp's bf16 tile (i4x4_to_bf16x4: exact), so x is contracted as it is
//   (the TPU kernel splits x into even and odd columns because Mosaic cannot
//   re-slice lanes: the same sum in another f32 order).  Each group's
//   products go to a fresh f32 fragment, scaled and added when the group
//   ends; splits and tiles start on group boundaries.  The epilogue is B4's
//   with the scale already applied (no norm: the reference norms int4 x
//   outside the kernel).
// - cudaFuncSetAttribute runs once per kernel instantiation, not per launch.
#include "attention_common.cuh"
#include "matmul_common.cuh"

namespace md {
namespace qmm {

struct Args {
  const __nv_bfloat16* x;    // [M, In], the launch's rows
  const int8_t* q;           // [In, Out]
  const float* scale;        // [Out]
  const __nv_bfloat16* res;  // [M, Out] or null
  __nv_bfloat16* out;        // [M, Out] when the block finishes (part == null)
  float* part;               // [split, Mtot, Out] partial sums, or null
  size_t part_stride;        // elements between splits (Mtot * Out)
  int M, In, Out, kchunk;
  int group;                 // int4: contraction rows per scale group
};

template <int MT>
constexpr int smem_bytes() {
  return STAGES * MT * 16 * LDX * 2 + STAGES * BK * BN + BK * LDW * 2;
}

// Grid (Out / BN, split), NT threads.  Split s covers contraction rows
// [s * kchunk, min(In, (s + 1) * kchunk)).
template <int MT>
__global__ void __launch_bounds__(NT) qmm_partial_kernel(Args a) {
  constexpr int R = MT * 16;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + STAGES * R * LDX * 2);
  __nv_bfloat16* Wb = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * R * LDX * 2 + STAGES * BK * BN);

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
  // zero-filled) and the warp's 32 weight columns, two 16-byte chunks a row,
  // chunk i = lane + 32 j of the warp (the same chunks convert() reads)
  auto issue = [&](int st, int t) {
    const int kt = k0 + t * BK;
    __nv_bfloat16* xs = Xs + st * R * LDX;
    for (int i = threadIdx.x; i < R * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c8 = i % (BK / 8);
      const bool valid = r < a.M;
      cp_async16(xs + r * LDX + c8 * 8, valid ? a.x + (size_t)r * a.In + kt + c8 * 8 : a.x,
                 valid);
    }
    int8_t* qs = Qs + st * BK * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j, r = i >> 1, c = wc + (i & 1) * 16;
      cp_async16(qs + r * BN + c, a.q + (size_t)(kt + r) * a.Out + n0 + c, true);
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
    const int8_t* qs = Qs + st * BK * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j, r = i >> 1, c = wc + (i & 1) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + r * BN + c);
      uint32_t w[8];
      i8x4_to_bf16x4(raw.x, w[0], w[1]);
      i8x4_to_bf16x4(raw.y, w[2], w[3]);
      i8x4_to_bf16x4(raw.z, w[4], w[5]);
      i8x4_to_bf16x4(raw.w, w[6], w[7]);
      uint4* d = reinterpret_cast<uint4*>(Wb + r * LDW + c);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncwarp();  // the warp's converted columns, for its lanes' ldmatrix
    const __nv_bfloat16* xs = Xs + st * R * LDX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B fragments of the warp's four 8-column blocks (weight rows are the
      // contraction, so they come transposed)
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_trans(b[h], Wb + (kk * 16 + (mat & 1) * 8 + mrow) * LDW + wc + (2 * h + (mat >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, xs + (mt * 16 + mrow + (mat & 1) * 8) * LDX + kk * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16_16816(acc[mt][nb], af, b[nb >> 1][(nb & 1) * 2], b[nb >> 1][(nb & 1) * 2 + 1]);
      }
    }
    __syncwarp();  // the next tile's conversion overwrites the warp's columns
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
          a.out[o] = finish(v0, a.scale[n], r);
          a.out[o + 1] = finish(v1, a.scale[n + 1], r != nullptr ? r + 1 : nullptr);
        }
      }
    }
  }
}

template <int MT>
static cudaError_t launch_partial(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = smem_bytes<MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_partial_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  qmm_partial_kernel<MT><<<grid, NT, bytes, st>>>(a);
  return cudaSuccess;
}

// One dequant dot with its prologue and epilogue, enqueued on `st`.
// norm_w: rms-norm x first (into the [M, In] scratch xn); gate: q is the
// gate|up projection [In, 2F] and out is [M, F]; res: [M, Out] added in
// bf16.  part: [split, M, Out] f32, needed unless split == 1 and no gate.
static cudaError_t run_qmm(const __nv_bfloat16* x, const int8_t* q, const float* scale,
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
    a.q = q;
    a.scale = scale;
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
        part, split, (size_t)M * Out, scale, res, out, M, Out, gate ? 1 : 0);
  }
  return cudaGetLastError();
}

// ---- int4 ----------------------------------------------------------------

constexpr int BK4 = 128;            // contraction rows per int4 stage (64 packed rows)
constexpr int LDX4 = BK4 + 8;       // bf16 x tile row stride (elements)
constexpr int MAX_GROUPS4 = BK4 / 32;  // scale rows a stage holds (group 32)
constexpr int ROW_GROUP4 = 64;      // rows a launch takes (two f32 accumulators)

template <int MT>
constexpr int smem_bytes4() {
  return STAGES * MT * 16 * LDX4 * 2 + STAGES * (BK4 / 2) * BN + STAGES * MAX_GROUPS4 * BN * 4 +
         BK4 * LDW * 2;
}

// Grid (Out / BN, split), NT threads.  Split s covers contraction rows
// [s * kchunk, min(In, (s + 1) * kchunk)), kchunk a multiple of the group
// and of BK4.  a.scale is [In / group, Out].
template <int MT>
__global__ void __launch_bounds__(NT) qmm4_partial_kernel(Args a) {
  constexpr int R = MT * 16;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kXBytes = STAGES * R * LDX4 * 2, kQBytes = STAGES * (BK4 / 2) * BN;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + kXBytes);
  float* Ss = reinterpret_cast<float*>(smem + kXBytes + kQBytes);
  __nv_bfloat16* Wb =
      reinterpret_cast<__nv_bfloat16*>(smem + kXBytes + kQBytes + STAGES * MAX_GROUPS4 * BN * 4);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int k0 = split * a.kchunk;
  const int k1 = min(a.In, k0 + a.kchunk);
  const int ntiles = k1 > k0 ? (k1 - k0) / BK4 : 0;
  const int wc = warp * 32;  // the warp's first column in the block's tile
  const int gs = a.group;
  const int ng = gs >= BK4 ? 1 : BK4 / gs;  // groups a stage spans (or lies in)

  // start copying contraction tile t into stage st: the x rows (rows past M
  // zero-filled), the warp's 32 columns of the 64 packed weight rows (chunk
  // i = lane + 32 j, as the unpacking reads them), and the warp's 32 scales
  // of each group the stage touches
  auto issue = [&](int st, int t) {
    const int kt = k0 + t * BK4;
    __nv_bfloat16* xs = Xs + st * R * LDX4;
    for (int i = threadIdx.x; i < R * (BK4 / 8); i += NT) {
      const int r = i / (BK4 / 8), c8 = i % (BK4 / 8);
      const bool valid = r < a.M;
      cp_async16(xs + r * LDX4 + c8 * 8, valid ? a.x + (size_t)r * a.In + kt + c8 * 8 : a.x,
                 valid);
    }
    int8_t* qs = Qs + st * (BK4 / 2) * BN;
    const int8_t* qg = a.q + (size_t)(kt / 2) * a.Out + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j, r = i >> 1, c = wc + (i & 1) * 16;
      cp_async16(qs + r * BN + c, qg + (size_t)r * a.Out + c, true);
    }
    if (lane < 8 * ng) {
      const int j = lane >> 3, c = wc + (lane & 7) * 4;
      cp_async16(Ss + (st * MAX_GROUPS4 + j) * BN + c,
                 a.scale + (size_t)(kt / gs + j) * a.Out + n0 + c, true);
    }
  };

  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = part[mt][nb][e] = 0.f;

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
    const int kt = k0 + t * BK4;
    const int8_t* qs = Qs + st * (BK4 / 2) * BN;
    // packed row r -> rows 2r (low nibbles) and 2r + 1 (high nibbles) of the
    // warp's columns of the bf16 tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = lane + 32 * j, r = i >> 1, c = wc + (i & 1) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(qs + r * BN + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        i4x4_to_bf16x4(words[k], 0, lo[2 * k], lo[2 * k + 1]);
        i4x4_to_bf16x4(words[k], 4, hi[2 * k], hi[2 * k + 1]);
      }
      uint4* d0 = reinterpret_cast<uint4*>(Wb + (2 * r) * LDW + c);
      uint4* d1 = reinterpret_cast<uint4*>(Wb + (2 * r + 1) * LDW + c);
      d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncwarp();  // the warp's unpacked columns, for its lanes' ldmatrix
    const __nv_bfloat16* xs = Xs + st * R * LDX4;
    const float* ss = Ss + st * MAX_GROUPS4 * BN + wc;
#pragma unroll
    for (int kk = 0; kk < BK4 / 16; ++kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4_trans(b[h], Wb + (kk * 16 + (mat & 1) * 8 + mrow) * LDW + wc + (2 * h + (mat >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, xs + (mt * 16 + mrow + (mat & 1) * 8) * LDX4 + kk * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16_16816(part[mt][nb], af, b[nb >> 1][(nb & 1) * 2], b[nb >> 1][(nb & 1) * 2 + 1]);
      }
      if (((kt + (kk + 1) * 16) & (gs - 1)) == 0) {
        // the group ends here: its f32 partial sums, scaled, into acc
        const float* srow = ss + (gs >= BK4 ? 0 : (kk * 16) / gs) * BN;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float2 sv = *reinterpret_cast<const float2*>(srow + nb * 8 + 2 * t4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nb][0] += part[mt][nb][0] * sv.x;
            acc[mt][nb][1] += part[mt][nb][1] * sv.y;
            acc[mt][nb][2] += part[mt][nb][2] * sv.x;
            acc[mt][nb][3] += part[mt][nb][3] * sv.y;
            part[mt][nb][0] = part[mt][nb][1] = part[mt][nb][2] = part[mt][nb][3] = 0.f;
          }
        }
      }
    }
    __syncwarp();  // the next tile's unpacking overwrites the warp's columns
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
static cudaError_t launch_partial4(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = smem_bytes4<MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm4_partial_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  qmm4_partial_kernel<MT><<<grid, NT, bytes, st>>>(a);
  return cudaSuccess;
}

// One group-wise int4 dot with B4's gate or residual epilogue (or none),
// enqueued on `st`.  q packed [In / 2, Out], scale [In / group, Out]; group
// a power of two >= 32; the splits cut the contraction in units of
// max(group, BK4) rows.  part: [split, M, Out] f32, needed unless split == 1
// and no gate.
static cudaError_t run_qmm4(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                            const __nv_bfloat16* res, __nv_bfloat16* out, float* part, int M,
                            int In, int Out, bool gate, int split, int group, cudaStream_t st) {
  if (M < 1 || Out % BN != 0 || split < 1 || (gate && res != nullptr) || group < 32 ||
      (group & (group - 1)) != 0)
    return cudaErrorInvalidValue;
  const int unit = max(group, BK4);
  if (In % unit != 0) return cudaErrorInvalidValue;
  const bool direct = split == 1 && !gate;
  if (!direct && part == nullptr) return cudaErrorInvalidValue;
  const int tiles = In / unit;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return cudaErrorInvalidValue;  // an empty split
  for (int m0 = 0; m0 < M; m0 += ROW_GROUP4) {
    Args a{};
    a.M = min(ROW_GROUP4, M - m0);
    a.x = x + (size_t)m0 * In;
    a.q = q;
    a.scale = scale;
    a.res = direct && res != nullptr ? res + (size_t)m0 * Out : nullptr;
    a.out = direct ? out + (size_t)m0 * Out : nullptr;
    a.part = direct ? nullptr : part + (size_t)m0 * Out;
    a.part_stride = (size_t)M * Out;
    a.In = In;
    a.Out = Out;
    a.kchunk = per * unit;
    a.group = group;
    const dim3 grid(Out / BN, split);
    cudaError_t err;
    if (a.M <= 16)
      err = launch_partial4<1>(a, grid, st);
    else if (a.M <= 32)
      err = launch_partial4<2>(a, grid, st);
    else
      err = launch_partial4<4>(a, grid, st);
    if (err != cudaSuccess) return err;
  }
  if (!direct) {
    const size_t total = (size_t)M * (gate ? Out / 2 : Out);
    qmm_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, split, (size_t)M * Out, nullptr, res, out, M, Out, gate ? 1 : 0);
  }
  return cudaGetLastError();
}

}  // namespace qmm
}  // namespace md

using bf16 = __nv_bfloat16;

// B5: the draft layer's tail.  a [M, K] attention output, x [M, D] residual;
// qo [K, D] / so [D], q13 [D, 2F] / s13 [2F], q2 [F, D] / s2 [D], norm_w
// [D]; scratch h, hn [M, D] and gated [M, F] bf16, part f32 holding the
// largest phase's splits; out [M, D].  Returns cudaGetLastError().
extern "C" int md_quant_layer_tail(const void* a, const void* x, const void* qo, const void* so,
                                   const void* q13, const void* s13, const void* q2,
                                   const void* s2, const void* norm_w, void* out, void* h,
                                   void* hn, void* gated, void* part, int M, int K, int D, int F,
                                   int split_o, int split_13, int split_2, float eps,
                                   void* stream) {
  using md::qmm::run_qmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t err = run_qmm(static_cast<const bf16*>(a), static_cast<const int8_t*>(qo),
                            static_cast<const float*>(so), nullptr,
                            static_cast<const bf16*>(x), static_cast<bf16*>(h), p, nullptr, M,
                            K, D, false, split_o, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = run_qmm(static_cast<const bf16*>(h), static_cast<const int8_t*>(q13),
                static_cast<const float*>(s13), static_cast<const bf16*>(norm_w), nullptr,
                static_cast<bf16*>(gated), p, static_cast<bf16*>(hn), M, D, 2 * F, true,
                split_13, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_qmm(static_cast<const bf16*>(gated), static_cast<const int8_t*>(q2),
                      static_cast<const float*>(s2), nullptr, static_cast<const bf16*>(h),
                      static_cast<bf16*>(out), p, nullptr, M, F, D, false, split_2, eps, st);
}

// B9: out = [res +] bf16(gate(rms(x) * norm_w @ q13 * s13) @ q2 * s2).
// x [M, D]; q13 [D, 2F] / s13 [2F], q2 [F, D] / s2 [D], norm_w [D]; res
// [M, D] or null; scratch hn [M, D], gated [M, F] bf16 and part f32 holding
// the larger phase's splits.  Returns cudaGetLastError().
extern "C" int md_quant_mlp(const void* x, const void* q13, const void* s13, const void* q2,
                            const void* s2, const void* norm_w, const void* res, void* out,
                            void* hn, void* gated, void* part, int M, int D, int F,
                            int split_13, int split_2, float eps, void* stream) {
  using md::qmm::run_qmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const cudaError_t err =
      run_qmm(static_cast<const bf16*>(x), static_cast<const int8_t*>(q13),
              static_cast<const float*>(s13), static_cast<const bf16*>(norm_w), nullptr,
              static_cast<bf16*>(gated), p, static_cast<bf16*>(hn), M, D, 2 * F, true,
              split_13, eps, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_qmm(static_cast<const bf16*>(gated), static_cast<const int8_t*>(q2),
                      static_cast<const float*>(s2), nullptr, static_cast<const bf16*>(res),
                      static_cast<bf16*>(out), p, nullptr, M, F, D, false, split_2, eps, st);
}

// B4-int4 and B6-int4: out = epilogue(x[M, In] @ dequant(q[In / 2, Out],
// scale[In / group, Out])), the epilogue the SiLU gate (gate: out [M, Out / 2])
// or a residual res [M, Out] (or null), or none.  part may be null (see
// run_qmm4).  Returns cudaGetLastError().
extern "C" int md_quant_matmul_int4(const void* x, const void* q, const void* scale,
                                    const void* res, void* out, void* part, int M, int In,
                                    int Out, int gate, int split, int group, void* stream) {
  return (int)md::qmm::run_qmm4(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const bf16*>(res), static_cast<bf16*>(out),
      static_cast<float*>(part), M, In, Out, gate != 0, split, group,
      static_cast<cudaStream_t>(stream));
}

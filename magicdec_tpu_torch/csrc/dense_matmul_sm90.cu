// B15 dense_matmul_fused on Hopper: the target's bf16 weight-streaming dots
// (wqkv and w13 with the rms-norm, wo and w2 with the residual), one launch a
// call.
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py dense_matmul_fused_pallas
// (_dense_fused_kernel): y = [res +] bf16(norm?(x)[M, In] @ w[In, Out]) with
// bf16 x and w, f32 sums, the norm bf16(bf16(x * rsqrt(mean(x^2) + eps)) *
// norm_w), the residual added in bf16.  (dense_mlp, the whole FFN block,
// is a bf16 instance of ffn_sm90.cu's persistent kernel.)
//
// Bound: the weight's HBM bytes at the decode and verify rows.  A bf16
// weight byte feeds M flops: at M = 128 (decode_rows at B = 32, gamma = 3)
// the products take ~40% of the byte time at the wgmma peak, and past M ~
// 295 the tensor cores limit; so the weight streams at HBM rate, the
// products run on wgmma, and nothing else leaves the chip.
//
// - One launch.  A block owns a tile of NBOX 64-column boxes and one split
//   of the contraction; the splits of a tile form a thread-block cluster (1,
//   split, 1), split <= 8 (the wrapper's plan stops at 5), and (split, NBOX)
//   come from the weight's shape and the norm, never from M
//   (kernels/dense_matmul.py dense_plan: NBOX = 4 with the norm, whose
//   statistic, like the x tiles, every column tile's cluster reads from L2).
//   Clusters walk the column tiles; rows past 128 run as further passes.
// - Weight by TMA: bf16 boxes of 64 columns x 64 contraction rows (8 KB,
//   128-byte swizzle) and the x tile [R rows, 64] (128-byte swizzle; rows
//   past M arrive as zeros) on an mbarrier ring fed by one producer lane.
//   The weight's tensor map (sm90_common.cuh bf16_weight_map) is encoded
//   once per (pointer, shape) and cached, x's per call; a failed encode returns an error (the wrapper raises).
// - Products on wgmma m64n64k16, one per box and k16 step: x the K-major A
//   operand from the stage, the weight the MN-major B operand straight from
//   its TMA box (no conversion, no producer arithmetic).  A consumer
//   warpgroup takes 64 rows (R = 64 at M <= 64, else two warpgroups).  One
//   stage's products stay in flight while the next stage is normalized and
//   issued; the stage is released when its products are done.
// - The norm inside the kernel, as B4's: each rank sums the squares of its
//   own contraction range of every row in a fixed order, every rank gets
//   every rank's partials by st.async and adds them in rank order (every
//   block of a row holds the same statistic bit for bit); each warpgroup
//   normalizes its rows of each x tile in shared memory as it lands.
// - Split-K reduced on chip: the tile's accumulators are cut in units (one
//   warp's 64 columns of one box, 4 KB) shared out among the ranks; after a
//   cluster barrier (every rank's ring is idle) each rank stores its f32
//   partial of a unit into the owner's ring by st.async, and the owner adds
//   the ranks' partials in split order and finishes (no atomics, no f32
//   partials in HBM).  A second barrier hands the ring back to the loads.
//   Units whose rows all lie past M are neither sent nor awaited.
// - Row invariance: a row's bits depend on its own data only: one
//   instruction shape at every M, each rank's k-steps in order, the split
//   from the weight's shape and its partials added in split order, the norm
//   statistic in a fixed order.  The rows of an M = 16 call equal the same
//   rows of an M = 128 call bit for bit (the greedy spec == AR contract: the
//   AR step pads its rows to decode_rows, verify fills them).
#include <tuple>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace dsm90 {

using namespace md::sm90;

constexpr int BKD = 64;        // contraction rows a stage: one 128-byte swizzle row of bf16
constexpr int BOX = 64;        // weight columns a TMA box
constexpr int MAX_ROWS = 512;  // the dense routing's row cap (quantization.py)
constexpr int MAX_SPLIT = 8;   // the portable cluster size
constexpr int UNIT = 32 * 32 * 4;  // one warp's accumulators of one box: 4 KB

template <int NWG, int NBOX>
struct DCfg {
  static constexpr int R = 64 * NWG;  // x rows a pass
  static constexpr int BN = BOX * NBOX;
  static constexpr int NCW = 4 * NWG;  // consumer warps
  static constexpr int NTHREADS = 32 * (NCW + 1);
  static constexpr int W_BYTES = BKD * BOX * 2;  // one weight box, 8 KB
  static constexpr int X_BYTES = R * BKD * 2;    // the x tile, 128 bytes a row
  static constexpr int STAGE = NBOX * W_BYTES + X_BYTES;
  static constexpr int STAGES = NWG == 1 ? (NBOX == 2 ? 6 : 4) : (NBOX == 2 ? 5 : 4);
  static constexpr int RING = STAGES * STAGE;
  // the receive area of the reduction reuses the ring: ceil(U / split) *
  // split units at most, U = the tile's units
  static constexpr int UNITS = NCW * NBOX;
  static_assert(RING >= (UNITS + MAX_SPLIT - 1) * UNIT, "the ring holds the receive area");
  // full[STAGES], empty[STAGES], stat, red
  static constexpr int BARS = RING;
  static constexpr int SSQ = BARS + 16 * STAGES + 16;  // [MAX_SPLIT][MAX_ROWS] f32
  static constexpr int RR = SSQ + 4 * MAX_SPLIT * MAX_ROWS;
  static constexpr int NW = RR + 4 * MAX_ROWS;  // the norm weight's BKD values a stage
  static constexpr int SMEM = NW + STAGES * BKD * 2 + 1024;  // + slack to align to 1024
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

struct DArgs {
  CUtensorMap wmap;             // w [In, Out] bf16, box {BOX, BKD}, 128-byte swizzle
  CUtensorMap xmap;             // x [M, In] bf16, box {BKD, R}, 128-byte swizzle
  const __nv_bfloat16* x;       // [M, In], for the norm's statistic
  const __nv_bfloat16* norm_w;  // [In] or null
  const __nv_bfloat16* res;     // [M, Out] or null
  __nv_bfloat16* out;           // [M, Out]
  int M, In, Out, kchunk, ntiles;
  float eps;
};

namespace {

// D (+)= A B over one k16 step: m64n64k16, A (x) K-major and B (a weight
// box) MN-major from shared memory, both 128-byte swizzled; f32 accumulators
// in the D fragment layout (d[4j + e]: row 16 warp + g + 8 (e / 2), column
// 8 j + 2 t4 + e % 2).
__device__ __forceinline__ void wgmma_x_w(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The epilogue of one unit: v in the D fragment layout of warp `wq` of
// warpgroup `wg`, box `box` of tile t, rows from m0; bf16(v) [+ res in bf16].
template <int NBOX>
__device__ __forceinline__ void finish_unit(const DArgs& a, int t, int m0, int wg, int wq,
                                            int box, int lane, const float (&v)[32]) {
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = t * BOX * NBOX + box * BOX + 2 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * wq + g + 8 * h;
    if (m >= a.M) continue;
    const size_t row = (size_t)m * a.Out + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y0 = __bfloat162float(__float2bfloat16(v[4 * j + 2 * h]));
      float y1 = __bfloat162float(__float2bfloat16(v[4 * j + 2 * h + 1]));
      if (a.res != nullptr) {
        const float2 r =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.res + row + 8 * j));
        y0 += r.x;
        y1 += r.y;
      }
      *reinterpret_cast<uint32_t*>(a.out + row + 8 * j) = pack_bf16x2(y0, y1);
    }
  }
}

}  // namespace

// Grid (clusters, split), cluster (1, split, 1), NTHREADS threads: warps
// 0..NCW-1 consume (warpgroup w: rows 64 w .. 64 w + 63 of a pass), warp NCW
// produces.  Rank s of a cluster covers contraction rows [s * kchunk,
// min(In, (s + 1) * kchunk)).
template <int NWG, int NBOX>
__global__ void __launch_bounds__(DCfg<NWG, NBOX>::NTHREADS, 1)
    dmm_sm90_kernel(const __grid_constant__ DArgs a) {
  using C = DCfg<NWG, NBOX>;
  constexpr int R = C::R, S = C::STAGES, NCW = C::NCW;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  float* ssq = reinterpret_cast<float*>(smem + C::SSQ);
  float* rr = reinterpret_cast<float*>(smem + C::RR);
  // full[s] at 8 s, empty[s] at 8 (S + s), stat at 16 S, red at 16 S + 8
  const uint32_t bars = sbase + C::BARS;
  const uint32_t stat_bar = bars + 16 * S, red_bar = stat_bar + 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int split = gridDim.y;
  const int k0 = (int)rank * a.kchunk;
  const int k1 = min(a.In, k0 + a.kchunk);
  const int nk = (k1 - k0) / BKD;
  const int npass = (a.M + R - 1) / R;
  const bool norm = a.norm_w != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);               // the producer's expect_tx
      mbar_init(bars + 8 * (S + s), NCW * 32);  // every consumer thread
    }
    mbar_init(stat_bar, 1);
    mbar_init(red_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // every rank's partial sum of squares of every row
    if (norm) mbar_expect_tx(stat_bar, split * a.M * 4);
  }
  __syncthreads();
  // the ranks' barriers must be initialized before the first remote store:
  // arrive now, wait just before it
  cluster_arrive_relaxed();

  if (warp == NCW) {
    // ---- producer: one lane issues the TMA loads ----------------------------
    if (lane != 0) {
      cluster_wait();
      return;
    }
    prefetch_map(&a.wmap);
    prefetch_map(&a.xmap);
    cluster_wait();
    int it = 0;
    // with the norm, the loads start once this rank holds the statistic's
    // partials: the statistic's own loads of x would queue behind the ring's
    if (norm) mbar_wait(stat_bar, 0);
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      for (int p = 0; p < npass; ++p) {
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % S;
          mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);  // the consumers released it
          const uint32_t full = bars + 8 * s;
          mbar_expect_tx(full, NBOX * C::W_BYTES + C::X_BYTES + (norm ? BKD * 2 : 0));
          const uint32_t st = sbase + s * C::STAGE;
          const int kt = k0 + i * BKD;
          if (norm) bulk_load(sbase + C::NW + s * BKD * 2, a.norm_w + kt, BKD * 2, full);
#pragma unroll
          for (int b = 0; b < NBOX; ++b)
            tma_load_2d(st + b * C::W_BYTES, &a.wmap, full, t * C::BN + b * BOX, kt);
          tma_load_2d(st + NBOX * C::W_BYTES, &a.xmap, full, kt, p * R);
        }
        // the ring is the receive area of the item's reduction: no loads
        // until every owner has read it (the consumers' two barriers)
        const bool last = p + 1 == npass && t + (int)gridDim.x >= a.ntiles;
        if (split > 1 && !last) {
          cluster_sync();
          cluster_sync();
        }
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int tid = threadIdx.x;  // 0 .. NCW * 32 - 1
  const int wg = warp >> 2, wq = warp & 3;
  if (norm)
    row_norm_factors<NCW>(a.x, a.M, a.In, k0, k1, a.eps, MAX_ROWS, ssq, rr, stat_bar, rank, split);
  else
    cluster_wait();

  int it = 0, red_phase = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    for (int p = 0; p < npass; ++p) {
      const int m0 = p * R;
      const int mp = min(R, a.M - m0);
      // units u = (warp, box) = (16 rows, 64 columns); those holding a row
      // below M are live: u < nlive
      const int nlive = ((mp + 15) / 16) * NBOX;
      const int owned = max(0, (nlive - (int)rank + split - 1) / split);
      float acc[NBOX][32];
#pragma unroll
      for (int b = 0; b < NBOX; ++b)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[b][e] = 0.f;
      int prev = -1;
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % S;
        mbar_wait(bars + 8 * s, (it / S) & 1);  // the stage's boxes have landed
        const uint32_t st = sbase + s * C::STAGE;
        const uint32_t xwg = st + NBOX * C::W_BYTES + wg * 64 * 128;  // this warpgroup's rows
        // every warpgroup issues its products, also on rows past M (zeros):
        // a wgmma or a first read of its accumulators on a divergent path
        // makes ptxas serialize every wgmma of the kernel
        if (norm) {
          // normalize this warpgroup's rows in place; chunk (row r,
          // physical chunk pc) holds logical columns 8 (pc ^ (r % 8)) .. + 7
          uint8_t* xs = smem + (xwg - sbase);
          const uint8_t* nw = smem + C::NW + s * BKD * 2;
          for (int j = tid & 127; j < 64 * 8; j += 128) {
            const int r = j >> 3, pc = j & 7, m = m0 + 64 * wg + r;
            if (m >= a.M) continue;
            uint4* cp = reinterpret_cast<uint4*>(xs + r * 128 + pc * 16);
            const uint4 wv = *reinterpret_cast<const uint4*>(nw + ((pc ^ (r & 7)) << 4));
            const float f = rr[m];
            uint4 v = *cp;
            v.x = norm_pair(v.x, wv.x, f);
            v.y = norm_pair(v.y, wv.y, f);
            v.z = norm_pair(v.z, wv.z, f);
            v.w = norm_pair(v.w, wv.w, f);
            *cp = v;
          }
          fence_proxy_async();  // the normalized rows before wgmma reads them
          asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        }
        const uint64_t da = smem_desc(xwg, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKD / 16; ++kk)
#pragma unroll
          for (int b = 0; b < NBOX; ++b)
            wgmma_x_w(acc[b], da + 2 * kk,
                      smem_desc(st + b * C::W_BYTES, 1024, 1024) + 128 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NBOX; ++b) fence_regs(acc[b]);
      if (prev >= 0) mbar_arrive(bars + 8 * (S + prev));

      if (split == 1) {
#pragma unroll
        for (int b = 0; b < NBOX; ++b) finish_unit<NBOX>(a, t, m0, wg, wq, b, lane, acc[b]);
        continue;
      }
      // every rank's ring is idle: it becomes the receive area.  Unit u is
      // reduced and finished by rank u % split: each rank stores its partial
      // into slot [(u / split) * split + rank] of that rank's ring,
      // completing on its red barrier, and the owner adds the slots in split
      // order.
      fence_proxy_async();
      cluster_sync();
      if (owned > 0 && tid == 0) mbar_expect_tx(red_bar, owned * split * UNIT);
#pragma unroll
      for (int b = 0; b < NBOX; ++b) {
        const int u = warp * NBOX + b;
        if (u >= nlive) continue;
        const uint32_t dst =
            rank_addr(sbase, u % split) + ((u / split) * split + (int)rank) * UNIT + lane * 16;
        const uint32_t bar = rank_addr(red_bar, u % split);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float v[4] = {acc[b][4 * q], acc[b][4 * q + 1], acc[b][4 * q + 2],
                              acc[b][4 * q + 3]};
          st_async_f32x4(dst + q * 512, v, bar);
        }
      }
      if (owned > 0) {
        mbar_wait(red_bar, red_phase & 1);  // every rank's partials of this rank's units
        ++red_phase;
      }
      for (int j = warp; j < owned; j += NCW) {
        const int u = (int)rank + split * j;
        const float4* slot = reinterpret_cast<const float4*>(smem + j * split * UNIT) + lane;
        float v[32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 f = slot[q * 32];
          v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
        }
        for (int r = 1; r < split; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 f = slot[(r * UNIT) / 16 + q * 32];
            v[4 * q] += f.x, v[4 * q + 1] += f.y, v[4 * q + 2] += f.z, v[4 * q + 3] += f.w;
          }
        const int w = u / NBOX;
        finish_unit<NBOX>(a, t, m0, w >> 2, w & 3, u % NBOX, lane, v);
      }
      // the owners have read their receive areas: the ring goes back to the
      // loads
      const bool last = p + 1 == npass && t + (int)gridDim.x >= a.ntiles;
      if (!last) {
        fence_proxy_async();
        cluster_sync();
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <int NWG, int NBOX>
static cudaError_t launch(DArgs& a, int split, cudaStream_t st) {
  using C = DCfg<NWG, NBOX>;
  // once per instantiation: the attribute, and the blocks an SM holds
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmm_sm90_kernel<NWG, NBOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dmm_sm90_kernel<NWG, NBOX>,
                                                  C::NTHREADS, C::SMEM);
    return max(1, sms * max(1, per_sm));
  }();
  const CUresult enc = encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, 2, a.In, a.M,
                                 BKD, C::R, CU_TENSOR_MAP_SWIZZLE_128B);
  if (enc != CUDA_SUCCESS) return static_cast<cudaError_t>(kEncodeError + enc);
  a.ntiles = a.Out / C::BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(a.ntiles, max(1, resident / split)), split, 1);
  cfg.blockDim = dim3(C::NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dmm_sm90_kernel<NWG, NBOX>, a);
}

}  // namespace dsm90
}  // namespace md

// B15 dense_matmul_fused: out = [res +] bf16(norm?(x)[M, In] @ w[In, Out])
// in one launch.  x [M, In], w [In, Out], norm_w [In] (or null), res [M,
// Out] (or null), out [M, Out], all bf16; split: the contraction's splits
// (1..8, none empty) and nbox: 64-column boxes a tile (2 or 4), both the
// wrapper's dense_plan.  Returns cudaGetLastError(),
// or 0x10000 + the CUresult of a failed tensor-map encode.
extern "C" int md_dense_matmul_sm90(const void* x, const void* w, const void* norm_w,
                                    const void* res, void* out, int M, int In, int Out,
                                    int split, int nbox, float eps, void* stream) {
  using namespace md::dsm90;
  if (M < 1 || M > MAX_ROWS || In % BKD != 0 || (nbox != 2 && nbox != 4) ||
      Out % (BOX * nbox) != 0 || split < 1 || split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const int tiles = In / BKD;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return (int)cudaErrorInvalidValue;  // an empty split
  DArgs a;
  const CUresult enc = bf16_weight_map(&a.wmap, w, In, Out);  // box {BOX, BKD}
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.In = In;
  a.Out = Out;
  a.kchunk = per * BKD;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 64)
    err = nbox == 2 ? launch<1, 2>(a, split, st) : launch<1, 4>(a, split, st);
  else
    err = nbox == 2 ? launch<2, 2>(a, split, st) : launch<2, 4>(a, split, st);
  if ((int)err >= kEncodeError) return (int)err;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

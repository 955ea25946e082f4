// B4 and B6 on Hopper: the draft's int8 weight-streaming dots, one launch a
// call.
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py quant_matmul_pallas
// (_int8_kernel: B6, the draft's int8 lm_head) and quant_matmul_fused_pallas
// (_fused_kernel, int8 branch: B4, the draft's wqkv with its rms-norm, w13
// with the SiLU gate, w2 or wo with a residual).  Both compute
//   y = epilogue(norm?(x)[M, In] @ q[In, Out] * scale[Out])
// with bf16 x, int8 q, one f32 scale per output column and f32 sums; the
// epilogue is bf16(acc * scale) [+ res in bf16], or bf16(g * sigmoid(g) * u)
// over the bf16-rounded gate and up halves of q; the norm is
// bf16(bf16(x * rsqrt(mean(x^2) + eps)) * norm_w).
//
// Bound: the int8 weight's HBM bytes.  At M <= 256 a weight byte feeds 2M <=
// 512 flops, and at the main path's M = 32 and 64 at most 128, far under the
// ~295 flop/byte where the bf16 tensor cores limit; so the design streams q
// at HBM rate and keeps everything else on chip.
//
// - One launch.  A block owns a tile of 128 output columns (with the gate:
//   64 gate columns and the 64 matching up columns, so the gate finishes in
//   the block) and one split of the contraction.  The splits of a tile form a
//   thread-block cluster (1, split, 1), split <= 8 (the portable cluster
//   size), fixed by the weight's shape alone (kernels/quant_matmul.py
//   cluster_split_plan).  The tile's fragment groups are shared out among
//   the ranks: each rank stores its f32 partial of each group into a
//   receive area of the owning rank by st.async (distributed shared memory,
//   completing on the owner's mbarrier: no round trip, no cluster barrier),
//   and the owner adds the ranks' partials in split order (no atomics: the
//   draft's tokens are the same on every run) and applies scale, residual
//   or gate, its scales and residual loaded before the main loop.  With one
//   split the block finishes from registers.
// - The norm's row statistic: each rank sums the squares of its own
//   contraction range of every row (one warp a row, sixteen loads in
//   flight, a fixed order) and stores the partial sums into every rank the
//   same way; every rank adds them in rank order, so every block of a row
//   holds the same statistic bit for bit.  The producer starts after the
//   statistic: its loads would delay the statistic's own.  The x tiles are
//   normalized in shared memory as they land (each consumer thread a share
//   of the tile, the stage's 64 norm weights brought by the same mbarrier,
//   then a named barrier among the consumers).
// - Weight streaming by TMA.  One producer warp (one lane) keeps a ring of
//   STAGES stages in flight on mbarriers: each stage is two 64-column boxes
//   of BK = 64 contraction rows of q (4 KB each; 64-byte swizzle) and the x
//   tile [R rows, 64] (128-byte swizzle; rows past M arrive as zeros).  The
//   weight's tensor map is encoded once per (pointer, shape) and cached; x's
//   is encoded per call.  cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda; a failed
//   encode returns an error (the wrapper raises), never a fallback.
// - Conversion without a second tile.  Four consumer warps each own 16
//   columns of each 64-column box.  One ldmatrix.x4.trans reads the int8
//   tile as b16 pairs straight from the swizzled stage: lane (g, t4) gets
//   bytes (k 2t4, 2t4+1) x (columns 2g, 2g+1) of each 8x16-byte matrix, so
//   one register holds the k-pairs of two columns, and two logic ops and a
//   bf16x2 subtraction a pair (i8_pair, exact) turn it into the mma B
//   fragments of an even and an odd column (the mma's column order is a
//   permutation of the weight's; the epilogue undoes it).  mma.sync
//   m16n8k16 (bf16 in, f32 accumulate): the tensor cores are not the limit
//   here (see the bound), and x stays the 16-row A operand, tiled MT = 1, 2,
//   4 or 8 times (M <= 16, 32, 64, 128 rows a pass).
// - Persistence.  Clusters walk the column tiles (tile c, c + G, ...), G =
//   min(tiles, resident blocks / split), so the lm_head's 1002 tiles run on
//   one wave of resident blocks and the next tile's loads overlap this tile's
//   conversion and epilogue; rows past 128 run as a second pass over each
//   tile inside the same launch (tile outer, so the pass re-reads the tile
//   from L2).
#include <tuple>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace sm90 {

constexpr int BK = 64;        // contraction rows a stage
constexpr int HALF = 64;      // weight columns a TMA box: half a tile
constexpr int BN = 2 * HALF;  // output columns a tile
constexpr int NCW = 4;        // consumer warps
constexpr int NTHREADS = 32 * (NCW + 1);
constexpr int MAX_ROWS = 256;  // the routing's ROWS_CAP (quantization.py)
constexpr int MAX_SPLIT = 8;   // the portable cluster size

template <int MT>
struct Cfg {
  static constexpr int R = 16 * MT;            // x rows a pass
  static constexpr int W_BYTES = BK * HALF;    // one weight box, 4 KB
  static constexpr int X_BYTES = R * BK * 2;   // the x tile, 128 bytes a row
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int STAGES = MT == 1 ? 7 : (MT == 2 ? 5 : (MT == 4 ? 3 : 4));
  static constexpr int RING = STAGES * STAGE;
  // the fragment groups (2 KB: 4 mma fragments x 32 lanes x 16 B) a rank
  // reduces, each with a slot for every rank's partial
  static constexpr int RECV = RING;
  static constexpr int RECV_BYTES = (NCW * MT + MAX_SPLIT) * 2048;
  // full[STAGES], empty[STAGES], stat (the statistic's pushes), red (the
  // partials' pushes)
  static constexpr int BARS = RECV + RECV_BYTES;
  static constexpr int SSQ = BARS + 16 * STAGES + 16;  // [MAX_SPLIT][MAX_ROWS] f32
  static constexpr int RR = SSQ + 4 * MAX_SPLIT * MAX_ROWS;
  static constexpr int NW = RR + 4 * MAX_ROWS;  // the norm weight's BK values a stage
  static constexpr int SMEM = NW + STAGES * BK * 2 + 1024;  // + slack to align to 1024
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  // two blocks an SM up to MT = 4 (registers allow one at MT = 8)
  static_assert(MT == 8 || 2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
};

struct Args {
  CUtensorMap wmap;            // q [In, Out] int8, box {HALF, BK}, 64-byte swizzle
  CUtensorMap xmap;            // x [M, In] bf16, box {BK, R}, 128-byte swizzle
  const __nv_bfloat16* x;      // [M, In], for the norm's statistic
  const float* scale;          // [Out]
  const __nv_bfloat16* norm_w;  // [In] or null
  const __nv_bfloat16* res;    // [M, Out] or null
  __nv_bfloat16* out;          // [M, Out], or [M, Out / 2] with the gate
  int M, In, Out, kchunk, ntiles, gate;
  float eps;
};

namespace {

// Every non-exited thread of the cluster (release, then acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in cluster rank `rank`.
__device__ __forceinline__ uint32_t rank_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Remote stores that complete on the receiving rank's mbarrier (its
// transaction count falls by the bytes stored).
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_f32x4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The consumer warps only (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");
}

__device__ __forceinline__ void ldsm_x4_u32(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans_u32(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Bytes b0..b3 of w (signed int8) -> even = bf16x2 {b0, b2}, odd = {b1, b3}
// (low half first), exactly: with low7 = b & 0x7F and sign = b & 0x80,
// bf16 0x4300 | low7 is 128 + low7 and 0x4300 | sign is 128 or 256, so
// their difference is b (an integer |b| <= 128, exact in bf16).  Three
// logic ops and a bf16x2 subtraction a pair, no conversion unit.  An
// ldmatrix.trans register of the int8 tile holds (k, col 2g), (k, col
// 2g+1), (k+1, col 2g), (k+1, col 2g+1): even and odd are the k-pairs of the
// two columns, i.e. mma B fragments.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w) {  // bytes 0 and 2 of w
  const uint32_t lo = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void i8_pairs(uint32_t w, uint32_t& even, uint32_t& odd) {
  even = i8_pair(w);
  odd = i8_pair(w >> 8);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sum_sq8(float acc, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    acc += f.x * f.x;
    acc += f.y * f.y;
  }
  return acc;
}

// bf16(bf16(x * r) * w) of a bf16 pair
__device__ __forceinline__ uint32_t norm_pair(uint32_t xv, uint32_t wv, float r) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
  const __nv_bfloat162 n = __floats2bfloat162_rn(f.x * r, f.y * r);
  const __nv_bfloat162 o = __hmul2(n, *reinterpret_cast<const __nv_bfloat162*>(&wv));
  return *reinterpret_cast<const uint32_t*>(&o);
}

__device__ __forceinline__ uint2 pack_bf16x4(const float v[4]) {
  return make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// The scales and residual of one fragment group (see finish_group): sc[box]
// (with the gate: sc[0] the gate's, sc[1] the up's), rv[h][box] for rows
// row0 + g + 8 h.
struct GroupOperands {
  float4 sc[2];
  uint2 rv[2][2];
};

__device__ __forceinline__ void load_group(const Args& a, int t, int row0, int uw, int lane,
                                           GroupOperands& o) {
  const int cw = 16 * uw + 4 * (lane & 3);
  const int c0 = a.gate ? t * HALF : t * BN;
  const int c1 = a.gate ? a.Out / 2 + t * HALF : t * BN + HALF;
  o.sc[0] = __ldg(reinterpret_cast<const float4*>(a.scale + c0 + cw));
  o.sc[1] = __ldg(reinterpret_cast<const float4*>(a.scale + c1 + cw));
  if (a.res == nullptr) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int box = 0; box < 2; ++box)
      o.rv[h][box] = m < a.M ? __ldg(reinterpret_cast<const uint2*>(
                                   a.res + (size_t)m * a.Out + (box ? c1 : c0) + cw))
                             : make_uint2(0, 0);
  }
}

// The epilogue of one fragment group: rows row0 + g and row0 + g + 8 of a row
// tile, columns 16 uw + 4 t4 .. + 3 of each 64-column box of tile t; v[nb] is
// mma fragment nb's f32 sums (nb 0/1: the even/odd columns of box 0, 2/3 of
// box 1), so a lane's four consecutive columns are {nb0[e], nb1[e],
// nb0[e+1], nb1[e+1]}.  Box 0 holds the gate columns and box 1 the up
// columns with the gate, else the tile's first and second 64 columns.
__device__ __forceinline__ void finish_group(const Args& a, int t, int row0, int uw, int lane,
                                             const float (&v)[4][4], const GroupOperands& o) {
  const int g = lane >> 2, cw = 16 * uw + 4 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + g + 8 * h;
    if (m >= a.M) continue;
    const float v0[4] = {v[0][2 * h], v[1][2 * h], v[0][2 * h + 1], v[1][2 * h + 1]};
    const float v1[4] = {v[2][2 * h], v[3][2 * h], v[2][2 * h + 1], v[3][2 * h + 1]};
    if (a.gate) {
      const int F = a.Out / 2;
      const int n = t * HALF + cw;
      const float gs[4] = {o.sc[0].x, o.sc[0].y, o.sc[0].z, o.sc[0].w};
      const float us[4] = {o.sc[1].x, o.sc[1].y, o.sc[1].z, o.sc[1].w};
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gv = bf16_round(v0[j] * gs[j]);
        const float uv = bf16_round(v1[j] * us[j]);
        y[j] = gv * (1.f / (1.f + expf(-gv))) * uv;
      }
      *reinterpret_cast<uint2*>(a.out + (size_t)m * F + n) = pack_bf16x4(y);
      continue;
    }
#pragma unroll
    for (int box = 0; box < 2; ++box) {
      const int n = t * BN + box * HALF + cw;
      const float* vb = box ? v1 : v0;
      const float ss[4] = {o.sc[box].x, o.sc[box].y, o.sc[box].z, o.sc[box].w};
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = bf16_round(vb[j] * ss[j]);
      if (a.res != nullptr) {
        const uint2 rv = o.rv[h][box];
        const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.x));
        const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.y));
        y[0] += r01.x;
        y[1] += r01.y;
        y[2] += r23.x;
        y[3] += r23.y;
      }
      *reinterpret_cast<uint2*>(a.out + (size_t)m * a.Out + n) = pack_bf16x4(y);
    }
  }
}

}  // namespace

// Grid (clusters, split), cluster (1, split, 1), NTHREADS threads: warps
// 0..NCW-1 consume, warp NCW produces.  Rank s of a cluster covers
// contraction rows [s * kchunk, min(In, (s + 1) * kchunk)).
template <int MT>
__global__ void __launch_bounds__(NTHREADS, MT <= 4 ? 2 : 1)
    qmm_sm90_kernel(const __grid_constant__ Args a) {
  using C = Cfg<MT>;
  constexpr int R = C::R, S = C::STAGES;
  constexpr int KU = MT <= 2 ? BK / 16 : 2;  // k-steps unrolled (registers at MT >= 4)
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
  const int nk = (k1 - k0) / BK;
  const int npass = (a.M + R - 1) / R;
  const bool norm = a.norm_w != nullptr;
  // the fragment groups u = (warp, row tile) this rank reduces: u = rank,
  // rank + split, ...; each receives every rank's partial (2 KB)
  const int owned = (NCW * MT - (int)rank + split - 1) / split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(bars + 8 * (S + s), NCW * 32);      // every consumer thread
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
    auto issue = [&](int t, int p, int i) {
      const int s = it % S;
      const uint32_t ph = (it / S) & 1;
      ++it;
      mbar_wait(bars + 8 * (S + s), ph ^ 1);  // the consumers released the stage
      const uint32_t full = bars + 8 * s;
      mbar_expect_tx(full, 2 * C::W_BYTES + C::X_BYTES + (norm ? BK * 2 : 0));
      const uint32_t st = sbase + s * C::STAGE;
      const int kt = k0 + i * BK;
      if (norm) bulk_load(sbase + C::NW + s * BK * 2, a.norm_w + kt, BK * 2, full);
      const int c0 = a.gate ? t * HALF : t * BN;
      const int c1 = a.gate ? a.Out / 2 + t * HALF : t * BN + HALF;
      tma_load_2d(st, &a.wmap, full, c0, kt);
      tma_load_2d(st + C::W_BYTES, &a.wmap, full, c1, kt);
      tma_load_2d(st + 2 * C::W_BYTES, &a.xmap, full, kt, p * R);
    };
    // with the norm, the loads start once this rank holds the statistic's
    // partials: the statistic's own loads of x would queue behind the ring's
    if (norm) mbar_wait(stat_bar, 0);
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      for (int p = 0; p < npass; ++p) {
        for (int i = 0; i < nk; ++i) issue(t, p, i);
        // between two items of a cluster the receive slots are reused
        const bool last = p + 1 == npass && t + (int)gridDim.x >= a.ntiles;
        if (split > 1 && !last) cluster_sync();
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int tid = threadIdx.x;  // 0 .. NCW * 32 - 1
  if (norm) {
    // this rank's partial sums of squares: warp w takes rows w, w + NCW, ...
    // eight at a time, each lane its 16-byte chunks in order, two a row in
    // flight together, then a fixed shuffle tree; every rank gets every
    // rank's partials (remote stores) and adds them in rank order
    const int nchunk = (k1 - k0) / 8;
    bool waited = false;
    for (int mb = warp; mb < a.M; mb += 8 * NCW) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int c = lane; c < nchunk; c += 64) {
        uint4 v[8][2];  // chunks c and c + 32 of eight rows: 16 loads in flight
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = mb + j * NCW, ce = c + 32 * e;
            v[j][e] = m < a.M && ce < nchunk
                          ? __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)m * a.In + k0 +
                                                                 ce * 8))
                          : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = sum_sq8(sum_sq8(acc[j], v[j][0]), v[j][1]);
      }
      if (!waited) {
        cluster_wait();
        waited = true;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        // lane s stores the partial into slot [rank] of rank s
        const int m = mb + j * NCW;
        if (lane < split && m < a.M)
          st_async_f32(rank_addr(smem_u32(ssq + rank * MAX_ROWS + m), lane), v,
                       rank_addr(stat_bar, lane));
      }
    }
    if (!waited) cluster_wait();
    mbar_wait(stat_bar, 0);  // every rank's partials have landed
    for (int m = tid; m < a.M; m += NCW * 32) {
      float tot = 0.f;
      for (int s = 0; s < split; ++s) tot += ssq[s * MAX_ROWS + m];
      rr[m] = 1.f / sqrtf(tot / (float)a.In + a.eps);
    }
    consumers_sync();  // rr visible to every consumer
  } else {
    cluster_wait();
  }

  int it = 0, item = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    for (int p = 0; p < npass; ++p, ++item) {
      const int m0 = p * R;
      if (split > 1 && tid == 0) mbar_expect_tx(red_bar, owned * split * 2048);
      // the first fragment group this warp finishes (u = (warp, row tile);
      // see the reduction below): its scales and residual load now, so that
      // the finish does not wait on them
      const int u0 = split == 1 ? warp * MT : (int)rank + split * warp;
      GroupOperands ops;
      if (u0 < NCW * MT) load_group(a, t, m0 + (u0 % MT) * 16, u0 / MT, lane, ops);
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;

      for (int i = 0; i < nk; ++i) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        ++it;
        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed
        const uint32_t wst = sbase + s * C::STAGE;
        const uint32_t xst = wst + 2 * C::W_BYTES;
        if (norm) {
          // normalize the x tile in place; chunk (row r, physical chunk pc)
          // holds logical columns 8 (pc ^ (r % 8)) .. + 7 (128-byte swizzle)
          uint8_t* xs = smem + s * C::STAGE + 2 * C::W_BYTES;
          const uint8_t* nw = smem + C::NW + s * BK * 2;
          for (int j = tid; j < R * 8; j += NCW * 32) {
            const int r = j >> 3, pc = j & 7, m = m0 + r;
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
          consumers_sync();
        }
#pragma unroll KU
        for (int kk = 0; kk < BK / 16; ++kk) {
          // matrices: box 0 rows 0-7, box 0 rows 8-15, box 1 rows 0-7, box 1
          // rows 8-15, each this warp's 16-byte chunk (64-byte swizzle:
          // chunk ^ (row / 2 % 4))
          uint32_t wr[4];
          {
            const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldsm_x4_trans_u32(wr, wst + (lane >> 4) * C::W_BYTES + row * HALF +
                                      ((warp ^ ((row >> 1) & 3)) << 4));
          }
          // b[nb]: nb 0/1 the even/odd columns of box 0, 2/3 of box 1
          uint32_t b[4][2];
          i8_pairs(wr[0], b[0][0], b[1][0]);
          i8_pairs(wr[1], b[0][1], b[1][1]);
          i8_pairs(wr[2], b[2][0], b[3][0]);
          i8_pairs(wr[3], b[2][1], b[3][1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
            const int row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int ch = kk * 2 + (lane >> 4);
            ldsm_x4_u32(af, xst + row * 128 + ((ch ^ (row & 7)) << 4));
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_bf16_16816(acc[mt][nb], af, b[nb][0], b[nb][1]);
          }
        }
        if (norm) fence_proxy_async();  // the normalized tile before TMA reuses it
        mbar_arrive(bars + 8 * (S + s));
      }

      if (split == 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt > 0 && a.res != nullptr) load_group(a, t, m0 + mt * 16, warp, lane, ops);
          finish_group(a, t, m0 + mt * 16, warp, lane, acc[mt], ops);
        }
        continue;
      }
      // fragment group u = (warp, row tile) is reduced and finished by rank
      // u % split (its warp u / split % NCW): each rank stores its partial
      // of group u into slot [rank] of that rank's receive area, completing
      // on its red barrier, and the owner adds the slots in split order
      const float4* P = reinterpret_cast<const float4*>(smem + C::RECV);  // [u / split][split][nb][lane]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int u = warp * MT + mt;
        const uint32_t dst = rank_addr(smem_u32(smem + C::RECV), u % split);
        const uint32_t bar = rank_addr(red_bar, u % split);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          st_async_f32x4(dst + (((u / split) * split + (int)rank) * 4 + nb) * 512 + lane * 16,
                         acc[mt][nb], bar);
      }
      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's groups
      for (int u = (int)rank + split * warp; u < NCW * MT; u += split * NCW) {
        float v[4][4];
        const float4* slot = P + ((u / split) * split) * 4 * 32 + lane;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float4 q = slot[nb * 32];
          v[nb][0] = q.x, v[nb][1] = q.y, v[nb][2] = q.z, v[nb][3] = q.w;
        }
        for (int r = 1; r < split; ++r)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const float4 q = slot[(r * 4 + nb) * 32];
            v[nb][0] += q.x, v[nb][1] += q.y, v[nb][2] += q.z, v[nb][3] += q.w;
          }
        if (u != u0) load_group(a, t, m0 + (u % MT) * 16, u / MT, lane, ops);
        finish_group(a, t, m0 + (u % MT) * 16, u / MT, lane, v, ops);
      }
      // between two items of a cluster the receive slots are reused
      const bool last = p + 1 == npass && t + (int)gridDim.x >= a.ntiles;
      if (!last) cluster_sync();
    }
  }
}

// ---- host side ----------------------------------------------------------------

// The weight's map, encoded once per (pointer, shape).
static CUresult weight_map(CUtensorMap* map, const int8_t* q, int In, int Out) {
  return cached_map(map, std::make_tuple(static_cast<const void*>(q), In, Out),
                    [&](CUtensorMap* m) {
                      return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 1, Out, In, HALF,
                                       BK, CU_TENSOR_MAP_SWIZZLE_64B);
                    });
}

template <int MT>
static cudaError_t launch(Args& a, int split, cudaStream_t st) {
  using C = Cfg<MT>;
  // once per instantiation: the attribute, and the blocks an SM holds
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_sm90_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmm_sm90_kernel<MT>, NTHREADS, C::SMEM);
    return max(1, sms * max(1, per_sm));
  }();
  const CUresult enc = encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, 2, a.In, a.M,
                                 BK, C::R, CU_TENSOR_MAP_SWIZZLE_128B);
  if (enc != CUDA_SUCCESS) return static_cast<cudaError_t>(kEncodeError + enc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(a.ntiles, max(1, resident / split)), split, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_sm90_kernel<MT>, a);
}

}  // namespace sm90
}  // namespace md

// B4 and B6: out = epilogue(norm?(x)[M, In] @ q[In, Out] * scale[Out]) in one
// launch.  norm_w [In] and res [M, Out] may be null; gate: q is [In, 2F] and
// out [M, F].  split: the contraction's splits (1..8, none empty, the
// wrapper's cluster_split_plan).  Returns cudaGetLastError(), or
// 0x10000 + the CUresult of a failed tensor-map encode.
extern "C" int md_quant_matmul_sm90(const void* x, const void* q, const void* scale,
                                    const void* norm_w, const void* res, void* out, int M,
                                    int In, int Out, int gate, int split, float eps,
                                    void* stream) {
  using namespace md::sm90;
  if (M < 1 || M > MAX_ROWS || In % BK != 0 || Out % BN != 0 || split < 1 ||
      split > MAX_SPLIT || (gate && res != nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = In / BK;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return (int)cudaErrorInvalidValue;  // an empty split
  Args a;
  const CUresult enc = weight_map(&a.wmap, static_cast<const int8_t*>(q), In, Out);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.In = In;
  a.Out = Out;
  a.kchunk = per * BK;
  a.ntiles = Out / BN;
  a.gate = gate != 0;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = M < 128 ? M : 128;
  cudaError_t err;
  if (rows <= 16)
    err = launch<1>(a, split, st);
  else if (rows <= 32)
    err = launch<2>(a, split, st);
  else if (rows <= 64)
    err = launch<4>(a, split, st);
  else
    err = launch<8>(a, split, st);
  if ((int)err >= kEncodeError) return (int)err;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B4, B6, B4-int4 and B6-int4 on Hopper: the draft's weight-streaming dots
// over its int8 and group-wise int4 weight copies, one launch a call.
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py quant_matmul_pallas
// (_int8_kernel: B6, the draft's int8 lm_head; _int4_kernel: B6-int4, its
// int4 lm_head, see qmm4_sm90_kernel below) and quant_matmul_fused_pallas
// (_fused_kernel, int8 branch: B4, the draft's wqkv with its rms-norm, w13
// with the SiLU gate, w2 or wo with a residual; nibble branch :151-167 with
// bits=4: B4-int4, the same epilogues without the norm, which the reference
// applies outside).  They compute
//   y = epilogue(norm?(x)[M, In] @ q[In, Out] * scale)
// with bf16 x and f32 sums: int8 q with one f32 scale per output column, the
// sum scaled once; or int4 q packed in contraction-row pairs ([In/2, Out]:
// byte [r, n] holds row 2r in its low nibble, 2r + 1 in its high one) with
// one f32 scale per group of `group` contraction rows and column, each
// group's products summed in a fresh f32 partial and added as acc +=
// part * s_g in group order.  The epilogue is bf16(acc) [+ res in bf16], or
// bf16(g * sigmoid(g) * u) over the bf16-rounded gate and up halves of q;
// the norm is bf16(bf16(x * rsqrt(mean(x^2) + eps)) * norm_w).
//
// Bound: the weight's HBM bytes.  At M <= 256 an int8 weight byte feeds 2M
// <= 512 flops (an int4 byte 4M), and at the main path's M = 32 and 64 at
// most 256, under the ~295 flop/byte where the bf16 tensor cores limit; so
// the design streams q at HBM rate and keeps everything else on chip.
//
// - One launch.  A block owns a tile of 128 output columns (with the gate:
//   64 gate columns and the 64 matching up columns, so the gate finishes in
//   the block) and one split of the contraction.  The splits of a tile form a
//   thread-block cluster (1, split, 1), split <= 8 (the portable cluster
//   size), fixed by the weight's shape alone (kernels/quant_matmul.py
//   cluster_split_plan; int4 splits start on group boundaries).  The tile's
//   fragment groups are shared out among the ranks: each rank stores its f32
//   partial of each group into a receive area of the owning rank by st.async
//   (distributed shared memory, completing on the owner's mbarrier: no round
//   trip, no cluster barrier), and the owner adds the ranks' partials in
//   split order (no atomics: the draft's tokens are the same on every run)
//   and applies scale, residual or gate, its scales and residual loaded
//   before the main loop.  With one split the block finishes from registers.
// - The norm's row statistic (int8): each rank sums the squares of its own
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
//   of 64 byte rows of q (4 KB each; 64-byte swizzle: 64 contraction rows of
//   int8, 128 of packed int4) and the x tile of the same contraction rows
//   ([R rows, 64] sub-tiles, 128-byte swizzle; rows past M arrive as zeros),
//   with int4 the stage's group scales of the tile's columns (bulk copies on
//   the same mbarrier).  The weight's tensor map is encoded once per
//   (pointer, shape) and cached; x's is encoded per call.  A failed encode
//   returns an error (the wrapper raises), never a fallback.
// - Conversion without a second tile.  Four consumer warps each own 16
//   columns of each 64-column box.  One ldmatrix.x4.trans reads the weight
//   tile as b16 pairs straight from the swizzled stage: lane (g, t4) gets
//   bytes (byte row 2t4, 2t4+1) x (columns 2g, 2g+1) of each 8x16-byte
//   matrix.  int8: one register holds the k-pairs of two columns, and two
//   logic ops and a bf16x2 subtraction a pair (i8_pair, exact) turn it into
//   the mma B fragments of an even and an odd column (the mma's column order
//   is a permutation of the weight's; the epilogue undoes it).  int4: the
//   two bytes of a column hold contraction rows 4t4 .. 4t4+3, so one register
//   gives both B registers of an even and an odd column's k16 fragment (a
//   byte permute, one logic op and a bf16x2 subtraction a pair, i4_frags,
//   exact); the k16 step's slots 2t4, 2t4+1, 2t4+8, 2t4+9 then hold rows
//   4t4 .. 4t4+3, and the A fragments read x in the same permutation (8
//   contiguous bytes a row, the same at every M).  mma.sync m16n8k16 (bf16
//   in, f32 accumulate): the tensor cores are not the limit here (see the
//   bound), and x stays the 16-row A operand, tiled MT = 1, 2, 4 or 8 times
//   (M <= 16, 32, 64, 128 rows a pass; int4 at most 4: its group partials
//   double the accumulators).
// - Persistence.  Clusters walk the column tiles (tile c, c + G, ...), G =
//   min(tiles, resident blocks / split), so the lm_head's 1002 tiles run on
//   one wave of resident blocks and the next tile's loads overlap this tile's
//   conversion and epilogue; rows past a pass run as further passes over
//   each tile inside the same launch (tile outer, so a pass re-reads the
//   tile from L2).
#include <tuple>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace sm90 {

constexpr int BK = 64;        // weight byte rows a stage (int8: contraction rows)
constexpr int HALF = 64;      // weight columns a TMA box: half a tile
constexpr int BN = 2 * HALF;  // output columns a tile
constexpr int NCW = 4;        // consumer warps
constexpr int NTHREADS = 32 * (NCW + 1);
constexpr int MAX_ROWS = 256;  // the routing's ROWS_CAP (quantization.py)
constexpr int MAX_SPLIT = 8;   // the portable cluster size
constexpr int MAX_G4 = 4;      // int4 scale rows a stage (group 32)

template <bool INT4, int MT>
struct Cfg {
  static_assert(!INT4 || MT <= 4, "int4: acc and the group partial in registers");
  static constexpr int R = 16 * MT;            // x rows a pass
  static constexpr int KS = INT4 ? 2 * BK : BK;  // contraction rows a stage
  static constexpr int W_BYTES = BK * HALF;    // one weight box, 4 KB
  static constexpr int X_BYTES = R * KS * 2;   // the x tile: KS / 64 sub-tiles, 128 bytes a row
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int STAGES = INT4 ? (MT == 1 ? 6 : (MT == 2 ? 4 : 2))
                                     : (MT == 1 ? 7 : (MT == 2 ? 5 : (MT == 4 ? 3 : 4)));
  static constexpr int RING = STAGES * STAGE;
  // the fragment groups (2 KB: 4 mma fragments x 32 lanes x 16 B) a rank
  // reduces, each with a slot for every rank's partial
  static constexpr int RECV = RING;
  static constexpr int RECV_BYTES = (NCW * MT + MAX_SPLIT) * 2048;
  // full[STAGES], empty[STAGES], stat (the statistic's pushes), red (the
  // partials' pushes)
  static constexpr int BARS = RECV + RECV_BYTES;
  // int8: the statistic's partials [MAX_SPLIT][MAX_ROWS] f32, the rows'
  // factors and the norm weight's BK values a stage; int4: the group scales,
  // [MAX_G4 rows][2 boxes][HALF] f32 a stage
  static constexpr int SSQ = BARS + 16 * STAGES + 16;
  static constexpr int RR = SSQ + (INT4 ? 0 : 4 * MAX_SPLIT * MAX_ROWS);
  static constexpr int NW = RR + (INT4 ? 0 : 4 * MAX_ROWS);
  static constexpr int SC_STAGE = MAX_G4 * 2 * HALF * 4;
  static constexpr int SC = NW;
  static constexpr int SMEM =
      NW + (INT4 ? STAGES * SC_STAGE : STAGES * BK * 2) + 1024;  // + slack to align to 1024
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  // two blocks an SM up to MT = 4 (registers allow one at MT = 8)
  static_assert(MT == 8 || 2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
};

struct Args {
  CUtensorMap wmap;            // q [In, Out] int8 (int4: [In / 2, Out]), box {HALF, BK}, 64-byte swizzle
  CUtensorMap xmap;            // x [M, In] bf16, box {BK, R}, 128-byte swizzle
  const __nv_bfloat16* x;      // [M, In], for the norm's statistic
  const float* scale;          // [Out]; int4: [In / group, Out]
  const __nv_bfloat16* norm_w;  // [In] or null
  const __nv_bfloat16* res;    // [M, Out] or null
  __nv_bfloat16* out;          // [M, Out], or [M, Out / 2] with the gate
  int M, In, Out, kchunk, ntiles, gate;
  int group;                   // int4: contraction rows a scale group
  float eps;
};

namespace {

// The consumer warps only (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");
}

// The two nibbles of byte `sel` of w and of w >> 4 (selectors 0x4400, 0x5511,
// 0x6622, 0x7733: bytes 0..3) -> bf16x2 {low nibble, high nibble} as signed
// int4 values, exactly: a nibble n with its bit 3 flipped is v + 8 for the
// value v in [-8, 7], 0x4300 | (v + 8) reads 136 + v in bf16, and 136 is
// subtracted.  One byte permute, one logic op and a bf16x2 subtraction.
template <uint32_t SEL>
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, uint32_t w4) {
  const uint32_t v = (__byte_perm(w, w4, SEL) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;  // bf16x2 {136, 136}
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// An ldmatrix.trans register of the packed int4 tile: bytes (packed row 2t4,
// col 2g), (2t4, 2g+1), (2t4+1, 2g), (2t4+1, 2g+1), i.e. contraction rows
// 4t4 .. 4t4+3 of columns 2g and 2g+1.  even / odd: the mma B fragments
// (both registers) of the even and the odd column, slots 2t4, 2t4+1 holding
// rows 4t4, 4t4+1 and slots 2t4+8, 2t4+9 rows 4t4+2, 4t4+3.
__device__ __forceinline__ void i4_frags(uint32_t w, uint32_t (&even)[2], uint32_t (&odd)[2]) {
  const uint32_t w4 = w >> 4;
  even[0] = i4_pair<0x4400u>(w, w4);
  even[1] = i4_pair<0x6622u>(w, w4);
  odd[0] = i4_pair<0x5511u>(w, w4);
  odd[1] = i4_pair<0x7733u>(w, w4);
}

// The scales and residual of one fragment group (see finish_group): sc[box]
// (with the gate: sc[0] the gate's, sc[1] the up's), rv[h][box] for rows
// row0 + g + 8 h.
struct GroupOperands {
  float4 sc[2];
  uint2 rv[2][2];
};

template <bool INT4>
__device__ __forceinline__ void load_group(const Args& a, int t, int row0, int uw, int lane,
                                           GroupOperands& o) {
  const int cw = 16 * uw + 4 * (lane & 3);
  const int c0 = a.gate ? t * HALF : t * BN;
  const int c1 = a.gate ? a.Out / 2 + t * HALF : t * BN + HALF;
  if constexpr (INT4) {
    o.sc[0] = o.sc[1] = make_float4(1.f, 1.f, 1.f, 1.f);  // the groups are scaled already
  } else {
    o.sc[0] = __ldg(reinterpret_cast<const float4*>(a.scale + c0 + cw));
    o.sc[1] = __ldg(reinterpret_cast<const float4*>(a.scale + c1 + cw));
  }
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
// Two blocks an SM up to MT = 4.  int4 at MT = 4 (acc and the group partial
// in registers) then spills a few hundred bytes; one block an SM without
// spills was slower (PERF.md, PR 9).
template <bool INT4, int MT>
__global__ void __launch_bounds__(NTHREADS, MT <= 4 ? 2 : 1)
    qmm_sm90_kernel(const __grid_constant__ Args a) {
  using C = Cfg<INT4, MT>;
  constexpr int R = C::R, S = C::STAGES, KS = C::KS;
  constexpr int KU = MT <= 2 ? BK / 16 : 2;  // int8 k-steps unrolled (registers at MT >= 4)
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
  const int nk = (k1 - k0) / KS;
  const int npass = (a.M + R - 1) / R;
  const bool norm = !INT4 && a.norm_w != nullptr;
  // int4: the scale rows a stage brings (the groups it spans, or the one it
  // lies in)
  const int ng = INT4 ? max(1, KS / a.group) : 0;
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
      mbar_expect_tx(full, 2 * C::W_BYTES + C::X_BYTES + (norm ? BK * 2 : 0) +
                               (INT4 ? ng * 2 * HALF * 4 : 0));
      const uint32_t st = sbase + s * C::STAGE;
      const int kt = k0 + i * KS;
      if (norm) bulk_load(sbase + C::NW + s * BK * 2, a.norm_w + kt, BK * 2, full);
      const int c0 = a.gate ? t * HALF : t * BN;
      const int c1 = a.gate ? a.Out / 2 + t * HALF : t * BN + HALF;
      const int kq = INT4 ? kt / 2 : kt;  // the weight's byte row
      tma_load_2d(st, &a.wmap, full, c0, kq);
      tma_load_2d(st + C::W_BYTES, &a.wmap, full, c1, kq);
#pragma unroll
      for (int j = 0; j < KS / BK; ++j)
        tma_load_2d(st + 2 * C::W_BYTES + j * R * 128, &a.xmap, full, kt + j * BK, p * R);
      if constexpr (INT4) {
        // the scale rows of the groups of [kt, kt + KS), the tile's two boxes each
        const uint32_t sc = sbase + C::SC + s * C::SC_STAGE;
        for (int j = 0; j < ng; ++j) {
          const float* srow = a.scale + (size_t)(kt / a.group + j) * a.Out;
          bulk_load(sc + j * 2 * HALF * 4, srow + c0, HALF * 4, full);
          bulk_load(sc + j * 2 * HALF * 4 + HALF * 4, srow + c1, HALF * 4, full);
        }
      }
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
  if (norm)
    row_norm_factors<NCW>(a.x, a.M, a.In, k0, k1, a.eps, MAX_ROWS, ssq, rr, stat_bar, rank, split);
  else
    cluster_wait();

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
      if (u0 < NCW * MT) load_group<INT4>(a, t, m0 + (u0 % MT) * 16, u0 / MT, lane, ops);
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;
      // int4: the current group's f32 partial (products of one group only)
      float part[INT4 ? MT : 1][4][4];
      if constexpr (INT4) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nb][e] = 0.f;
      }

      for (int i = 0; i < nk; ++i) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        ++it;
        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed
        const uint32_t wst = sbase + s * C::STAGE;
        const uint32_t xst = wst + 2 * C::W_BYTES;
        if constexpr (INT4) {
          const int kt = k0 + i * KS;
          const uint8_t* xs = smem + s * C::STAGE + 2 * C::W_BYTES;
          const float* sc = reinterpret_cast<const float*>(smem + C::SC + s * C::SC_STAGE) +
                            16 * warp + 4 * (lane & 3);
          const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // packed rows kk*16 .. +15 (contraction rows kk*32 .. +31): box 0
            // rows 0-7, 8-15, box 1 rows 0-7, 8-15, this warp's 16-byte chunk
            // (64-byte swizzle: chunk ^ (row / 2 % 4))
            uint32_t wr[4];
            {
              const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
              ldsm_x4_trans_u32(wr, wst + (lane >> 4) * C::W_BYTES + row * HALF +
                                        ((warp ^ ((row >> 1) & 3)) << 4));
            }
#pragma unroll
            for (int hs = 0; hs < 2; ++hs) {
              // contraction rows kk*32 + 16 hs .. + 15 of the stage; b[nb]: nb
              // 0/1 the even/odd columns of box 0, 2/3 of box 1
              uint32_t b[4][2];
              i4_frags(wr[hs], b[0], b[1]);
              i4_frags(wr[2 + hs], b[2], b[3]);
              // x[row, c .. c + 3], c = kk*32 + 16 hs + 4 t4, in sub-tile kk / 2
              const int col = (kk & 1) * 32 + hs * 16 + 4 * t4;
              const uint8_t* sub = xs + (kk >> 1) * (R * 128) + (col & 7) * 2;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                const int r0 = mt * 16 + g, r1 = r0 + 8;
                const uint2 v0 =
                    *reinterpret_cast<const uint2*>(sub + r0 * 128 + (((col >> 3) ^ (r0 & 7)) << 4));
                const uint2 v1 =
                    *reinterpret_cast<const uint2*>(sub + r1 * 128 + (((col >> 3) ^ (r1 & 7)) << 4));
                const uint32_t af[4] = {v0.x, v1.x, v0.y, v1.y};
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) mma_bf16_16816(part[mt][nb], af, b[nb][0], b[nb][1]);
              }
            }
            if (((kt + (kk + 1) * 32) & (a.group - 1)) == 0) {
              // the group ends here: its partial, scaled, into acc (lane's
              // columns 16 warp + 4 t4 .. + 3 of each box: nb 0/1 take the
              // even/odd ones of box 0, 2/3 of box 1)
              const float* srow = sc + (a.group >= KS ? 0 : (kk * 32) / a.group) * 2 * HALF;
              const float4 s0 = *reinterpret_cast<const float4*>(srow);
              const float4 s1 = *reinterpret_cast<const float4*>(srow + HALF);
              const float sv[4][2] = {{s0.x, s0.z}, {s0.y, s0.w}, {s1.x, s1.z}, {s1.y, s1.w}};
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nb = 0; nb < 4; ++nb)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    acc[mt][nb][e] += part[mt][nb][e] * sv[nb][e & 1];
                    part[mt][nb][e] = 0.f;
                  }
            }
          }
        } else {
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
        }
        mbar_arrive(bars + 8 * (S + s));
      }

      if (split == 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt > 0 && a.res != nullptr) load_group<INT4>(a, t, m0 + mt * 16, warp, lane, ops);
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
        if (u != u0) load_group<INT4>(a, t, m0 + (u % MT) * 16, u / MT, lane, ops);
        finish_group(a, t, m0 + (u % MT) * 16, u / MT, lane, v, ops);
      }
      // between two items of a cluster the receive slots are reused
      const bool last = p + 1 == npass && t + (int)gridDim.x >= a.ntiles;
      if (!last) cluster_sync();
    }
  }
}

// ---- B6-int4: the int4 head as the transposed product on wgmma --------------
//
// out = bf16(sum over groups g, in order, of f32(x_g @ q_g) * s_g), q packed
// int4 [In / 2, Out], no epilogue: the draft's int4 lm_head (Out 128256),
// whose 501 tiles of 256 columns fill the card without a split of the
// contraction.  At M = 64 an int4 weight byte feeds 256 flops, near the
// tensor cores' ridge (~295 flop/byte): mma.sync at MT = 4 (the cluster
// kernel above) sets the time there, so this kernel puts the products on
// wgmma and keeps the conversion in registers.
//
// - The transposed product.  out^T [Out, M] = q^T [Out, In] x^T [In, M]:
//   the weight is wgmma's A operand, from registers, and x its B operand, a
//   K-major tile in shared memory (N = 16, 32 or 64 rows of x a pass, so
//   M = 32 wastes no tensor-core rows, as m64 over x would).
// - Conversion in registers, no second tile.  Two consumer warpgroups each
//   own 128 columns of a tile: two m64 A tiles.  A thread's A fragment needs,
//   a k16 step, contraction rows 2 t4, 2 t4 + 1 and 2 t4 + 8, 2 t4 + 9 of
//   its two rows: packed rows t4 and t4 + 4, so two 32-bit shared loads
//   (packed rows t4 and t4 + 4, four columns each) give both A tiles'
//   fragments in the weight's own row order, each byte one bf16x2 {low
//   nibble, high nibble} by i4_pair.  A row of an A tile is a column of the
//   weight: tile jt's row 16 warp + g + 8 h holds column colb + 2 jt + h,
//   colb = 64 (g / 4) + 16 warp + 4 (g % 4), so the 32 lanes read 32
//   different banks of the 128-byte-swizzled box and a thread's four
//   output columns are adjacent (one 8-byte store a token).
// - Group sums in order.  Each group's products accumulate in a fresh f32
//   wgmma accumulator (scale-d 0 at its first k16 step) and are added as acc
//   += part * s_g once they complete; the A registers rotate through
//   T4_SETS sets, so one k16 step converts while the last ones' wgmmas run.
// - Loads by TMA.  One producer warp (one lane) keeps a ring of stages in
//   flight: 64 packed rows (128 contraction rows) of the tile's 256 columns
//   as two 8 KB boxes (128-byte swizzle), the same 128 contraction rows of
//   the pass's x rows (two 64-value boxes, 128-byte swizzle; rows past M
//   arrive as zeros), and the stage's group scales of the tile's columns
//   (bulk copies).  Blocks are persistent (one an SM) and walk the tiles, so
//   the next tile's loads overlap this tile's last groups and stores; rows
//   past N run as further passes over the tile.
// - No split, no atomics: two launches give the same bits.
constexpr int T4_COLS = 256;                     // output columns a tile
constexpr int T4_WG = 2;                         // consumer warpgroups, 128 columns each
constexpr int T4_THREADS = 128 * T4_WG + 32;     // + one producer warp
constexpr int T4_PROWS = 64;                     // packed weight rows a stage
constexpr int T4_KS = 2 * T4_PROWS;              // contraction rows a stage
constexpr int T4_WBOX = T4_PROWS * 128;          // a warpgroup's weight box, 8 KB
constexpr int T4_SETS = 2;                       // A register sets: k16 steps in flight

template <int N>
struct Cfg4 {
  static constexpr int X_BYTES = N * T4_KS * 2;             // two 64-value boxes of N rows
  static constexpr int SC_BYTES = MAX_G4 * T4_COLS * 4;     // the stage's group scales
  static constexpr int STAGE = T4_WG * T4_WBOX + X_BYTES + SC_BYTES;
  static constexpr int STAGES = N == 64 ? 5 : (N == 32 ? 7 : 8);
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;  // + slack to align to 1024
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

struct Args4 {
  CUtensorMap wmap;        // q [In / 2, Out] bytes, box {128, T4_PROWS}, 128-byte swizzle
  CUtensorMap xmap;        // x [M, In] bf16, box {64, N}, 128-byte swizzle
  const float* scale;      // [In / group, Out]
  __nv_bfloat16* out;      // [M, Out]
  int M, In, Out, group, ntiles;
};

namespace {

// D (+)= A B over one k16 step, m64nNk16: A (the weight) from registers in
// the mma A fragment layout, B (x) K-major from shared memory (128-byte
// swizzle).  d[4 j + e]: A row 16 warp + g + 8 (e / 2), x row 8 j + 2 t4 + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_wx(float (&d)[N / 2], uint32_t (&a)[4], uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_wx<16>(float (&d)[8], uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_wx<32>(float (&d)[16], uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_wx<64>(float (&d)[32], uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(accumulate));
}

// Keep A registers (one set: [A tile][register]) unchanged until the
// wgmmas that read them have completed: a use after the wait.
__device__ __forceinline__ void fence_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int jt = 0; jt < 2; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[jt][e])::"memory");
}

}  // namespace

// Grid (blocks), T4_THREADS threads: warpgroups 0 and 1 consume (128
// columns of each tile each), warp 8 produces.  One block an SM.
template <int N>
__global__ void __launch_bounds__(T4_THREADS, 1) qmm4_sm90_kernel(const __grid_constant__ Args4 a) {
  using C = Cfg4<N>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  // full[s] at 8 s, empty[s] at 8 (S + s)
  const uint32_t bars = sbase + C::BARS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = a.In / T4_KS;
  const int npass = (a.M + N - 1) / N;
  const int ng = max(1, T4_KS / a.group);  // the scale rows a stage brings

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(bars + 8 * (S + s), 128 * T4_WG);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * T4_WG) {
    // ---- producer: one lane issues the loads ---------------------------------
    if (lane != 0) return;
    prefetch_map(&a.wmap);
    prefetch_map(&a.xmap);
    int it = 0;
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      const int c0 = t * T4_COLS;
      const int cols = min(T4_COLS, a.Out - c0);  // the last tile may hold 128
      for (int p = 0; p < npass; ++p) {
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % S;
          mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);  // the consumers released it
          const uint32_t full = bars + 8 * s;
          const uint32_t st = sbase + s * C::STAGE;
          const int kt = i * T4_KS;
          mbar_expect_tx(full, T4_WG * T4_WBOX + C::X_BYTES + ng * cols * 4);
          // a box past Out arrives as zeros (its bytes still count)
#pragma unroll
          for (int w = 0; w < T4_WG; ++w)
            tma_load_2d(st + w * T4_WBOX, &a.wmap, full, c0 + 128 * w, kt / 2);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_2d(st + T4_WG * T4_WBOX + j * N * 128, &a.xmap, full, kt + 64 * j, p * N);
          const uint32_t sc = st + T4_WG * T4_WBOX + C::X_BYTES;
          for (int j = 0; j < ng; ++j)
            bulk_load(sc + j * T4_COLS * 4,
                      a.scale + (size_t)(kt / a.group + j) * a.Out + c0, cols * 4, full);
        }
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------------
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // this thread's four weight columns in its warpgroup's 128: colb .. colb + 3
  const int colb = (g >> 2) * 64 + 16 * wi + 4 * (g & 3);
  const int chunk = colb >> 4;
  // its words of packed rows t4 and t4 + 4 of each k16 step (+ 1024 a step)
  const uint32_t w_off0 = wg * T4_WBOX + t4 * 128 + ((chunk ^ t4) << 4) + (colb & 15);
  const uint32_t w_off1 = wg * T4_WBOX + (t4 + 4) * 128 + ((chunk ^ (t4 + 4)) << 4) + (colb & 15);
  int it = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const int col = t * T4_COLS + 128 * wg + colb;  // this thread's first output column
    for (int p = 0; p < npass; ++p) {
      float acc[2][N / 2], part[2][N / 2];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[jt][e] = part[jt][e] = 0.f;
      uint32_t af[T4_SETS][2][4] = {};  // [set][A tile][register]
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % S;
        mbar_wait(bars + 8 * s, (it / S) & 1);  // the stage's boxes have landed
        const uint8_t* st = smem + s * C::STAGE;
        const uint32_t xst = sbase + s * C::STAGE + T4_WG * T4_WBOX;
        const float* sc = reinterpret_cast<const float*>(st + T4_WG * T4_WBOX + C::X_BYTES) +
                          128 * wg + colb;
        const int kt = i * T4_KS;
#pragma unroll
        for (int kk = 0; kk < T4_KS / 16; ++kk) {
          uint32_t (&A)[2][4] = af[kk % T4_SETS];
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(st + w_off0 + kk * 1024);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(st + w_off1 + kk * 1024);
          const uint32_t w04 = w0 >> 4, w14 = w1 >> 4;
          // tile 0: columns colb (row g) and colb + 1 (row g + 8); tile 1: colb + 2, + 3
          A[0][0] = i4_pair<0x4400u>(w0, w04);
          A[0][1] = i4_pair<0x5511u>(w0, w04);
          A[0][2] = i4_pair<0x4400u>(w1, w14);
          A[0][3] = i4_pair<0x5511u>(w1, w14);
          A[1][0] = i4_pair<0x6622u>(w0, w04);
          A[1][1] = i4_pair<0x7733u>(w0, w04);
          A[1][2] = i4_pair<0x6622u>(w1, w14);
          A[1][3] = i4_pair<0x7733u>(w1, w14);
          // x rows of this pass, contraction rows kt + 16 kk ..: box kk / 4, 32 bytes a step
          const uint64_t xd = smem_desc(xst + (kk >> 2) * N * 128, 16, 1024) + 2 * (kk & 3);
          const int first = ((kt + 16 * kk) & (a.group - 1)) != 0;  // 0: a fresh group
          wgmma_fence();
          wgmma_wx<N>(part[0], A[0], xd, first);
          wgmma_wx<N>(part[1], A[1], xd, first);
          wgmma_commit();
          if (((kt + 16 * (kk + 1)) & (a.group - 1)) == 0) {
            // the group ends here: its sums, scaled, into acc (columns colb
            // .. + 3: tile 0 rows g, g + 8, tile 1 rows g, g + 8)
            wgmma_wait<0>();
            fence_regs(part[0]);
            fence_regs(part[1]);
#pragma unroll
            for (int j = 0; j < T4_SETS; ++j) fence_a(af[j]);
            const float4 sv = *reinterpret_cast<const float4*>(
                sc + (a.group >= T4_KS ? 0 : (16 * kk) / a.group) * T4_COLS);
            const float f[2][2] = {{sv.x, sv.y}, {sv.z, sv.w}};
#pragma unroll
            for (int jt = 0; jt < 2; ++jt)
#pragma unroll
              for (int e = 0; e < N / 2; ++e) acc[jt][e] += part[jt][e] * f[jt][(e >> 1) & 1];
          } else if (kk + 1 == T4_KS / 16) {
            wgmma_wait<0>();  // the stage's x read before it is released
#pragma unroll
            for (int j = 0; j < T4_SETS; ++j) fence_a(af[j]);
          } else {
            wgmma_wait<T4_SETS - 1>();  // the next step's A set is free again
            fence_a(af[(kk + 1) % T4_SETS]);
          }
        }
        mbar_arrive(bars + 8 * (S + s));
      }
      // out[m, col .. col + 3] for the thread's x rows m = p N + 8 j + 2 t4 + e
      if (col < a.Out) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = p * N + 8 * j + 2 * t4 + e;
            if (m >= a.M) continue;
            const float y[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                                acc[1][4 * j + 2 + e]};
            *reinterpret_cast<uint2*>(a.out + (size_t)m * a.Out + col) = pack_bf16x4(y);
          }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

// The weight's map over its [rows, Out] bytes (int8 q, or packed int4 q with
// rows = In / 2), encoded once per (pointer, shape).
static CUresult weight_map(CUtensorMap* map, const int8_t* q, int rows, int Out) {
  return cached_map(map, std::make_tuple(static_cast<const void*>(q), rows, Out),
                    [&](CUtensorMap* m) {
                      return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 1, Out, rows, HALF,
                                       BK, CU_TENSOR_MAP_SWIZZLE_64B);
                    });
}

template <bool INT4, int MT>
static cudaError_t launch(Args& a, int split, cudaStream_t st) {
  using C = Cfg<INT4, MT>;
  // once per instantiation: the attribute, and the blocks an SM holds
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_sm90_kernel<INT4, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmm_sm90_kernel<INT4, MT>, NTHREADS,
                                                  C::SMEM);
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
  return cudaLaunchKernelEx(&cfg, qmm_sm90_kernel<INT4, MT>, a);
}

// The checks and the launch both entry points share; unit: the contraction
// rows a split is cut in (a multiple of the stage's).
template <bool INT4>
static int run(Args& a, const void* q, int split, int unit, cudaStream_t st) {
  const int tiles = a.In / unit;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return (int)cudaErrorInvalidValue;  // an empty split
  const CUresult enc = weight_map(&a.wmap, static_cast<const int8_t*>(q), INT4 ? a.In / 2 : a.In,
                                  a.Out);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  a.kchunk = per * unit;
  a.ntiles = a.Out / BN;
  const int rows = min(a.M, INT4 ? 64 : 128);
  cudaError_t err;
  if (rows <= 16)
    err = launch<INT4, 1>(a, split, st);
  else if (rows <= 32)
    err = launch<INT4, 2>(a, split, st);
  else if (rows <= 64 || INT4)
    err = launch<INT4, 4>(a, split, st);
  else
    err = launch<INT4, INT4 ? 4 : 8>(a, split, st);
  if ((int)err >= kEncodeError) return (int)err;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int4 weight's map for B6-int4: box {128 columns, 64 packed rows},
// 128-byte swizzle, encoded once per (pointer, shape).
static CUresult weight_map4(CUtensorMap* map, const int8_t* q, int rows, int Out) {
  return cached_map(map, std::make_tuple(static_cast<const void*>(q), rows, Out),
                    [&](CUtensorMap* m) {
                      return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 1, Out, rows, 128,
                                       T4_PROWS, CU_TENSOR_MAP_SWIZZLE_128B);
                    });
}

template <int N>
static cudaError_t launch4(Args4& a, const void* x, cudaStream_t st) {
  using C = Cfg4<N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm4_sm90_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return max(1, n);
  }();
  const CUresult enc = encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, a.In, a.M,
                                 64, N, CU_TENSOR_MAP_SWIZZLE_128B);
  if (enc != CUDA_SUCCESS) return static_cast<cudaError_t>(kEncodeError + enc);
  qmm4_sm90_kernel<N><<<min(a.ntiles, sms), T4_THREADS, C::SMEM, st>>>(a);
  return cudaSuccess;
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
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.norm_w = static_cast<const __nv_bfloat16*>(norm_w);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.In = In;
  a.Out = Out;
  a.gate = gate != 0;
  a.group = In;
  a.eps = eps;
  return run<false>(a, q, split, BK, static_cast<cudaStream_t>(stream));
}

// B4-int4: out = epilogue(x[M, In] @ dequant(q[In / 2, Out] packed int4,
// scale[In / group, Out])) in one launch, the epilogue the SiLU gate (gate:
// out [M, Out / 2]), a residual res [M, Out] (or null), or none.  group: a
// power of two >= 32 with In % max(group, 128) == 0; split: the
// contraction's splits in units of max(group, 128) rows (1..8, none empty,
// the wrapper's cluster_split_plan).  Returns as md_quant_matmul_sm90.
extern "C" int md_quant_matmul_int4_sm90(const void* x, const void* q, const void* scale,
                                         const void* res, void* out, int M, int In, int Out,
                                         int gate, int split, int group, void* stream) {
  using namespace md::sm90;
  constexpr int KS = Cfg<true, 1>::KS;
  if (M < 1 || M > MAX_ROWS || Out % BN != 0 || split < 1 || split > MAX_SPLIT ||
      (gate && res != nullptr) || group < 32 || (group & (group - 1)) != 0 ||
      In % max(group, KS) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.norm_w = nullptr;
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.In = In;
  a.Out = Out;
  a.gate = gate != 0;
  a.group = group;
  a.eps = 0.f;
  return run<true>(a, q, split, max(group, KS), static_cast<cudaStream_t>(stream));
}

// B6-int4: out [M, Out] = bf16(x[M, In] @ dequant(q[In / 2, Out] packed int4,
// scale[In / group, Out])) in one launch, the groups summed in order (no
// split of the contraction).  group: a power of two >= 32 with In % max(group,
// 128) == 0; Out % 128 == 0; M <= 256.  Returns as md_quant_matmul_sm90.
extern "C" int md_quant_matmul_int4_t_sm90(const void* x, const void* q, const void* scale,
                                           void* out, int M, int In, int Out, int group,
                                           void* stream) {
  using namespace md::sm90;
  if (M < 1 || M > MAX_ROWS || Out % 128 != 0 || group < 32 || (group & (group - 1)) != 0 ||
      In % max(group, T4_KS) != 0)
    return (int)cudaErrorInvalidValue;
  Args4 a;
  const CUresult enc = weight_map4(&a.wmap, static_cast<const int8_t*>(q), In / 2, Out);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.In = In;
  a.Out = Out;
  a.group = group;
  a.ntiles = (Out + T4_COLS - 1) / T4_COLS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = M <= 16   ? launch4<16>(a, x, st)
                          : M <= 32 ? launch4<32>(a, x, st)
                                    : launch4<64>(a, x, st);
  if ((int)err >= kEncodeError) return (int)err;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B5 and B9 on Hopper: the draft's int8 layer tail and its FFN block, one
// persistent launch a call.
//
// Replaces magicdec_tpu/ops/pallas/quant_matmul.py quant_layer_tail_pallas
// (:699, _layer_tail_kernel :643: B5, a draft layer's whole post-attention
// tail) and quant_mlp_pallas (:749, _mlp_kernel :386: B9, the FFN block
// alone, which the draft takes where B5 declines).  They compute, with the
// reference's rounding points,
//   phase 0 (B5 only)  h     = x + bf16(a @ wo * so)
//   the norm           hn    = bf16(bf16(h * rsqrt(mean(h^2) + eps)) * norm_w)
//   phase 1            gated = bf16(g * sigmoid(g) * u),  g = bf16(hn @ wg * sg),
//                                                         u = bf16(hn @ wu * su)
//   phase 2            out   = bf16(gated @ w2 * s2) + residual
// over int8 weights with one f32 scale per output column and f32 sums; B5's
// residual is h, B9's optional (B9 runs phases 1 and 2 on its input x).
//
// B15's dense_mlp is B9 on bf16 weights without scales (ffn_bf16_sm90_kernel,
// the same phases on a bf16 stage): it replaces dense_mlp_pallas (:605,
// _dense_mlp_kernel :551), the target's FFN block on its decode and verify
// passes where the A/B switch set_dense_kernels routes it.  Its rounding
// points are B9's: the norm, g and u rounded to bf16 before the f32 gate,
// one bf16 rounding of each dot, the residual added in bf16; where B9
// multiplies a sum by its column scale, dense_mlp takes the sum as it is.
//
// Bound: the int8 weight's HBM bytes.  At the draft's M <= 128 rows a weight
// byte feeds 2M <= 256 flops, under the ~295 flop/byte where the bf16 tensor
// cores limit; the 1B tail streams 52 MiB (16.4 us at 3.35 TB/s), its three
// dots as separate launches paid a pipeline fill and drain each, and the old
// kernels (seven launches a B5 call, f32 split-K partials, h, hn and gated
// through HBM) reached 24.5% of the bound.  dense_mlp streams 96 MiB of bf16
// weight at the 1B widths (30 us); a bf16 byte feeds M <= 512 flops, the
// tensor cores' limit only past ~295 rows.  Its old five launches (norm,
// w13, gate, w2, residual; split-K partials through HBM) reached 22% of
// the bound at 128 rows.  The design keeps the weight streaming across the
// whole call:
//
// - One launch, persistent.  The grid is the clusters of 8 blocks (bf16:
//   runs of 8, no cluster) that the card holds at once
//   (cudaOccupancyMaxActiveClusters, read once a core; the wrapper caps the
//   grid by it, and the C side refuses a larger one: a grid barrier over
//   blocks that are not resident would never open).  In each phase the
//   cluster is cut into groups of `split` ranks (split 1, 2, 4 or 8, a
//   function of the phase's weight shape alone,
//   kernels/quant_matmul.py ffn_split_plan); each group walks the phase's
//   128-column tiles (with the gate: 64 gate columns and the 64 matching up
//   columns), each rank a 1/split share of the contraction.
// - Grid barriers between the steps: B5's norm needs whole rows of h,
//   phase 1 all of hn and phase 2's contraction all of gated (B9 and
//   dense_mlp take their statistic from x in the norm's own blocks: two
//   barriers a call).  It is an arrival counter and a
//   generation word in global memory (release/acquire at gpu scope): the
//   last block to arrive resets the counter and bumps the generation, and a
//   launch waits for the generation it read at its start plus the barriers
//   passed, so the words need no reset between calls and replay from a CUDA
//   graph.  A block arrives only once it has seen the barrier before open
//   (a block with no tile in a phase gets there early).  One call at a time
//   a device uses them.
// - The weights cross the barrier early.  No phase's weight depends on an
//   earlier phase, so the producer issues the next phase's weight boxes into
//   the ring while the block waits at the barrier; only the x-operand boxes
//   (hn, gated) wait for it.  A block idle in a phase (16 column tiles of wo
//   or w2 over 32 clusters) prefetches at once.  The ring's fill is hidden
//   behind the barrier instead of paid at each.
// - The statistic comes from phase 0.  The warp that finishes 32 columns of
//   a row of h (16 of each half of a tile) writes their sum of squares (of h
//   as rounded to bf16, in a fixed order) into slot [row][4 tile + warp];
//   after the barrier the block that normalizes a row adds its slots in a
//   fixed order (four threads a row, each every fourth group of four
//   slots), so no h row is read twice.  B9 and dense_mlp have no phase 0:
//   the block that normalizes a row sums its slots of x itself, in shared
//   memory.  Every block normalizes its share of the rows into hn (a grid
//   barrier after it), and phase 1 streams hn as
//   it is: a norm of each landed tile cost the consumers as much again.
// - Split-K on chip, no atomics in any sum.  A group's ranks add their f32
//   partials through the owning rank's receive area (st.async into
//   distributed shared memory, completing on the owner's mbarrier), the
//   owner adding them in split order, as B4.  Between two items of a group
//   each owner, having read its slots, arrives on a "free" mbarrier of every
//   rank of its group (count 8 in all), and a rank stores its next partials
//   once that barrier's phase completed: the producer never stops for a
//   cluster barrier, so the ring runs on across items.  The bf16 core (and
//   the int8 wgmma core) has no cluster: a rank stores its f32 partial of an
//   item into L2, the group's ranks meet on the item's own counter and
//   generation words, and each rank adds every split-th quad of the item in
//   split order.  Two calls give the same bits; the tokens do not vary from
//   run to run.
// - The product core (B4's, quant_matmul_sm90.cu): one producer warp keeps a
//   ring of TMA stages (two 64-column boxes of 64 int8 weight rows, 64-byte
//   swizzle, and the x tile of the same contraction rows, 128-byte swizzle,
//   rows past M arriving as zeros) on mbarriers; four consumer warps take
//   the weight by ldmatrix.trans, convert it in registers (i8_pair: exact,
//   two logic ops and a bf16x2 subtraction a pair) into mma.sync B fragments
//   and run m16n8k16 over MT = 1, 2, 4 or 8 row tiles (M <= 16, 32, 64, 128
//   rows; every row in one pass).  The bf16 stage holds two boxes of 64
//   columns (128 bytes a row) by 64 rows, 8 KB each under the 128-byte
//   swizzle (sm90_common.cuh bf16_weight_map, as dense_matmul_sm90.cu), and
//   ldmatrix.trans gives the mma B fragments straight from them, no
//   conversion.  Rows past 128 (dense_mlp: up to the dense routing's 512)
//   take further 128-row passes of each tile in the one launch, each
//   re-streaming the tile's weight (from L2: a group's passes of a tile run
//   back to back).
// - Row invariance (dense_mlp; the greedy spec == AR contract pads the AR
//   step to the verify pass's rows): a row's bits depend on its own data
//   only.  Every M runs the same instruction shape on the same k-steps in
//   order, the statistic's slots are added in a fixed order, and the splits
//   come from the weights' shapes and the card, never from M
//   (kernels/dense_matmul.py dense_mlp_plan), so the rows of an M = 16 call
//   equal those of an M = 128 or 402 call bit for bit.  The grid (the
//   resident clusters of the core M picks) only changes which block runs
//   an item.
// - Intermediates: h (bf16, also phase 2's residual), hn, gated (bf16) and
//   B5's statistic slots go through global memory, which at these sizes (M x
//   D, M x F) stays in the 50 MB L2; the reference keeps them in VMEM.  Data
//   written in this launch is read with ld.global.cg (not the read-only
//   path), and its writers and the TMA reader each fence the async proxy.
#include <tuple>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace ffn90 {
namespace {  // internal linkage: a second build of this file loads beside it

using namespace md::sm90;

constexpr int BK = 64;         // contraction rows a stage
constexpr int HALF = 64;       // weight columns a TMA box: half a tile
constexpr int BN = 2 * HALF;   // output columns a tile
constexpr int NCW = 4;         // consumer warps of the mma.sync core
constexpr int CLUSTER = 8;     // blocks a cluster (the portable maximum), or a run
constexpr int MAX_ROWS = 256;  // the int8 routing's ROWS_CAP (quantization.py)
constexpr int DENSE_ROWS = 512;  // dense_mlp: the dense routing's rows_hint cap
constexpr int SLOT_COLS = 32;  // columns of h a statistic slot sums
constexpr int SL_FLOATS = 512;  // a norm round's slots in shared memory (B9, dense_mlp)
constexpr int TILE_BARS = 1024;  // split items a phase (their meeting words)

// The mma.sync core: MT row tiles of 16 a pass, NCW consumer warps; int8 or
// (BF16, dense_mlp) bf16 weight boxes.  Two blocks an SM up to MT = 4.  The
// int8 core's groups reduce their split-K partials through DSMEM inside a
// cluster of 8.  The bf16 core's go through L2 as the wgmma core's do, with
// no cluster: at one block an SM (MT = 8) the H100 holds 15 clusters of 8
// (or 30 of 4), 120 blocks for w13's 128 column tiles, which then take two
// rounds or split-K items whose groups wait ~6 us for their slowest rank
// each; runs of 8 without a cluster put a block on 128 SMs (PERF.md §6).
// It has no receive area, so its ring takes the room: 6, 5, 4 and 6
// stages, 96, 80, 64 and 96 KB of weight in flight a block.
template <int MT, bool BF16 = false>
struct Cfg {
  static constexpr bool CLUSTERED = !BF16;   // int8: groups reduce through DSMEM
  static constexpr int NCONS = NCW;          // consumer warps
  static constexpr int THREADS = 32 * (NCONS + 1);
  static constexpr int BLOCKS_SM = MT <= 4 ? 2 : 1;
  static constexpr int R = 16 * MT;          // x rows a pass
  static constexpr int W_BYTES = BK * HALF * (BF16 ? 2 : 1);  // one weight box, 4 or 8 KB
  static constexpr int X_BYTES = R * BK * 2;  // the x tile, 128 bytes a row
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int STAGES = BF16 ? (MT == 1 ? 6 : (MT == 2 ? 5 : (MT == 4 ? 4 : 6)))
                                     : (MT == 1 ? 7 : (MT == 2 ? 5 : (MT == 4 ? 3 : 4)));
  static constexpr int RING = STAGES * STAGE;
  // the fragment groups (2 KB: 4 mma fragments x 32 lanes x 16 B) a rank
  // reduces, each with a slot for every rank of its group
  static constexpr int RECV = RING;
  static constexpr int RECV_BYTES = CLUSTERED ? (NCW * MT + CLUSTER) * 2048 : 0;
  // full[STAGES], empty[STAGES], red, free; a norm round's rows' factors
  // and slots
  static constexpr int BARS = RECV + RECV_BYTES;
  static constexpr int RR = BARS + 16 * STAGES + 16;
  static constexpr int SL = RR + 4 * 8 * NCONS;
  static constexpr int SMEM = SL + 4 * SL_FLOATS + 1024;  // + slack to align to 1024
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
  static_assert(BLOCKS_SM * (SMEM + 1024) <= 228 * 1024, "BLOCKS_SM blocks an SM");
};

// The wgmma core (B9 at 129..256 rows): the transposed product on two
// consumer warpgroups, every row in one pass (N = 256).  Its ring has the
// mma.sync core's layout at R = 256; split-K partials go through global
// memory (see ffn_wg_sm90_kernel), so it has no receive area and no
// cluster: its "clusters" are runs of 8 blocks.
struct CfgW {
  static constexpr bool CLUSTERED = false;
  static constexpr int NCONS = 8;
  static constexpr int THREADS = 32 * (NCONS + 1);
  static constexpr int R = 256;
  static constexpr int W_BYTES = BK * HALF;
  static constexpr int X_BYTES = R * BK * 2;
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int BARS = STAGES * STAGE;  // full[STAGES], empty[STAGES]
  static constexpr int RR = BARS + 16 * STAGES + 16;
  static constexpr int SL = RR + 4 * 8 * NCONS;
  static constexpr int SMEM = SL + 4 * SL_FLOATS + 1024;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

// One dot of the call: out = epilogue(x @ q * scale), q [In, Out].
struct Phase {
  const float* scale;          // [Out]
  const __nv_bfloat16* res;    // [M, Out] or null
  __nv_bfloat16* out;          // [M, Out], or [M, Out / 2] with the gate
  int In, Out, split, kchunk, ntiles, gate;
};

struct Args {
  // wo [K, D], w13 [D, 2F], w2 [F, D]: box {HALF, BK}; int8 under the 64-byte
  // swizzle, bf16 (dense_mlp: w13 and w2, no scales) under the 128-byte one
  CUtensorMap wmap[3];
  // a [M, K], hn [M, D], gated [M, F]: bf16, box {BK, R}, 128-byte swizzle
  CUtensorMap xmap[3];
  Phase ph[3];          // wo + x; w13 + gate; w2 [+ residual]
  const __nv_bfloat16* x;       // B9: [M, D], the rows of the statistic and the norm
  const __nv_bfloat16* norm_w;  // [D]
  __nv_bfloat16* hn;            // [M, D]: the normalized rows, phase 1's input
  float* slots;                 // B5: [M, D / SLOT_COLS], the rows' sums of squares
  float* part;                  // split-K partials through L2 [split, M, Out]
  // the grid barrier: [0] arrivals, [1] generation; the words where a split
  // item's ranks meet (the wgmma core's tile t, the bf16 core's tile t and
  // row pass q: index i = t or t * passes + q): [2 + 2 i], [3 + 2 i]
  unsigned* bar;
  int M, first, prefetch;       // first: 0 (B5) or 1 (B9)
  float eps;
};

// The NCONS consumer warps only (named barrier 1; the producer warp is not
// in it).
template <int NCONS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS * 32) : "memory");
}

// ---- the grid barrier -----------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// This block's arrival (one thread, after the block's writes of the phase):
// the last of `nblocks` arrivals resets the counter and publishes `gen`.
__device__ __forceinline__ void grid_arrive(unsigned* bar, unsigned nblocks, unsigned gen) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(bar) : "memory");
  if (old == nblocks - 1) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar) : "memory");
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(bar + 1), "r"(gen) : "memory");
  }
}

// Wait until generation `gen` is published (the counter wraps at 2^32).
__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned gen) {
  while ((int)(ld_acquire_gpu(bar + 1) - gen) < 0) __nanosleep(64);
}

// A launch passes its grid barriers numbered from 1: B5's three after phase
// 0, after the norm and after phase 1 (phase p > 0 waits for barrier p +
// 1); B9's and dense_mlp's two after the norm and after phase 1 (phase p
// waits for barrier p).

// The blocks of a split tile meet on their tile's words (the wgmma core):
// the same counter and generation as the grid barrier, `split` arrivals.
// The generation is read before this block's arrival, which the next one
// needs.
__device__ __forceinline__ void tile_meet(unsigned* tb, unsigned split) {
  const unsigned gen = ld_acquire_gpu(tb + 1) + 1;
  grid_arrive(tb, split, gen);
  grid_wait(tb, gen);
}

// Generic-proxy global writes before (or after) the async proxy (TMA) reads
// the same bytes.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- cluster mbarriers ------------------------------------------------------------

// Wait for a phase of a barrier that other ranks arrive on (acquire at
// cluster scope: their reads of this rank's data come before it).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `count` arrivals on a barrier of another rank (a shared::cluster address).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// ---- the work of one phase ----------------------------------------------------------

// This block's share of a phase: its group of `split` ranks (ranks base ..
// base + split - 1 of the cluster), its rank rg in the group, the group's
// first tile and stride, and its contraction range [k0, k0 + nk BK).
struct Work {
  int split, rg, base, unit, nunits, k0, nk;
};

__device__ __forceinline__ Work work_of(const Phase& ph, uint32_t rank) {
  Work w;
  w.split = ph.split;
  w.rg = (int)rank % ph.split;
  const int group = (int)rank / ph.split;
  w.base = group * ph.split;
  // the groups' units run across the clusters first, so that a phase with
  // fewer tiles than groups keeps every cluster (and so every SM) busy
  const int nclusters = gridDim.x / CLUSTER;
  w.unit = group * nclusters + blockIdx.x / CLUSTER;
  w.nunits = nclusters * (CLUSTER / ph.split);
  w.k0 = w.rg * ph.kchunk;
  w.nk = (min(ph.In, w.k0 + ph.kchunk) - w.k0) / BK;
  return w;
}

// ---- the epilogue -------------------------------------------------------------------

// A lane's four values of a fragment group's row in each 64-column box:
// values 0, 1 at columns col and col + 1 of the box, values 2, 3 at col + D
// and col + D + 1.  int8: the i8_pairs fragments hold the even and the odd
// columns, so the four are adjacent (col 16 uw + 4 t4, D 2); bf16: the box's
// own n8 fragments of chunks 2 uw and 2 uw + 1 (col 16 uw + 2 t4, D 8).
// v(frag, box, h, j): value j of row half h (fragment value 2 h or 2 h + 1).
template <bool BF16>
struct Lane {
  static constexpr int D = BF16 ? 8 : 2;
  __device__ __forceinline__ static int col(int uw, int lane) {
    return 16 * uw + (BF16 ? 2 : 4) * (lane & 3);
  }
  __device__ __forceinline__ static float v(const float (&f)[4][4], int box, int h, int j) {
    return BF16 ? f[2 * box + (j >> 1)][2 * h + (j & 1)] : f[2 * box + (j & 1)][2 * h + (j >> 1)];
  }
};

// A lane's four bf16 values of a row (y, see Lane) as the 8 bytes it stores
// at columns 16 uw + 4 t4 .. + 3 of the box: int8, its own (adjacent)
// values; bf16, the quad's lanes trade them (the four hold the row's 16
// columns), so that a row segment takes one 8-byte store a lane, half the
// 4-byte stores and their L2 sectors.  Every lane of the warp takes part.
template <bool BF16>
__device__ __forceinline__ uint2 lane_store(const float (&y)[4], int lane) {
  if (!BF16) return pack_bf16x4(y);
  const uint32_t p0 = pack_bf16x2(y[0], y[1]), p1 = pack_bf16x2(y[2], y[3]);
  const int t4 = lane & 3, src = (lane & ~3) | ((t4 & 1) << 1);
  const uint32_t a0 = __shfl_sync(0xffffffffu, p0, src), a1 = __shfl_sync(0xffffffffu, p0, src + 1);
  const uint32_t b0 = __shfl_sync(0xffffffffu, p1, src), b1 = __shfl_sync(0xffffffffu, p1, src + 1);
  return t4 < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
}

// SiLU(g) * u of bf16-rounded g and u, in f32: int8 (B5, B9) the exact
// expf and division; bf16 (dense_mlp) the exp2-based __expf and __fdividef
// (a few f32 ulps, under the bf16 rounding that follows): with one warp a
// scheduler the exact forms' dependent chains took ~4 us of dense_mlp's
// w13 epilogue at 128 rows (PERF.md §6).
template <bool BF16>
__device__ __forceinline__ float gate(float gv, float uv) {
  if (BF16) return __fdividef(gv, 1.f + __expf(-gv)) * uv;
  return gv * (1.f / (1.f + expf(-gv))) * uv;
}

// A lane's residual values (see Lane) from global memory (this launch's
// data: not the read-only path).
template <bool BF16>
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* row, int col) {
  if (BF16)
    return make_uint2(__ldcg(reinterpret_cast<const unsigned*>(row + col)),
                      __ldcg(reinterpret_cast<const unsigned*>(row + col + Lane<BF16>::D)));
  return __ldcg(reinterpret_cast<const uint2*>(row + col));
}

// v * the column scales of its four values (int8); bf16 sums as they are.
template <bool BF16>
__device__ __forceinline__ void scale4(float (&v)[4], const float4& s) {
  if (!BF16) {
    v[0] *= s.x;
    v[1] *= s.y;
    v[2] *= s.z;
    v[3] *= s.w;
  }
}

// The scales (int8) and residual of one fragment group (see finish_group):
// sc[box] (with the gate: sc[0] the gate's, sc[1] the up's), rv[h][box] for
// rows row0 + g + 8 h.
struct GroupOperands {
  float4 sc[2];
  uint2 rv[2][2];
};

template <bool BF16>
__device__ __forceinline__ void load_group(const Phase& ph, int M, int t, int row0, int uw,
                                           int lane, GroupOperands& o) {
  const int cw = Lane<BF16>::col(uw, lane);
  const int c0 = ph.gate ? t * HALF : t * BN;
  const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;
  if (!BF16) {
    o.sc[0] = __ldg(reinterpret_cast<const float4*>(ph.scale + c0 + cw));
    o.sc[1] = __ldg(reinterpret_cast<const float4*>(ph.scale + c1 + cw));
  }
  if (ph.res == nullptr) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int box = 0; box < 2; ++box)
      o.rv[h][box] = m < M ? load4<BF16>(ph.res + (size_t)m * ph.Out + (box ? c1 : c0), cw)
                           : make_uint2(0, 0);
  }
}

// The epilogue of one fragment group: rows row0 + g and row0 + g + 8 of a row
// tile, columns 16 uw .. 16 uw + 15 of each 64-column box of tile t; v[nb]
// is mma fragment nb's f32 sums (nb 0/1 of box 0, 2/3 of box 1; a lane's
// four values of a row and their columns: Lane).  Box 0 holds the gate
// columns and box 1 the up columns with the gate, else the tile's first and
// second 64 columns.  With `slots` (phase 0, int8), the sum of squares of
// the row's 32 columns here (the output as rounded to bf16; each lane its
// eight in order, then the quad's lanes as (l0 + l1) + (l2 + l3)) goes to
// slot [row][4 t + uw].
template <bool BF16>
__device__ __forceinline__ void finish_group(const Phase& ph, int M, int t, int row0, int uw,
                                             int lane, const float (&v)[4][4],
                                             const GroupOperands& o, float* slots) {
  const int g = lane >> 2, c16 = 16 * uw + 4 * (lane & 3);  // the lane's store column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + g + 8 * h;
    float v0[4], v1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v0[j] = Lane<BF16>::v(v, 0, h, j);
      v1[j] = Lane<BF16>::v(v, 1, h, j);
    }
    scale4<BF16>(v0, o.sc[0]);
    scale4<BF16>(v1, o.sc[1]);
    if (ph.gate) {
      const int F = ph.Out / 2;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = gate<BF16>(bf16_round(v0[j]), bf16_round(v1[j]));
      const uint2 sv = lane_store<BF16>(y, lane);
      if (m < M) *reinterpret_cast<uint2*>(ph.out + (size_t)m * F + t * HALF + c16) = sv;
      continue;
    }
    float ss = 0.f;
#pragma unroll
    for (int box = 0; box < 2; ++box) {
      const int n = t * BN + box * HALF;
      const float* vb = box ? v1 : v0;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = bf16_round(vb[j]);
      if (ph.res != nullptr) {
        const uint2 rv = o.rv[h][box];
        const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.x));
        const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.y));
        y[0] += r01.x;
        y[1] += r01.y;
        y[2] += r23.x;
        y[3] += r23.y;
      }
      const uint2 sv = lane_store<BF16>(y, lane);
      if (m < M) *reinterpret_cast<uint2*>(ph.out + (size_t)m * ph.Out + n + c16) = sv;
      if (slots != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float hv = bf16_round(y[j]);
          ss += hv * hv;
        }
      }
    }
    if (slots != nullptr) {
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if ((lane & 3) == 0 && m < M) slots[(size_t)m * (ph.Out / SLOT_COLS) + 4 * t + uw] = ss;
    }
  }
}

// ---- the parts both cores share ---------------------------------------------

// The block's shared memory aligned to 1024 bytes (the swizzle patterns
// repeat every 1024 bytes of the shared address), and its barriers:
// full[s] at 8 s, empty[s] at 8 (S + s), then two more (extra).
struct Block {
  uint8_t* smem;
  uint32_t sbase, bars, extra;
};

// Initializes the ring's and the two extra barriers (their counts) and
// reads the grid barrier's generation before this launch's first barrier
// (no block can have arrived yet: the first barrier needs every block's
// arrival).  Ends with the block's barrier and, in a cluster, the cluster's
// relaxed arrival (the ranks' barriers must be initialized before the
// first remote operation: every thread waits for the cluster before it).
template <class C>
__device__ __forceinline__ Block block_setup(const Args& a, uint8_t* smem_raw, unsigned* gen0,
                                             uint32_t count1, uint32_t count2) {
  Block b;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  b.smem = smem_raw + pad;
  b.sbase = raw + pad;
  b.bars = b.sbase + C::BARS;
  b.extra = b.bars + 16 * C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(b.bars + 8 * s, 1);                             // the producer's expect_tx
      mbar_init(b.bars + 8 * (C::STAGES + s), C::NCONS * 32);  // every consumer thread
    }
    mbar_init(b.extra, count1);
    mbar_init(b.extra + 8, count2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *gen0 = ld_acquire_gpu(a.bar + 1);
  }
  __syncthreads();
  if (C::CLUSTERED) cluster_arrive_relaxed();
  return b;
}

// The producer warp: lane 0 issues every phase's TMA loads into the ring;
// the other lanes complete the cluster's first barrier and leave.
template <class C>
__device__ __forceinline__ void produce(const Args& a, const Block& b, uint32_t rank,
                                        unsigned g0) {
  constexpr int S = C::STAGES;
  if ((threadIdx.x & 31) != 0) {
    if (C::CLUSTERED) cluster_wait();
    return;
  }
  for (int p = a.first; p < 3; ++p) {
    prefetch_map(&a.wmap[p]);
    prefetch_map(&a.xmap[p]);
  }
  if (C::CLUSTERED) cluster_wait();
  const int npass = (a.M + C::R - 1) / C::R;
  int it = 0;
  for (int p = a.first; p < 3; ++p) {
    const Phase& ph = a.ph[p];
    const Work w = work_of(ph, rank);
    // the barrier before phase p > 0: B5's 2 and 3, B9's and dense_mlp's 1 and 2
    const unsigned gen = g0 + (unsigned)(p + 1 - a.first);
    bool open = p == 0;
    if (!open && !a.prefetch) {
      grid_wait(a.bar, gen);
      fence_proxy_async_global();
      open = true;
    }
    // the x boxes of stages issued before the barrier opened
    int pend_s[S], pend_kt[S], pend_m[S], npend = 0;
    auto flush = [&]() {
      grid_wait(a.bar, gen);
      fence_proxy_async_global();
      for (int j = 0; j < npend; ++j)
        tma_load_2d(b.sbase + pend_s[j] * C::STAGE + 2 * C::W_BYTES, &a.xmap[p],
                    b.bars + 8 * pend_s[j], pend_kt[j], pend_m[j]);
      npend = 0;
      open = true;
    };
    // the group's items: (tile, row pass), a tile's passes in turn
    for (int item = 0; w.unit + item / npass * w.nunits < ph.ntiles; ++item) {
      const int t = w.unit + item / npass * w.nunits, m0 = item % npass * C::R;
      const int c0 = ph.gate ? t * HALF : t * BN;
      const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;
      for (int i = 0; i < w.nk; ++i) {
        // a ring full of stages waiting for their x boxes: the barrier first
        // (it opens only after this block's consumers finished the phase
        // before, by when the whole ring is free)
        if (!open && npend == S) flush();
        const int s = it % S;
        const uint32_t par = (it / S) & 1;
        ++it;
        mbar_wait(b.bars + 8 * (S + s), par ^ 1);  // the consumers released the stage
        const uint32_t full = b.bars + 8 * s;
        mbar_expect_tx(full, 2 * C::W_BYTES + C::X_BYTES);
        const uint32_t st = b.sbase + s * C::STAGE;
        const int kt = w.k0 + i * BK;
        tma_load_2d(st, &a.wmap[p], full, c0, kt);
        tma_load_2d(st + C::W_BYTES, &a.wmap[p], full, c1, kt);
        if (open) {
          tma_load_2d(st + 2 * C::W_BYTES, &a.xmap[p], full, kt, m0);
        } else {
          pend_s[npend] = s;
          pend_kt[npend] = kt;
          pend_m[npend] = m0;
          ++npend;
        }
      }
    }
    if (npend > 0) flush();
  }
}

// The block's arrival at grid barrier n after its writes of a phase (the
// consumer threads).  The counter takes one round at a time, so a block
// first sees barrier n - 1 open: one with no tile in a phase would
// otherwise arrive at the next barrier while the slower blocks still count
// toward this one, and the rounds would mix.
template <class C>
__device__ __forceinline__ void phase_done(const Args& a, unsigned n, unsigned g0) {
  fence_proxy_async_global();
  consumers_sync<C::NCONS>();
  if (threadIdx.x == 0) {
    if (n > 1) grid_wait(a.bar, g0 + n - 1);
    grid_arrive(a.bar, gridDim.x, g0 + n);
  }
}

// The norm before phase 1, by every block's consumer threads: block b
// takes rows b, b + grid, ... (a row a block at the decode rows), a round
// of rows at a time.  A row's statistic is the sum of its 32-column slots'
// sums of squares (each in column order): B5's slots come from phase 0's
// epilogue (in global memory, once every block wrote them: grid barrier
// 1), B9's and dense_mlp's the block takes from x itself into shared
// memory (no barrier: the block reads its whole rows).  Four threads a row
// add the slots, quarter q the row's float4s of slots q, q + 4, ... in
// order (eight loads in flight), then (q0 + q1) + (q2 + q3), into the
// factor rr = 1 / sqrt(mean + eps); then the block writes those rows of
// hn = bf16(bf16(x * rr) * norm_w) (x: h or the input), 16 bytes a thread
// at a time, into global memory for phase 1's TMA, and arrives at the grid
// barrier before phase 1.  (Every block taking every row's factor cost
// four dependent rounds of L2 loads at 128 rows, and a grid barrier
// between the statistic and the norm ~3 us more; normalizing each landed x
// tile in shared memory instead cost phase 1 about half its consumer time
// a stage, PERF.md §6.  Keeping a thread's slot of x in registers for the
// norm saved a load round but cost B5, which shares the kernel, 2-3%.)
template <class C>
__device__ __forceinline__ void norm_rows(const Args& a, unsigned g0, float* rr, float* sl) {
  constexpr int NT = C::NCONS * 32;
  const int tid = threadIdx.x, q = tid & 3;
  const int D = a.ph[1].In, n8 = D / 8, nsl = D / SLOT_COLS, nq = nsl / 4;
  const bool own = a.first == 1;  // the statistic from x, here
  const int rpb = own ? min(NT / 4, SL_FLOATS / nsl) : NT / 4;  // rows a round
  const __nv_bfloat16* src = own ? a.x : a.ph[0].out;
  if (!own) {
    if (tid == 0) grid_wait(a.bar, g0 + 1);
    consumers_sync<C::NCONS>();
  }
  for (int m0 = blockIdx.x; m0 < a.M; m0 += gridDim.x * rpb) {
    const int rows = min(rpb, (a.M - m0 + (int)gridDim.x - 1) / (int)gridDim.x);
    if (own) {
      for (int v = tid; v < rows * nsl; v += NT) {
        const int r = v / nsl, j = v - r * nsl;
        const uint4* x8 = reinterpret_cast<const uint4*>(
            src + (size_t)(m0 + gridDim.x * r) * D + j * SLOT_COLS);
        uint4 xv[SLOT_COLS / 8];
#pragma unroll
        for (int i = 0; i < SLOT_COLS / 8; ++i) xv[i] = __ldg(x8 + i);
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < SLOT_COLS / 8; ++i) ss = sum_sq8(ss, xv[i]);
        sl[v] = ss;
      }
      consumers_sync<C::NCONS>();
    }
    const int r4 = tid >> 2, m = m0 + gridDim.x * r4;
    const bool live = r4 < rows;
    const float4* sp = reinterpret_cast<const float4*>(
        own ? sl + r4 * nsl : a.slots + (size_t)m * nsl);
    float tot = 0.f;
    for (int j0 = q; j0 < nq; j0 += 32) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = !live || j0 + 4 * i >= nq ? make_float4(0.f, 0.f, 0.f, 0.f)
               : own                     ? sp[j0 + 4 * i]
                                         : __ldcg(sp + j0 + 4 * i);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        tot += v[i].x;
        tot += v[i].y;
        tot += v[i].z;
        tot += v[i].w;
      }
    }
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    if (q == 0 && live) rr[r4] = 1.f / sqrtf(tot / (float)D + a.eps);
    consumers_sync<C::NCONS>();
    for (int v = tid; v < rows * n8; v += NT) {
      const int r = v / n8, k = (v - r * n8) * 8;
      const size_t at = (size_t)(m0 + gridDim.x * r) * D + k;
      const uint4 xv = __ldcg(reinterpret_cast<const uint4*>(src + at));
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(a.norm_w + k));
      const float f = rr[r];
      uint4 o;
      o.x = norm_pair(xv.x, wv.x, f);
      o.y = norm_pair(xv.y, wv.y, f);
      o.z = norm_pair(xv.z, wv.z, f);
      o.w = norm_pair(xv.w, wv.w, f);
      *reinterpret_cast<uint4*>(a.hn + at) = o;
    }
    consumers_sync<C::NCONS>();  // rr and sl are the next round's
  }
  phase_done<C>(a, 2 - a.first, g0);
}

// ---- split-K through global memory (the wgmma core, the bf16 core) -------------

// The split-K reduction of an item once its group met (tile_meet): rows m0
// .. m0 + rows - 1 of tile t, rank rg of `split` taking every split-th quad
// (a row, columns q4 .. q4 + 3 of each box), the ranks' partials (part
// [rank][M][Out], f32, in L2) added in split order, then the epilogue
// (int8: the column scales) by `nt` consumer threads.
template <bool BF16>
__device__ __forceinline__ void reduce_item(const Args& a, const Phase& ph, int t, int m0,
                                            int rows, int rg, int split, int tid, int nt) {
  const int c0 = ph.gate ? t * HALF : t * BN;
  const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;
  for (int u = rg + split * tid; u < rows * (HALF / 4); u += split * nt) {
    const int m = m0 + u / (HALF / 4), q4 = 4 * (u % (HALF / 4));
    float4 v[2];
    for (int r = 0; r < split; ++r)
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(
            a.part + ((size_t)r * a.M + m) * ph.Out + (box ? c1 : c0) + q4));
        if (r == 0) {
          v[box] = q;
        } else {
          v[box].x += q.x, v[box].y += q.y, v[box].z += q.z, v[box].w += q.w;
        }
      }
    float x0[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
    float x1[4] = {v[1].x, v[1].y, v[1].z, v[1].w};
    if (!BF16) {
      scale4<false>(x0, __ldg(reinterpret_cast<const float4*>(ph.scale + c0 + q4)));
      scale4<false>(x1, __ldg(reinterpret_cast<const float4*>(ph.scale + c1 + q4)));
    }
    if (ph.gate) {
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] = gate<BF16>(bf16_round(x0[k]), bf16_round(x1[k]));
      *reinterpret_cast<uint2*>(ph.out + (size_t)m * (ph.Out / 2) + t * HALF + q4) =
          pack_bf16x4(y);
      continue;
    }
#pragma unroll
    for (int box = 0; box < 2; ++box) {
      const int n = (box ? c1 : c0) + q4;
      const float* xb = box ? x1 : x0;
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] = bf16_round(xb[k]);
      if (ph.res != nullptr) {
        const uint2 rv = __ldcg(reinterpret_cast<const uint2*>(ph.res + (size_t)m * ph.Out + n));
        const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.x));
        const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv.y));
        y[0] += r01.x;
        y[1] += r01.y;
        y[2] += r23.x;
        y[3] += r23.y;
      }
      *reinterpret_cast<uint2*>(ph.out + (size_t)m * ph.Out + n) = pack_bf16x4(y);
    }
  }
}

// The mma.sync core's partial of an item (a warp's fragment groups, rows m0
// + 16 mt + g + 8 h, the columns of Lane) into part [rg] for reduce_item.
template <bool BF16, int MT>
__device__ __forceinline__ void store_partial(const Args& a, const Phase& ph, int rg, int t,
                                              int m0, int warp, int lane,
                                              const float (&acc)[MT][4][4]) {
  const int c0 = ph.gate ? t * HALF : t * BN;
  const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;
  const int cw = Lane<BF16>::col(warp, lane);
  float* part = a.part + (size_t)rg * a.M * ph.Out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + (lane >> 2) + 8 * h;
      if (m >= a.M) continue;
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        float* row = part + (size_t)m * ph.Out + (box ? c1 : c0) + cw;
        *reinterpret_cast<float2*>(row) =
            make_float2(Lane<BF16>::v(acc[mt], box, h, 0), Lane<BF16>::v(acc[mt], box, h, 1));
        *reinterpret_cast<float2*>(row + Lane<BF16>::D) =
            make_float2(Lane<BF16>::v(acc[mt], box, h, 2), Lane<BF16>::v(acc[mt], box, h, 3));
      }
    }
}

// ---- the mma.sync core --------------------------------------------------------

// The B fragments of k-step kk of a stage's two weight boxes (at wst, W
// bytes apart) for consumer warp `warp`: bf[nb] for nb 0/1 of box 0, 2/3 of
// box 1 (their columns: Lane).  int8: ldmatrix.trans of box 0 rows 0-7, box
// 0 rows 8-15, box 1 rows 0-7, box 1 rows 8-15 of this warp's 16-byte chunk
// (64-byte swizzle: chunk ^ (row / 2 % 4)), converted by i8_pairs into the
// even and the odd columns.  bf16: one ldmatrix.trans a box, rows 0-7 and
// 8-15 of chunks 2 warp and 2 warp + 1 (128-byte swizzle: chunk ^ (row %
// 8)), already mma B fragments.
template <bool BF16, int W>
__device__ __forceinline__ void b_fragments(uint32_t wst, int kk, int warp, int lane,
                                            uint32_t (&bf)[4][2]) {
  const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  if (BF16) {
    const int ch = 2 * warp + (lane >> 4);
    const uint32_t off = row * 2 * HALF + ((ch ^ (row & 7)) << 4);
    uint32_t w0[4], w1[4];
    ldsm_x4_trans_u32(w0, wst + off);
    ldsm_x4_trans_u32(w1, wst + W + off);
    bf[0][0] = w0[0], bf[0][1] = w0[1], bf[1][0] = w0[2], bf[1][1] = w0[3];
    bf[2][0] = w1[0], bf[2][1] = w1[1], bf[3][0] = w1[2], bf[3][1] = w1[3];
  } else {
    uint32_t wr[4];
    ldsm_x4_trans_u32(wr, wst + (lane >> 4) * W + row * HALF + ((warp ^ ((row >> 1) & 3)) << 4));
    i8_pairs(wr[0], bf[0][0], bf[1][0]);
    i8_pairs(wr[1], bf[0][1], bf[1][1]);
    i8_pairs(wr[2], bf[2][0], bf[3][0]);
    i8_pairs(wr[3], bf[2][1], bf[3][1]);
  }
}

// The body of the mma.sync core's kernels (ffn_sm90_kernel: int8 weights,
// ffn_bf16_sm90_kernel: bf16): grid (8 clusters), cluster (8, 1, 1) (bf16:
// runs of 8 blocks, no cluster), Cfg<MT, BF16>::THREADS threads: warps
// 0..NCW-1 consume, warp NCW produces.
template <int MT, bool BF16>
__device__ __forceinline__ void mma_core(const Args& a, uint8_t* smem_raw, unsigned* gen0) {
  using C = Cfg<MT, BF16>;
  constexpr int S = C::STAGES;
  constexpr int KU = MT <= 2 ? BK / 16 : 2;  // k-steps unrolled (registers at MT >= 4)
  // red: the partials' pushes; free: the owners of a group, CLUSTER / split each
  const Block b = block_setup<C>(a, smem_raw, gen0, 1, CLUSTER);
  uint8_t* smem = b.smem;
  const uint32_t sbase = b.sbase, bars = b.bars;
  const uint32_t red_bar = b.extra, free_bar = b.extra + 8;
  float* rr = reinterpret_cast<float*>(smem + C::RR);
  float* sl = reinterpret_cast<float*>(smem + C::SL);
  const unsigned g0 = *gen0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = C::CLUSTERED ? cluster_rank() : blockIdx.x % CLUSTER;

  if (warp == NCW) {
    produce<C>(a, b, rank, g0);
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int tid = threadIdx.x;  // 0 .. NCW * 32 - 1
  if (C::CLUSTERED) cluster_wait();
  // rows past C::R take further passes of each tile (bf16 only: every int8
  // call's M fits one pass)
  const int npass = (a.M + C::R - 1) / C::R;
  int it = 0, red_n = 0, free_n = 0;
  for (int p = a.first; p < 3; ++p) {
    const Phase& ph = a.ph[p];
    const Work w = work_of(ph, rank);
    const int split = w.split;
    float* slots = p == 0 ? a.slots : nullptr;
    if (p == 1) norm_rows<C>(a, g0, rr, sl);
    // the fragment groups u = (warp, row tile) this rank reduces: u = rg,
    // rg + split, ...; each receives every group rank's partial (2 KB)
    const int owned = (NCW * MT - w.rg + split - 1) / split;
    bool first_item = true;
    // the group's items: (tile, row pass), a tile's passes in turn
    for (int item = 0; w.unit + item / npass * w.nunits < ph.ntiles; ++item) {
      const int t = w.unit + item / npass * w.nunits, m0 = item % npass * C::R;
      const bool last = item % npass == npass - 1 && t + w.nunits >= ph.ntiles;
      if (C::CLUSTERED && split > 1 && tid == 0) mbar_expect_tx(red_bar, owned * split * 2048);
      // the first fragment group this warp finishes: its scales and
      // residual load now, so that the finish does not wait on them
      const int u0 = split == 1 ? warp * MT : w.rg + split * warp;
      GroupOperands ops;
      if (u0 < NCW * MT && (split == 1 || C::CLUSTERED))
        load_group<BF16>(ph, a.M, t, m0 + (u0 % MT) * 16, u0 / MT, lane, ops);
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;

      for (int i = 0; i < w.nk; ++i) {
        const int s = it % S;
        const uint32_t par = (it / S) & 1;
        ++it;
        mbar_wait(bars + 8 * s, par);  // the stage's boxes have landed
        const uint32_t wst = sbase + s * C::STAGE;
        const uint32_t xst = wst + 2 * C::W_BYTES;
#pragma unroll KU
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t bf[4][2];
          b_fragments<BF16, C::W_BYTES>(wst, kk, warp, lane, bf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
            const int row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int ch = kk * 2 + (lane >> 4);
            ldsm_x4_u32(af, xst + row * 128 + ((ch ^ (row & 7)) << 4));
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
              mma_bf16_16816(acc[mt][nb], af, bf[nb][0], bf[nb][1]);
          }
        }
        mbar_arrive(bars + 8 * (S + s));
      }

      if (split == 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt > 0 && ph.res != nullptr)
            load_group<BF16>(ph, a.M, t, m0 + mt * 16, warp, lane, ops);
          finish_group<BF16>(ph, a.M, t, m0 + mt * 16, warp, lane, acc[mt], ops, slots);
        }
      } else if (!C::CLUSTERED) {
        // this rank's partial of the item into L2, the group's ranks meet on
        // the item's tile words, then each reduces every split-th quad
        store_partial<BF16>(a, ph, w.rg, t, m0, warp, lane, acc);
        __threadfence();
        consumers_sync<NCW>();
        if (tid == 0) tile_meet(a.bar + 2 + 2 * (t * npass + item % npass), split);
        consumers_sync<NCW>();
        reduce_item<BF16>(a, ph, t, m0, min(C::R, a.M - m0), w.rg, split, tid, NCW * 32);
      } else {
        // fragment group u is reduced and finished by group rank u % split
        // (its warp u / split % NCW): each rank stores its partial of
        // group u into slot [rg] of the owner's receive area, completing on
        // the owner's red barrier, and the owner adds the slots in split
        // order.  After the group's first item, the owners must have freed
        // their slots of the item before.
        if (!first_item) mbar_wait_cluster(free_bar, free_n++ & 1);
        const float4* P = reinterpret_cast<const float4*>(smem + C::RECV);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int u = warp * MT + mt;
          const uint32_t owner = (uint32_t)(w.base + u % split);
          const uint32_t dst = rank_addr(smem_u32(smem + C::RECV), owner);
          const uint32_t bar = rank_addr(red_bar, owner);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
            st_async_f32x4(dst + (((u / split) * split + w.rg) * 4 + nb) * 512 + lane * 16,
                           acc[mt][nb], bar);
        }
        mbar_wait(red_bar, red_n++ & 1);  // every group rank's partials of this rank's groups
        for (int u = w.rg + split * warp; u < NCW * MT; u += split * NCW) {
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
          const int row0 = m0 + (u % MT) * 16;
          if (u != u0) load_group<BF16>(ph, a.M, t, row0, u / MT, lane, ops);
          finish_group<BF16>(ph, a.M, t, row0, u / MT, lane, v, ops, slots);
        }
        if (!last) {
          // this rank's slots are read: free them in every rank of the group
          consumers_sync<NCW>();
          if (tid == 0)
            for (int r = 0; r < split; ++r)
              mbar_arrive_remote(rank_addr(free_bar, (uint32_t)(w.base + r)),
                                 CLUSTER / split);
        }
      }
      first_item = false;
    }
    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);  // after phase 0 and 1
  }
}

template <int MT>
__global__ void __launch_bounds__(Cfg<MT>::THREADS, Cfg<MT>::BLOCKS_SM)
    ffn_sm90_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ unsigned gen0;
  mma_core<MT, false>(a, smem_raw, &gen0);
}

// dense_mlp: the same core on bf16 weights; every M, rows past 128 in passes
template <int MT>
__global__ void __launch_bounds__(Cfg<MT, true>::THREADS, Cfg<MT, true>::BLOCKS_SM)
    ffn_bf16_sm90_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ unsigned gen0;
  mma_core<MT, true>(a, smem_raw, &gen0);
}

// ---- the wgmma core -------------------------------------------------------------
//
// B9 at 129..256 rows, where an int8 weight byte feeds up to 512 flops,
// above the H100's ~295 flop/byte: the tensor cores set the time, and the
// mma.sync core, 128 rows a pass, would read each weight tile twice.  Here
// every row rides one pass of the transposed product out^T = q^T x^T on
// wgmma m64n256k16 (as B6-int4's qmm4_sm90_kernel): the weight is the A
// operand, from registers, and the x tile (256 rows, rows past M zero) the
// K-major B operand in shared memory, the ring's own 128-byte-swizzled box.
// - A fragments straight from the weight tile: each warp's ldmatrix.trans
//   of its 16-byte chunk gives the k-pairs of columns 2g and 2g + 1 of both
//   boxes (see i8_pair); warpgroup 0 takes the even columns and warpgroup 1
//   the odd ones, so A row 16 w + g of warpgroup e is column 16 w + 2 g + e
//   of box 0 and row 16 w + g + 8 the same column of box 1.  With the gate,
//   box 0 holds the gate columns and box 1 the matching up columns, so one
//   thread holds g and u of the same (row, column) and gates in registers.
// - Split-K through global memory: a rank's accumulators are 64 KB a
//   warpgroup, more than a receive area beside the ring can hold, so each
//   rank stores its f32 partial of the tile to part [rank][M][Out] (L2), the
//   group's blocks meet on their tile's counter and generation words (the
//   grid barrier's protocol), and each rank reduces every split-th quad of
//   the tile's columns, adding the partials in split order.  Without DSMEM
//   the core needs no cluster, so every SM holds a block (clusters of 8 left
//   12 of the 132 idle, and 8 of w13's 128 tiles a second round).

// D += A B over one k16 step, m64n256k16: A (the weight) from registers, B
// (x) K-major from shared memory (128-byte swizzle).  d[4 j + e]: A row
// 16 warp + g + 8 (e / 2), x row 8 j + 2 t4 + e % 2.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// Keep an A register set unchanged until the wgmmas that read it completed.
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// Grid (8 runs of 8 blocks, no cluster), CfgW::THREADS threads:
// warpgroups 0 and 1 consume (the even and the odd columns of each tile),
// warp 8 produces.  One block an SM.  B9 only (a.first == 1).
__global__ void __launch_bounds__(CfgW::THREADS, 1) ffn_wg_sm90_kernel(const __grid_constant__ Args a) {
  using C = CfgW;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ unsigned gen0;
  const Block b = block_setup<C>(a, smem_raw, &gen0, 1, 1);
  uint8_t* smem = b.smem;
  float* rr = reinterpret_cast<float*>(smem + C::RR);
  float* sl = reinterpret_cast<float*>(smem + C::SL);
  const unsigned g0 = gen0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = blockIdx.x % CLUSTER;

  if (warp == C::NCONS) {
    produce<C>(a, b, rank, g0);
    return;
  }

  // ---- consumers ------------------------------------------------------------
  const int tid = threadIdx.x;  // 0 .. 255
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = 16 * wi + 2 * g + wg;  // this thread's column of each 64-column box
  int it = 0;
  for (int p = 1; p < 3; ++p) {
    const Phase& ph = a.ph[p];
    const Work w = work_of(ph, rank);
    const int split = w.split;
    if (p == 1) norm_rows<C>(a, g0, rr, sl);
    for (int t = w.unit; t < ph.ntiles; t += w.nunits) {
      float acc[128];
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] = 0.f;
      uint32_t af[2][4];  // A register sets: one k16 step converts while the last runs
      for (int i = 0; i < w.nk; ++i) {
        const int s = it % S;
        const uint32_t par = (it / S) & 1;
        ++it;
        mbar_wait(b.bars + 8 * s, par);  // the stage's boxes have landed
        const uint32_t wst = b.sbase + s * C::STAGE;
        const uint32_t xst = wst + 2 * C::W_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t wr[4];
          {
            const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldsm_x4_trans_u32(wr, wst + (lane >> 4) * C::W_BYTES + row * HALF +
                                      ((wi ^ ((row >> 1) & 3)) << 4));
          }
          // rows g (box 0) and g + 8 (box 1), k-pairs 2 t4 and 2 t4 + 8; the
          // odd columns are bytes 1 and 3
          uint32_t (&A)[4] = af[kk & 1];
          A[0] = i8_pair(wr[0] >> (8 * wg));
          A[1] = i8_pair(wr[2] >> (8 * wg));
          A[2] = i8_pair(wr[1] >> (8 * wg));
          A[3] = i8_pair(wr[3] >> (8 * wg));
          wgmma_fence();
          wgmma_n256(acc, A, smem_desc(xst, 16, 1024) + 2 * kk);
          wgmma_commit();
          if (kk + 1 < BK / 16) {
            wgmma_wait<1>();  // the other A set is free again
            fence_a(af[(kk + 1) & 1]);
          } else {
            wgmma_wait<0>();  // the stage's x read before it is released
            fence_a(af[0]);
            fence_a(af[1]);
          }
        }
        mbar_arrive(b.bars + 8 * (S + s));
      }
      fence_regs(acc);
      const int c0 = ph.gate ? t * HALF : t * BN;
      const int c1 = ph.gate ? ph.Out / 2 + t * HALF : t * BN + HALF;
      if (split == 1) {
        const float s0 = __ldg(ph.scale + c0 + c), s1 = __ldg(ph.scale + c1 + c);
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * j + 2 * t4 + e;
            if (m >= a.M) continue;
            const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
            if (ph.gate) {
              const float gv = bf16_round(v0 * s0), uv = bf16_round(v1 * s1);
              ph.out[(size_t)m * (ph.Out / 2) + t * HALF + c] =
                  __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);
              continue;
            }
            float y0 = bf16_round(v0 * s0), y1 = bf16_round(v1 * s1);
            if (ph.res != nullptr) {
              y0 += __bfloat162float(ph.res[(size_t)m * ph.Out + c0 + c]);
              y1 += __bfloat162float(ph.res[(size_t)m * ph.Out + c1 + c]);
            }
            ph.out[(size_t)m * ph.Out + c0 + c] = __float2bfloat16(y0);
            ph.out[(size_t)m * ph.Out + c1 + c] = __float2bfloat16(y1);
          }
        continue;
      }
      // this rank's partial of the tile, then the group's ranks meet
      float* part = a.part + (size_t)w.rg * a.M * ph.Out;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + 2 * t4 + e;
          if (m >= a.M) continue;
          part[(size_t)m * ph.Out + c0 + c] = acc[4 * j + e];
          part[(size_t)m * ph.Out + c1 + c] = acc[4 * j + 2 + e];
        }
      __threadfence();
      consumers_sync<C::NCONS>();
      if (tid == 0) tile_meet(a.bar + 2 + 2 * t, split);
      consumers_sync<C::NCONS>();
      reduce_item<false>(a, ph, t, 0, a.M, w.rg, split, tid, C::NCONS * 32);
    }
    if (p < 2) phase_done<C>(a, 2 * p + 1 - a.first, g0);  // after phase 1
  }
}

// ---- host side ----------------------------------------------------------------

// An int8 weight's map over its [rows, cols] bytes, encoded once per
// (pointer, shape).  (A bf16 weight's: sm90_common.cuh bf16_weight_map, the
// same box.)
CUresult weight_map(CUtensorMap* map, const void* q, int rows, int cols) {
  return cached_map(map, std::make_tuple(q, rows, cols), [&](CUtensorMap* m) {
    return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 1, cols, rows, HALF, BK,
                     CU_TENSOR_MAP_SWIZZLE_64B);
  });
}

// Phase p's dot: its weight's map (int8, or bf16 with no scale) and its
// plan.  split: 1, 2, 4 or 8, no split empty.
int set_phase(Args& a, int p, const void* q, const void* scale, const void* res, void* out,
              int In, int Out, int gate, int split, bool bf16 = false) {
  if (In % BK != 0 || Out % BN != 0 || (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  const int tiles = In / BK;
  const int per = (tiles + split - 1) / split;
  if ((tiles + per - 1) / per != split) return (int)cudaErrorInvalidValue;  // an empty split
  const CUresult enc =
      bf16 ? bf16_weight_map(&a.wmap[p], q, In, Out) : weight_map(&a.wmap[p], q, In, Out);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  Phase& ph = a.ph[p];
  ph.scale = static_cast<const float*>(scale);
  ph.res = static_cast<const __nv_bfloat16*>(res);
  ph.out = static_cast<__nv_bfloat16*>(out);
  ph.In = In;
  ph.Out = Out;
  ph.split = split;
  ph.kchunk = per * BK;
  ph.ntiles = Out / BN;  // with the gate: 64 gate and 64 up columns a tile
  ph.gate = gate;
  return 0;
}

// `clusters` runs of 8 blocks, a thread-block cluster each if C::CLUSTERED.
template <class C>
cudaLaunchConfig_t launch_config(int clusters, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CLUSTER, 1, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::CLUSTERED ? 1 : 0;
  return cfg;
}

using Kernel = void (*)(Args);

// The runs of 8 blocks of a core (its config C, its kernel) the card holds
// at once (clusters, or blocks / 8), read once a core, or a negative
// cudaError.
template <class C>
int resident_clusters(Kernel kernel) {
  static const int n = [kernel] {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return -(int)attr;
    int count = 0;
    cudaError_t err;
    if (C::CLUSTERED) {
      cudaLaunchAttribute cl[1];
      const cudaLaunchConfig_t cfg = launch_config<C>(16, nullptr, cl);
      err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    } else {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::THREADS, C::SMEM);
      count = sms * per_sm / CLUSTER;
    }
    return err != cudaSuccess ? -(int)err : count;
  }();
  return n;
}

// The x operands' maps (a, h or x, gated: the input of each phase from
// `first` on), then one launch of `clusters` resident clusters.
template <class C>
int launch(Kernel kernel, Args& a, const void* const xs[3], int clusters, cudaStream_t st) {
  const int resident = resident_clusters<C>(kernel);
  if (resident < 0) return -resident;
  // a grid barrier over blocks that cannot all be resident would not open
  if (clusters < 1 || clusters > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int p = a.first; p < 3; ++p) {
    const CUresult enc = encode_2d(&a.xmap[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xs[p], 2,
                                   a.ph[p].In, a.M, BK, C::R, CU_TENSOR_MAP_SWIZZLE_128B);
    if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  }
  cudaLaunchAttribute cl[1];
  const cudaLaunchConfig_t cfg = launch_config<C>(clusters, st, cl);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The core that serves M rows of a format: int8, Cfg<MT>::R >= M on the
// mma.sync core and the wgmma core above 128 rows; bf16, the mma.sync core
// at every M (passes of 128 rows above 128).
template <bool BF16, class F>
int with_core(int M, F f) {
  if (BF16) {
    if (M <= 16) return f(Cfg<1, true>(), ffn_bf16_sm90_kernel<1>);
    if (M <= 32) return f(Cfg<2, true>(), ffn_bf16_sm90_kernel<2>);
    if (M <= 64) return f(Cfg<4, true>(), ffn_bf16_sm90_kernel<4>);
    return f(Cfg<8, true>(), ffn_bf16_sm90_kernel<8>);
  }
  if (M <= 16) return f(Cfg<1>(), ffn_sm90_kernel<1>);
  if (M <= 32) return f(Cfg<2>(), ffn_sm90_kernel<2>);
  if (M <= 64) return f(Cfg<4>(), ffn_sm90_kernel<4>);
  if (M <= 128) return f(Cfg<8>(), ffn_sm90_kernel<8>);
  return f(CfgW(), ffn_wg_sm90_kernel);
}

template <bool BF16>
int run(Args& a, const void* const xs[3], int clusters, cudaStream_t st) {
  return with_core<BF16>(a.M, [&](auto c, Kernel kernel) {
    return launch<decltype(c)>(kernel, a, xs, clusters, st);
  });
}

// D: a row's slots in the norm's shared memory (16384).
bool shapes_ok(int M, int D, int F, int max_rows = MAX_ROWS) {
  return M >= 1 && M <= max_rows && D % BN == 0 && D <= SLOT_COLS * SL_FLOATS &&
         F % HALF == 0;
}

}  // namespace
}  // namespace ffn90
}  // namespace md

using bf16 = __nv_bfloat16;

// The clusters (or, bf16 and the int8 wgmma core, runs) of 8 blocks the
// card holds at once for the core that serves M rows of int8 (bf16 = 0) or
// bf16 (bf16 = 1) weights (the grid's cap), or a negative cudaError.
extern "C" int md_ffn_sm90_resident(int M, int bf16) {
  using namespace md::ffn90;
  const auto count = [](auto c, Kernel kernel) { return resident_clusters<decltype(c)>(kernel); };
  return bf16 ? with_core<true>(M, count) : with_core<false>(M, count);
}

// B5: a draft layer's tail in one launch.  a [M, K] attention output, x
// [M, D] the layer's input; qo [K, D] / so [D], q13 [D, 2F] / s13 [2F], q2
// [F, D] / s2 [D] int8 with f32 scales, norm_w [D]; scratch h, hn [M, D],
// gated [M, F] bf16 and slots [M, D / 32] f32; bar: the device's barrier
// words (2 + 2 TILE_BARS zeroed words, kept across calls); out [M, D].  split_*: each
// dot's splits (1, 2, 4 or 8, none empty; the wrapper's ffn_split_plan);
// clusters: the grid, at most md_ffn_sm90_resident(M, 0); flags bit 0: issue
// the next phase's weights before the grid barrier opens.  Returns
// cudaGetLastError(), cudaErrorCooperativeLaunchTooLarge for a grid the
// card cannot hold at once, or 0x10000 + the CUresult of a failed
// tensor-map encode.
extern "C" int md_quant_layer_tail_sm90(const void* a, const void* x, const void* qo,
                                        const void* so, const void* q13, const void* s13,
                                        const void* q2, const void* s2, const void* norm_w,
                                        void* out, void* h, void* hn, void* gated, void* slots,
                                        void* bar,
                                        int M, int K, int D, int F, int split_o, int split_13,
                                        int split_2, int clusters, int flags, float eps,
                                        void* stream) {
  using namespace md::ffn90;
  if (!shapes_ok(M, D, F) || M > 128) return (int)cudaErrorInvalidValue;
  Args args;
  int err = set_phase(args, 0, qo, so, x, h, K, D, 0, split_o);
  if (err == 0) err = set_phase(args, 1, q13, s13, nullptr, gated, D, 2 * F, 1, split_13);
  if (err == 0) err = set_phase(args, 2, q2, s2, h, out, F, D, 0, split_2);
  if (err != 0) return err;
  args.x = nullptr;
  args.norm_w = static_cast<const bf16*>(norm_w);
  args.hn = static_cast<bf16*>(hn);
  args.slots = static_cast<float*>(slots);
  args.part = nullptr;
  args.bar = static_cast<unsigned*>(bar);
  args.M = M;
  args.first = 0;
  args.prefetch = flags & 1;
  args.eps = eps;
  const void* const xs[3] = {a, hn, gated};
  return run<false>(args, xs, clusters, static_cast<cudaStream_t>(stream));
}

// B9: out = [res +] bf16(gate(rms(x) * norm_w @ q13 * s13) @ q2 * s2) in one
// launch.  x [M, D]; q13 [D, 2F] / s13 [2F], q2 [F, D] / s2 [D], norm_w [D];
// res [M, D] or null; scratch hn [M, D], gated [M, F] bf16 and, above 128
// rows with a split dot, part f32 [split, M, Out] of the largest such dot;
// bar, splits, clusters (above 128 rows: runs of 8 blocks), flags and the
// return as md_quant_layer_tail_sm90.
extern "C" int md_quant_mlp_sm90(const void* x, const void* q13, const void* s13,
                                 const void* q2, const void* s2, const void* norm_w,
                                 const void* res, void* out, void* hn, void* gated, void* part,
                                 void* bar,
                                 int M, int D, int F, int split_13, int split_2, int clusters,
                                 int flags, float eps, void* stream) {
  using namespace md::ffn90;
  if (!shapes_ok(M, D, F)) return (int)cudaErrorInvalidValue;
  // the wgmma core's split dots: partials, and a tile barrier each tile
  if (M > 128 && ((split_13 > 1 && (part == nullptr || 2 * F / BN > TILE_BARS)) ||
                  (split_2 > 1 && (part == nullptr || D / BN > TILE_BARS))))
    return (int)cudaErrorInvalidValue;
  Args args;
  int err = set_phase(args, 1, q13, s13, nullptr, gated, D, 2 * F, 1, split_13);
  if (err == 0) err = set_phase(args, 2, q2, s2, res, out, F, D, 0, split_2);
  if (err != 0) return err;
  args.x = static_cast<const bf16*>(x);
  args.norm_w = static_cast<const bf16*>(norm_w);
  args.hn = static_cast<bf16*>(hn);
  args.slots = nullptr;
  args.part = static_cast<float*>(part);
  args.bar = static_cast<unsigned*>(bar);
  args.M = M;
  args.first = 1;
  args.prefetch = flags & 1;
  args.eps = eps;
  const void* const xs[3] = {nullptr, hn, gated};
  return run<false>(args, xs, clusters, static_cast<cudaStream_t>(stream));
}

// B15 dense_mlp: out = [res +] bf16(gate(rms(x) * norm_w @ w13) @ w2) in one
// launch, B9's phases on bf16 weights.  x [M, D], w13 [D, 2F] (gate
// columns, then up), w2 [F, D], norm_w [D], res [M, D] or null, bf16;
// scratch hn [M, D], gated [M, F] bf16 and, with a split dot, part f32
// [split, M, Out] of the largest such dot; bar: the
// device's barrier words (shared with B5 and B9); M <= 512.  split_13,
// split_2: each dot's splits (1, 2, 4 or 8, none empty; the wrapper's
// dense_mlp_plan, fixed by the shapes and the card); clusters: the grid in
// runs of 8 blocks, at most md_ffn_sm90_resident(M, 1); flags and the
// return as md_quant_layer_tail_sm90.
extern "C" int md_dense_mlp_sm90(const void* x, const void* w13, const void* w2,
                                 const void* norm_w, const void* res, void* out, void* hn,
                                 void* gated, void* part, void* bar, int M, int D, int F,
                                 int split_13, int split_2, int clusters, int flags, float eps,
                                 void* stream) {
  using namespace md::ffn90;
  if (!shapes_ok(M, D, F, DENSE_ROWS)) return (int)cudaErrorInvalidValue;
  // split dots: partials, and a tile barrier each (tile, 128-row pass)
  const int npass = (M + 127) / 128;
  if ((split_13 > 1 && (part == nullptr || 2 * F / BN * npass > TILE_BARS)) ||
      (split_2 > 1 && (part == nullptr || D / BN * npass > TILE_BARS)))
    return (int)cudaErrorInvalidValue;
  Args args;
  int err = set_phase(args, 1, w13, nullptr, nullptr, gated, D, 2 * F, 1, split_13, true);
  if (err == 0) err = set_phase(args, 2, w2, nullptr, res, out, F, D, 0, split_2, true);
  if (err != 0) return err;
  args.x = static_cast<const bf16*>(x);
  args.norm_w = static_cast<const bf16*>(norm_w);
  args.hn = static_cast<bf16*>(hn);
  args.slots = nullptr;
  args.part = static_cast<float*>(part);
  args.bar = static_cast<unsigned*>(bar);
  args.M = M;
  args.first = 1;
  args.prefetch = flags & 1;
  args.eps = eps;
  const void* const xs[3] = {nullptr, hn, gated};
  return run<true>(args, xs, clusters, static_cast<cudaStream_t>(stream));
}

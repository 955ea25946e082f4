// B4, B6 and B4-int4 at 65 to 256 rows on Hopper: the quantized target's
// dots at its decode_rows (B * (gamma + 1) = 128 at the bench's B=32), one
// launch a call.  The draft's rows (M <= 64) keep the cluster core of
// quant_matmul_sm90.cu; kernels/quant_matmul.py routes by M alone.
//
// Replaces, at these rows, magicdec_tpu/ops/pallas/quant_matmul.py
// quant_matmul_fused_pallas (_fused_kernel: its int8 branch, one scale a
// column or group-wise, and its nibble branch with bits=4) and the int8
// quant_matmul_pallas (_int8_kernel).  They compute
//   y = epilogue(norm?(x)[M, In] @ q[In, Out] * scale)
// with bf16 x and f32 sums: int8 q with one f32 scale a column, the sum
// scaled once; or group-wise (int8 q, or int4 q packed in contraction-row
// pairs [In / 2, Out]) with one f32 scale a group of `group` contraction rows
// and column, each group's products summed in a fresh f32 partial and added
// as acc += part * s_g in group order.  The epilogue is bf16(acc) [+ res in
// bf16], or bf16(g * sigmoid(g) * u) over the bf16-rounded gate and up
// halves of q; the norm (int8 only) is bf16(bf16(x * rsqrt(mean(x^2) + eps))
// * norm_w).
//
// Bound: at M = 128 an int8 weight byte feeds 256 flops, at the tensor
// cores' ridge (~295 flop/byte at 3.35 TB/s and 989 TFLOP/s), and an int4
// byte 512, past it.  So the products must run at the tensor cores' rate
// while the weight streams at HBM rate: mma.sync on four warps (the cluster
// core) cannot, wgmma on two warpgroups can.
//
// - The transposed product.  out^T [Out, M] = q^T [Out, In] x^T [In, M]: a
//   weight tile is wgmma's m64 A operand, converted in registers, and x^T its
//   B operand, a K-major [128 rows, 64 k] tile in shared memory under the
//   128-byte swizzle (wgmma.m64n128k16: one pass covers 128 rows, a second
//   pass the rows past 128; rows past M arrive as zeros).
// - A block owns a tile of 128 weight columns, two 64-column boxes (with the
//   gate: 64 gate columns and their 64 up columns, so the gate finishes in
//   the block), and one split of the contraction.  Warpgroup w owns one A
//   tile: its row g (of each warp's 16) holds box 0's column 16 warp + 2 g +
//   w and row g + 8 box 1's same column, so a gate column and its up column
//   land in one thread's accumulators, and one ldmatrix.x4.trans (int8) or
//   four 16-bit loads (int4) a k16 step give both warpgroups' fragments in
//   the weight's own swizzled boxes: int8 bytes by i8_pair, int4 nibbles by
//   i4_pair, exact.  The A registers rotate through two sets, so one k16
//   step converts while the last one's wgmma runs.
// - Group sums in order.  Each group's products accumulate in a fresh f32
//   wgmma accumulator (scale-d 0 at its first k16 step) and are added as acc
//   += part * s_g when it completes (int8 one scale a column: straight into
//   acc, scaled once in the epilogue).
// - Loads by TMA.  One producer warp (one lane) keeps a ring of stages in
//   flight on mbarriers: the two weight boxes (64 byte rows each, 64-byte
//   swizzle), the stage's x tile(s), and by bulk copies the stage's norm
//   weights or group scales of the tile's columns.  The weight's tensor map
//   is encoded once per (pointer, shape) and cached; x's per call.  A failed
//   encode returns an error (the wrapper raises), never a fallback.
// - Split of the contraction where the column tiles do not fill the card.
//   The splits of a tile form a thread-block cluster (1, split, 1), split <=
//   8, fixed by the weight's shape alone (kernels/quant_matmul.py
//   m128_split_plan, over the card's measured cluster residency: clusters
//   stay inside a GPC, so the H100 holds 39 of 3 blocks but 30 of 4 and 22
//   of 5; group-wise splits start on group boundaries).  A
//   warpgroup's accumulators are 16 units of 4 registers (x rows 8 j ..
//   8 j + 7); unit u of the block's 32 belongs to rank u % split, and every
//   rank stores its f32 partial of each unit into a slot of the owner's
//   receive area by st.async, completing on the owner's mbarrier; the owner
//   adds the slots in split order (no atomics: the same bits on every run)
//   and finishes the unit.  A cluster barrier split in its arrive (after a
//   rank has read its slots) and its wait (before the next item's stores)
//   guards the slots' reuse, so the producer runs ahead into the next item.
// - The norm's row statistic: each rank sums the squares of its own
//   contraction range of every row and stores the partial sums into every
//   rank (row_norm_factors); every rank adds them in rank order, so every
//   block of a row holds the same statistic bit for bit.  Each x stage is
//   normalized in shared memory as it lands (the 256 consumer threads a
//   share each, the stage's 64 norm weights brought by the same mbarrier),
//   then an async-proxy fence and a named barrier before the wgmmas read it.
// - Persistence.  Clusters walk the column tiles (tile c, c + G, ...), G the
//   clusters the card holds at once, so the next tile's loads overlap this
//   tile's reduction and epilogue; rows past 128 run as a second pass over
//   each tile in the same launch.  With one split a thread's sums go through
//   the (then unused) receive area to a compact finish loop: the unrolled
//   finish over registers ran two to four times longer.
// - What holds it back (PERF.md): each block re-reads the x tile from
//   L2 for every column tile (16 KB for 8 KB of int8 weight), the norm's
//   statistic reads all of x in every block of a split-1 dot, and a group's
//   end drains the warpgroup's wgmmas; sharing the x stages across a
//   cluster of column tiles by TMA multicast ran 3.4 times slower.
#include <tuple>

#include "sm90_common.cuh"

namespace md {
namespace qmt {

using namespace md::sm90;

constexpr int N = 128;               // x rows a pass: the wgmma's N
constexpr int HALF = 64;             // weight columns a box
constexpr int TILE = 2 * HALF;       // weight columns a tile
constexpr int NWG = 2;               // consumer warpgroups, one m64 A tile each
constexpr int NCW = 4 * NWG;         // consumer warps
constexpr int NTHREADS = 32 * NCW + 32;  // + one producer warp
constexpr int WROWS = 64;            // weight byte rows a box (int4: packed rows)
constexpr int MAX_ROWS = 256;        // the routing's ROWS_CAP (quantization.py)
constexpr int MAX_SPLIT = 8;         // the portable cluster size
constexpr int UNITS = NWG * N / 8;   // a block's reduction units: (warpgroup, 8 x rows)
constexpr int UNIT_BYTES = 128 * 16;  // a unit's partial: 4 f32 a consumer thread
constexpr int NSETS = 2;             // A register sets: k16 steps in flight

enum Fmt { kI8 = 0, kI8G = 1, kI4 = 2 };  // int8 a scale a column, int8 group-wise, int4

template <int FMT>
struct Cfg {
  static constexpr bool INT4 = FMT == kI4;
  static constexpr bool GRP = FMT != kI8;
  static constexpr int KS = INT4 ? 2 * WROWS : WROWS;  // contraction rows a stage
  static constexpr int W_BYTES = WROWS * HALF;          // one weight box, 4 KB
  static constexpr int X_BYTES = N * KS * 2;            // KS / 64 x sub-tiles of 16 KB
  static constexpr int STAGE = 2 * W_BYTES + X_BYTES;
  static constexpr int STAGES = INT4 ? 3 : 5;
  static constexpr int RING = STAGES * STAGE;
  // the receive area: at most ceil(UNITS / split) owned units, a slot each
  // for every rank's partial (the most over split = 2..8 is split 6: 72 KB);
  // with one split, each thread's sums staged for the finish (64 KB)
  static constexpr int RECV = RING;
  static constexpr int RECV_BYTES = 36 * UNIT_BYTES;
  // full[STAGES], empty[STAGES], stat (the statistic's pushes), red (the
  // partials' pushes)
  static constexpr int BARS = RECV + RECV_BYTES;
  // int8: the statistic's partials [MAX_SPLIT][MAX_ROWS] f32, the rows'
  // factors and each stage's 64 norm weights; group-wise: each stage's
  // scale rows, [rows][2 boxes][HALF] f32 (int4 at most 4 a stage, int8 2)
  static constexpr int SSQ = BARS + 16 * STAGES + 16;
  static constexpr int RR = SSQ + (INT4 ? 0 : 4 * MAX_SPLIT * MAX_ROWS);
  static constexpr int NW = RR + (INT4 ? 0 : 4 * MAX_ROWS);
  static constexpr int SC = NW + (INT4 ? 0 : STAGES * KS * 2);
  static constexpr int SC_STAGE = (KS / 32) * TILE * 4;
  static constexpr int SMEM = SC + (GRP ? STAGES * SC_STAGE : 0) + 1024;  // + slack to align
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  // the norm (int8): a consumer thread normalizes KS / 16 of a stage's
  // 16-byte x chunks
  static_assert(INT4 || N * 8 == NCW * 32 * (KS / 16), "KS / 16 x chunks a thread a stage");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

struct Args {
  CUtensorMap wmap;             // q [In, Out] int8 (int4: [In / 2, Out]), box {HALF, WROWS}, 64-byte swizzle
  CUtensorMap xmap;             // x [M, In] bf16, box {64, N}, 128-byte swizzle
  const __nv_bfloat16* x;       // [M, In], for the norm's statistic
  const float* scale;           // [Out]; group-wise: [In / group, Out]
  const __nv_bfloat16* norm_w;  // [In] or null
  const __nv_bfloat16* res;     // [M, Out] or null
  __nv_bfloat16* out;           // [M, Out], or [M, Out / 2] with the gate
  int M, In, Out, kchunk, ntiles, gate;
  int group;                    // group-wise: contraction rows a scale group
  float eps;
};

namespace {

// This thread's arrive on the cluster barrier, its shared-memory reads and
// writes ordered before it (release); the wait is sm90_common's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// The consumer warps only (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCW * 32) : "memory");
}

// The two nibbles of byte `sel` of w (selectors 0x4400: byte 0, 0x5511: byte
// 1) -> bf16x2 {low nibble, high nibble} as signed int4 values, exactly: a
// nibble with its bit 3 flipped is v + 8 for v in [-8, 7], 0x4300 | (v + 8)
// reads 136 + v in bf16, and 136 is subtracted.
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, uint32_t sel) {
  const uint32_t v = (__byte_perm(w, w >> 4, sel) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;  // bf16x2 {136, 136}
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// D (+)= A B over one k16 step, m64n128k16: A (the weight) from registers in
// the mma A fragment layout, B (x^T) K-major from shared memory (128-byte
// swizzle).  d[4 j + e]: A row 16 warp + g + 8 (e / 2), x row 8 j + 2 t4 + e % 2.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(accumulate));
}

// Chunk j (0 .. N * 8 - 1, 16 bytes) of a stage's x tile normalized in
// place: chunk (row r, physical chunk pc) holds logical columns 8 (pc ^ (r %
// 8)) .. + 7 under the 128-byte swizzle; nw the stage's norm weights, rr the
// rows' factors, m0 the pass's first row (rows past M stay zeros).
__device__ __forceinline__ void norm_chunk(uint8_t* xs, const uint8_t* nw, const float* rr,
                                           int m0, int M, int j) {
  const int r = j >> 3, pc = j & 7;
  if (m0 + r >= M) return;
  uint4* cp = reinterpret_cast<uint4*>(xs + r * 128 + pc * 16);
  const uint4 wv = *reinterpret_cast<const uint4*>(nw + ((pc ^ (r & 7)) << 4));
  const float f = rr[m0 + r];
  uint4 v = *cp;
  v.x = norm_pair(v.x, wv.x, f);
  v.y = norm_pair(v.y, wv.y, f);
  v.z = norm_pair(v.z, wv.z, f);
  v.w = norm_pair(v.w, wv.w, f);
  *cp = v;
}

// Keep A registers (one set) unchanged until the wgmmas that read them have
// completed: a use after the wait.
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// A unit's residual values r[e] (rows m0 + e % 2, box e / 2's column: c0,
// c1), in the order of its sums; zeros without a residual or past M.
__device__ __forceinline__ void load_res(const Args& a, int m0, int c0, int c1, float (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + (e & 1);
    r[e] = a.res != nullptr && m < a.M
               ? __bfloat162float(a.res[(size_t)m * a.Out + ((e & 2) ? c1 : c0)])
               : 0.f;
  }
}

// The finish of one unit's sums v (d[4 j .. 4 j + 3] of a thread): rows m0,
// m0 + 1 of box 0's column c0 (v[0], v[1]) and box 1's c1 (v[2], v[3]); s0,
// s1 their column scales (1 when the groups were scaled already), r the
// residual (load_res).  Box 0 holds the gate columns and box 1 the up
// columns with the gate (the output column c0), else the tile's first and
// second 64 columns.
__device__ __forceinline__ void finish_unit(const Args& a, int m0, int c0, int c1,
                                            const float (&v)[4], float s0, float s1,
                                            const float (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + e;
    if (m >= a.M) continue;
    if (a.gate) {
      const float gv = bf16_round(v[e] * s0);
      const float uv = bf16_round(v[2 + e] * s1);
      a.out[(size_t)m * (a.Out / 2) + c0] =
          __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);
      continue;
    }
    // bf16(acc), then the residual added in bf16 (none: no add, so a -0 stays -0)
    float y0 = bf16_round(v[e] * s0), y1 = bf16_round(v[2 + e] * s1);
    if (a.res != nullptr) y0 += r[e], y1 += r[2 + e];
    a.out[(size_t)m * a.Out + c0] = __float2bfloat16(y0);
    a.out[(size_t)m * a.Out + c1] = __float2bfloat16(y1);
  }
}

}  // namespace

// Grid (clusters, split), cluster (1, split, 1), NTHREADS threads: warps
// 0..NCW-1 consume (warpgroups 0 and 1), warp NCW produces.  Rank s of a
// cluster covers contraction rows [s * kchunk, min(In, (s + 1) * kchunk)).
// One block an SM.
template <int FMT>
__global__ void __launch_bounds__(NTHREADS, 1) qmm_m128_kernel(const __grid_constant__ Args a) {
  using C = Cfg<FMT>;
  constexpr int S = C::STAGES, KS = C::KS;
  constexpr bool INT4 = C::INT4, GRP = C::GRP;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes of the shared address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  // full[s] at 8 s, empty[s] at 8 (S + s), stat at 16 S, red at 16 S + 8
  const uint32_t bars = sbase + C::BARS;
  const uint32_t stat_bar = bars + 16 * S, red_bar = stat_bar + 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int split = gridDim.y;
  const int k0 = (int)rank * a.kchunk;
  const int k1 = min(a.In, k0 + a.kchunk);
  const int nk = (k1 - k0) / KS;
  const int npass = (a.M + N - 1) / N;
  const int items = (a.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * npass;
  const bool norm = !INT4 && a.norm_w != nullptr;
  // group-wise: the scale rows a stage brings (the groups it spans, or the
  // one it lies in)
  const int ng = GRP ? max(1, KS / a.group) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(bars + 8 * (S + s), NCW * 32);   // every consumer thread
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
    // ---- producer: one lane issues the loads --------------------------------
    if (lane != 0) {
      cluster_wait();
      return;
    }
    prefetch_map(&a.wmap);
    prefetch_map(&a.xmap);
    int s = 0, item = 0;  // the ring's stage, and its phase
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
      const int c0 = a.gate ? t * HALF : t * TILE;
      const int c1 = a.gate ? a.Out / 2 + t * HALF : t * TILE + HALF;
      for (int p = 0; p < npass; ++p, ++item) {
        for (int i = 0; i < nk; ++i, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
          mbar_wait(bars + 8 * (S + s), ph ^ 1);  // the consumers released it
          const uint32_t full = bars + 8 * s;
          const uint32_t st = sbase + s * C::STAGE;
          const int kt = k0 + i * KS;
          mbar_expect_tx(full, 2 * C::W_BYTES + C::X_BYTES + (norm ? KS * 2 : 0) +
                                   (GRP ? ng * TILE * 4 : 0));
          if (norm) bulk_load(sbase + C::NW + s * KS * 2, a.norm_w + kt, KS * 2, full);
          const int kq = INT4 ? kt / 2 : kt;  // the weight's byte row
          tma_load_2d(st, &a.wmap, full, c0, kq);
          tma_load_2d(st + C::W_BYTES, &a.wmap, full, c1, kq);
#pragma unroll
          for (int j = 0; j < KS / 64; ++j)
            tma_load_2d(st + 2 * C::W_BYTES + j * N * 128, &a.xmap, full, kt + 64 * j, p * N);
          if constexpr (GRP) {
            // the scale rows of the groups of [kt, kt + KS), the tile's two boxes each
            const uint32_t sc = sbase + C::SC + s * C::SC_STAGE;
            for (int j = 0; j < ng; ++j) {
              const float* srow = a.scale + (size_t)(kt / a.group + j) * a.Out;
              bulk_load(sc + j * TILE * 4, srow + c0, HALF * 4, full);
              bulk_load(sc + j * TILE * 4 + HALF * 4, srow + c1, HALF * 4, full);
            }
          }
        }
        // the cluster barrier of the receive slots' reuse: this thread's
        // arrive for the next item (the consumers wait for it before their
        // stores), after its wait for the last one
        if (split > 1 && item + 1 < items) {
          cluster_wait();
          cluster_arrive();
        }
      }
    }
    return;
  }

  // ---- consumers --------------------------------------------------------------
  const int tid = threadIdx.x;  // 0 .. NCW * 32 - 1
  const int wg = warp >> 2, wi = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int ctid = tid & 127;  // the thread within its warpgroup
  if (norm)
    row_norm_factors<NCW>(a.x, a.M, a.In, k0, k1, a.eps, MAX_ROWS,
                          reinterpret_cast<float*>(smem + C::SSQ),
                          reinterpret_cast<float*>(smem + C::RR), stat_bar, rank, split);
  else
    cluster_wait();
  const float* rr = reinterpret_cast<const float*>(smem + C::RR);
  // this thread's column of each box: 16 wi + 2 g + wg (A rows g and g + 8)
  const int cb = 16 * wi + 2 * g + wg;
  // ldmatrix.x4.trans (int8): lane L reads row (L & 7) of matrix L >> 3, i.e.
  // box L >> 4, k octet (L >> 3) & 1 of the step, this warp's 16-byte chunk
  // (64-byte swizzle: chunk ^ (row / 2 % 4)); int4: the 16-bit pairs of
  // columns 2 g, 2 g + 1 of packed rows t4 and t4 + 4 of each box
  const int owned = (UNITS - (int)rank + split - 1) / split;
  const uint32_t sel4 = wg ? 0x5511u : 0x4400u;  // int4: this warpgroup's byte of a pair
  const int glog = GRP ? __ffs(a.group) - 1 : 0;  // group-wise: log2(group)

  int s = 0, item = 0;  // the ring's stage, and its phase
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const int c0 = a.gate ? t * HALF + cb : t * TILE + cb;  // box 0's column (gate: output column)
    const int c1 = a.gate ? a.Out / 2 + t * HALF + cb : t * TILE + HALF + cb;
    for (int p = 0; p < npass; ++p, ++item) {
      const int m0 = p * N;
      if (split > 1 && tid == 0) mbar_expect_tx(red_bar, owned * split * UNIT_BYTES);
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      // group-wise: the current group's f32 partial (products of one group only)
      float part[GRP ? 64 : 1];
#pragma unroll
      for (int e = 0; e < (GRP ? 64 : 1); ++e) part[e] = 0.f;
      uint32_t af[NSETS][4] = {};
      int pend = -1;  // a stage whose wgmmas may still run, released after the next wait

      for (int i = 0; i < nk; ++i, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
        mbar_wait(bars + 8 * s, ph);  // the stage's boxes have landed
        const uint32_t wst = sbase + s * C::STAGE;
        const uint32_t xst = wst + 2 * C::W_BYTES;
        const uint8_t* ws = smem + s * C::STAGE;
        const int kt = k0 + i * KS;
        if (norm) {
          // the stage's x tile normalized in place, one 16-byte chunk a k16
          // step's worth a thread, then the async-proxy fence and the
          // consumers' barrier before any wgmma reads it
#pragma unroll
          for (int q = 0; q < KS / 16; ++q)
            norm_chunk(smem + s * C::STAGE + 2 * C::W_BYTES, smem + C::NW + s * KS * 2, rr, m0,
                       a.M, tid + q * NCW * 32);
          fence_proxy_async();
          consumers_sync();
        }
        const float* sc = GRP ? reinterpret_cast<const float*>(smem + C::SC + s * C::SC_STAGE) + cb
                              : nullptr;
        bool drained = false;
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          uint32_t (&A)[4] = af[kk % NSETS];
          if constexpr (INT4) {
            // packed rows 8 kk + t4 (contraction rows 16 kk + 2 t4, + 1) and
            // 8 kk + t4 + 4 (+ 8, + 9) of both boxes, columns 2 g, 2 g + 1 of
            // this warp's chunk; this warpgroup's byte of each pair
            const int r0 = 8 * kk + t4, r1 = r0 + 4;
            const uint8_t* p0 = ws + r0 * HALF + ((wi ^ ((r0 >> 1) & 3)) << 4) + 2 * g;
            const uint8_t* p1 = ws + r1 * HALF + ((wi ^ ((r1 >> 1) & 3)) << 4) + 2 * g;
            const uint32_t w00 = *reinterpret_cast<const uint16_t*>(p0);
            const uint32_t w10 = *reinterpret_cast<const uint16_t*>(p0 + C::W_BYTES);
            const uint32_t w01 = *reinterpret_cast<const uint16_t*>(p1);
            const uint32_t w11 = *reinterpret_cast<const uint16_t*>(p1 + C::W_BYTES);
            A[0] = i4_pair(w00, sel4);
            A[1] = i4_pair(w10, sel4);
            A[2] = i4_pair(w01, sel4);
            A[3] = i4_pair(w11, sel4);
          } else {
            uint32_t wr[4];
            {
              const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
              ldsm_x4_trans_u32(wr, wst + (lane >> 4) * C::W_BYTES + row * HALF +
                                        ((wi ^ ((row >> 1) & 3)) << 4));
            }
            // wr: box 0 k 0-7, box 0 k 8-15, box 1 k 0-7, box 1 k 8-15 of the
            // step, each the k pairs of columns 2 g (bytes 0, 2) and 2 g + 1
            // (bytes 1, 3)
            const int sh = 8 * wg;
            A[0] = i8_pair(wr[0] >> sh);
            A[1] = i8_pair(wr[2] >> sh);
            A[2] = i8_pair(wr[1] >> sh);
            A[3] = i8_pair(wr[3] >> sh);
          }
          // x^T: contraction rows kt + 16 kk ..: sub-tile kk / 4, 32 bytes a step
          const uint64_t xd = smem_desc(xst + (kk >> 2) * N * 128, 16, 1024) + 2 * (kk & 3);
          wgmma_fence();
          if constexpr (GRP) {
            const int first = ((kt + 16 * kk) & (a.group - 1)) != 0;  // 0: a fresh group
            wgmma_n128(part, A, xd, first);
          } else {
            wgmma_n128(acc, A, xd, 1);
          }
          wgmma_commit();
          bool group_end = false;
          if constexpr (GRP) {
            group_end = ((kt + 16 * (kk + 1)) & (a.group - 1)) == 0;
            if (group_end) {
              // the group ends here: its sums, scaled, into acc (box 0's
              // column: d[4 j], d[4 j + 1]; box 1's: d[4 j + 2], d[4 j + 3])
              wgmma_wait<0>();
              fence_regs(part);
#pragma unroll
              for (int j = 0; j < NSETS; ++j) fence_a(af[j]);
              const float* srow = sc + (a.group >= KS ? 0 : (16 * kk) >> glog) * TILE;
              const float s0 = srow[0], s1 = srow[HALF];
#pragma unroll
              for (int e = 0; e < 64; ++e) acc[e] += part[e] * ((e & 2) ? s1 : s0);
              drained = kk + 1 == KS / 16;
            }
          }
          if (!group_end) {
            wgmma_wait<NSETS - 1>();  // the last step's wgmma: its A set is free again
            fence_a(af[(kk + 1) % NSETS]);
          }
          if (kk == 0 && pend >= 0) {
            mbar_arrive(bars + 8 * (S + pend));  // every earlier wgmma has completed
            pend = -1;
          }
        }
        if (drained)
          mbar_arrive(bars + 8 * (S + s));
        else
          pend = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pend >= 0) mbar_arrive(bars + 8 * (S + pend));

      // one scale a column: box 0's column's and box 1's (the gate's and the up's)
      const float s0 = GRP ? 1.f : __ldg(a.scale + c0);
      const float s1 = GRP ? 1.f : __ldg(a.scale + c1);
      if (split == 1) {
        // the sums staged in the (then unused) receive area, the thread's
        // own unit u at [u][thread], and finished by a compact loop
        float4* own = reinterpret_cast<float4*>(smem + C::RECV) + wg * (N / 8) * 128 + ctid;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          own[j * 128] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
        for (int j = 0; j < N / 8; ++j) {
          const float4 q = own[j * 128];
          const float v[4] = {q.x, q.y, q.z, q.w};
          float r[4];
          load_res(a, m0 + 8 * j + 2 * t4, c0, c1, r);
          finish_unit(a, m0 + 8 * j + 2 * t4, c0, c1, v, s0, s1, r);
        }
        continue;
      }
      // unit u = (wg, j) is reduced and finished by rank u % split: each rank
      // stores its partial of unit u into slot [rank] of that rank's receive
      // area, completing on its red barrier, and the owner adds the slots in
      // split order; the slots of the last item must be free (the cluster
      // barrier's wait)
      if (item > 0) cluster_wait();
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int u = wg * (N / 8) + j;
        const uint32_t owner = u % split;
        const uint32_t dst = rank_addr(sbase + C::RECV, owner);
        const float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        st_async_f32x4(dst + ((u / split) * split + (int)rank) * UNIT_BYTES + ctid * 16, v,
                       rank_addr(red_bar, owner));
      }
      mbar_wait(red_bar, item & 1);  // every rank's partials of this rank's units
      const float4* P = reinterpret_cast<const float4*>(smem + C::RECV);
      for (int j = 0; j < N / 8; ++j) {
        const int u = wg * (N / 8) + j;
        if (u % split != (int)rank) continue;
        const float4* slot = P + (u / split) * split * 128 + ctid;
        float4 q = slot[0];
        float v[4] = {q.x, q.y, q.z, q.w};
        for (int k = 1; k < split; ++k) {
          q = slot[k * 128];
          v[0] += q.x, v[1] += q.y, v[2] += q.z, v[3] += q.w;
        }
        float r[4];
        load_res(a, m0 + 8 * j + 2 * t4, c0, c1, r);
        finish_unit(a, m0 + 8 * j + 2 * t4, c0, c1, v, s0, s1, r);
      }
      // this rank has read its slots: the arrive of the next item's wait
      if (item + 1 < items) cluster_arrive();
    }
  }
}

// ---- host side ----------------------------------------------------------------

// The weight's map over its [rows, Out] bytes (int8 q, or packed int4 q with
// rows = In / 2), box {HALF, WROWS}, 64-byte swizzle, encoded once per
// (pointer, shape).
static CUresult weight_map(CUtensorMap* map, const int8_t* q, int rows, int Out) {
  return cached_map(map, std::make_tuple(static_cast<const void*>(q), rows, Out),
                    [&](CUtensorMap* m) {
                      return encode_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 1, Out, rows, HALF,
                                       WROWS, CU_TENSOR_MAP_SWIZZLE_64B);
                    });
}

// The launch configuration of a grid of clusters (1, split, 1).
template <int FMT>
static cudaLaunchConfig_t config(int split, cudaLaunchAttribute* cluster, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, split, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = Cfg<FMT>::SMEM;
  cfg.stream = st;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = 1;
  cluster->val.clusterDim.y = split;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of `split` blocks the card holds at once (the grid's
// width), read once per instantiation and split; 0 after a failure, its
// error in *err.
template <int FMT>
static int resident(int split, cudaError_t* err) {
  // once per instantiation: the attribute, then each split's residency
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_m128_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<FMT>::SMEM);
  static int clusters[MAX_SPLIT + 1] = {};
  *err = attr;
  if (attr != cudaSuccess) return 0;
  if (clusters[split] == 0) {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = config<FMT>(split, &cluster, 0);
    int n = 0;
    *err = cudaOccupancyMaxActiveClusters(&n, qmm_m128_kernel<FMT>, &cfg);
    if (*err != cudaSuccess) return 0;
    if (n < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    clusters[split] = n;
  }
  return clusters[split];
}

template <int FMT>
static cudaError_t launch(Args& a, int split, cudaStream_t st) {
  cudaError_t err;
  const int clusters = resident<FMT>(split, &err);
  if (clusters == 0) return err;
  const CUresult enc = encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, 2, a.In, a.M,
                                 64, N, CU_TENSOR_MAP_SWIZZLE_128B);
  if (enc != CUDA_SUCCESS) return static_cast<cudaError_t>(kEncodeError + enc);
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg = config<FMT>(split, &cluster, st);
  cfg.gridDim = dim3(min(a.ntiles, clusters), split, 1);
  return cudaLaunchKernelEx(&cfg, qmm_m128_kernel<FMT>, a);
}

// The checks and the launch the entry points share; unit: the contraction
// rows a split is cut in (a multiple of the stage's).
template <int FMT>
static int run(Args& a, const void* q, int split, int unit, cudaStream_t st) {
  const int units = a.In / unit;
  const int per = (units + split - 1) / split;
  if (split < 1 || split > MAX_SPLIT || (units + per - 1) / per != split)
    return (int)cudaErrorInvalidValue;  // an empty split
  const CUresult enc =
      weight_map(&a.wmap, static_cast<const int8_t*>(q), FMT == kI4 ? a.In / 2 : a.In, a.Out);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  a.kchunk = per * unit;
  a.ntiles = a.Out / TILE;
  const cudaError_t err = launch<FMT>(a, split, st);
  if ((int)err >= kEncodeError) return (int)err;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static bool rows_ok(int M) { return M > 64 && M <= MAX_ROWS; }

}  // namespace qmt
}  // namespace md

// B4 and B6 at 65..256 rows: out = epilogue(norm?(x)[M, In] @ q[In, Out] *
// scale) in one launch.  scale: [Out] (group == In) or group-wise [In /
// group, Out] (group a power of two >= 32 dividing In); norm_w [In] and res
// [M, Out] may be null; gate: q is [In, 2F] and out [M, F].  split: the
// contraction's splits in units of max(group, 64) rows (group == In: 64),
// 1..8, none empty (the wrapper's m128_split_plan).  Returns
// cudaGetLastError(), or 0x10000 + the CUresult of a failed tensor-map encode.
extern "C" int md_quant_matmul_m128_sm90(const void* x, const void* q, const void* scale,
                                         const void* norm_w, const void* res, void* out, int M,
                                         int In, int Out, int gate, int split, int group,
                                         float eps, void* stream) {
  using namespace md::qmt;
  if (!rows_ok(M) || In % WROWS != 0 || Out % TILE != 0 || (gate && res != nullptr) ||
      group < 32 || In % group != 0 || (group != In && (group & (group - 1)) != 0))
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
  a.group = group;
  a.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group == In) return run<kI8>(a, q, split, WROWS, st);
  return run<kI8G>(a, q, split, group > WROWS ? group : WROWS, st);
}

// The clusters of `split` blocks (1..8) the card holds at once for the
// 128-row core's format `fmt` (0 int8 one scale a column, 1 group-wise int8,
// 2 int4): the width of its grids, and the residency its split plan assumes
// (kernels/quant_matmul.py M128_CLUSTERS).  Returns -cudaError on failure.
extern "C" int md_quant_matmul_m128_resident(int fmt, int split) {
  using namespace md::qmt;
  if (split < 1 || split > MAX_SPLIT || fmt < 0 || fmt > 2) return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const int n = fmt == kI8 ? resident<kI8>(split, &err)
                : fmt == kI8G ? resident<kI8G>(split, &err) : resident<kI4>(split, &err);
  return n > 0 ? n : -(int)err;
}

// B4-int4 at 65..256 rows: out = epilogue(x[M, In] @ dequant(q[In / 2, Out]
// packed int4, scale[In / group, Out])) in one launch, the epilogue the SiLU
// gate (gate: out [M, Out / 2]), a residual res [M, Out] (or null), or none.
// group: a power of two >= 32 with In % max(group, 128) == 0; split: the
// contraction's splits in units of max(group, 128) rows (1..8, none empty,
// the wrapper's m128_split_plan).  Returns as md_quant_matmul_m128_sm90.
extern "C" int md_quant_matmul_int4_m128_sm90(const void* x, const void* q, const void* scale,
                                              const void* res, void* out, int M, int In,
                                              int Out, int gate, int split, int group,
                                              void* stream) {
  using namespace md::qmt;
  constexpr int KS = Cfg<kI4>::KS;
  if (!rows_ok(M) || Out % TILE != 0 || (gate && res != nullptr) || group < 32 ||
      (group & (group - 1)) != 0 || In % (group > KS ? group : KS) != 0)
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
  return run<kI4>(a, q, split, group > KS ? group : KS, static_cast<cudaStream_t>(stream));
}

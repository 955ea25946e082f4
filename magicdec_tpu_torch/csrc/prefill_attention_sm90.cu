// K2, K2q and B11 on Hopper: chunked-prefill flash attention over the
// layer-stacked bf16 cache (K2), the int8 cache (K2q) and the int4 cache
// packed in head pairs (B11), one launch a call.
//
// Replaces magicdec_tpu/ops/pallas/prefill_attention.py flash_prefill_attend
// (_prefill_kernel), flash_prefill_attend_quant (_prefill_quant_kernel) and
// flash_prefill_attend_quant4 (_prefill_quant4_kernel; at head dim 64, and
// the int4 one at 128 too), the quantized ones
// with the scale order of decode_attention.py _quant_online_update.  A
// C-token chunk of request b attends the cache rows [0, base_b) of layer
// `layer` plus its own fresh rows [base_b, base_b + C) (or, without fresh
// rows, the cache holds the chunk): token t sees positions [0, min(base_b +
// t + 1, S)).  The score of column c is s_raw / sqrt(hd) (quantized: s_raw *
// (k_scale[c] / sqrt(hd))), masked columns take -1e30, l sums the unscaled
// p, P.V takes bf16(p) (quantized: bf16(p * v_scale[c])), and the output is
// acc / max(l, 1e-30) in bf16.  The scales are f32 or, in the bf16-scale
// instances (BFS; the JAX package's kv_scale_dtype=bf16), bf16, each widened
// to f32 exactly as the producer loads it and before the k factor's fold, so
// every product is the f32 instance's on the widened values.
//
// Bound: tensor-core operations and exponentials, about equally.  Each
// visible (row, column) pair costs 4 hd = 256 flops and one ex2; at 989
// TFLOP/s and 16 ex2 a clock per SM the two take about the same time at hd =
// 64, and the bytes (int8 or int4 rows, read once per 192 query rows) are
// far below either.  Every instruction the softmax issues besides the
// products (the scale multiplies, max, exp, sums, packing) competes for the
// same issue slots, and the exponentials for the SM's 16 ex2 a clock, so the
// design keeps everything else off the consumers' path:
//
// - Rows.  A block takes 192 grouped query rows of one (request b, kv head
//   h) (row r: token t = r / G of query head h G + r % G, so one K/V tile
//   feeds all G heads), split between three consumer warpgroups of 64 rows;
//   a fourth warpgroup produces the tiles.  setmaxnreg moves registers from
//   the producer (56) to the consumers (152).  The three formats share the
//   consumers; only the producer differs.  Three consumer warps on each
//   SM sub-partition hide each other's softmax latency: with two (128 rows)
//   the kernel took 3.55 ms at the bench's shape, with three 2.99 (PERF.md).
// - Products on wgmma.  S = Q K^T is m64n128k16 with Q resident in shared
//   memory and the K tile K-major; O += P V is m64n64k16 with P taken from
//   the score registers (the S accumulator's layout is the A fragment's)
//   and V MN-major.  A 64-value bf16 row is 128 bytes: both tiles use the
//   128-byte swizzle, so wgmma reads them without bank conflicts.  Each
//   warpgroup runs S, softmax, P.V in turn; the three overlap one another.
//   Issuing the next tile's S before this tile's softmax (FA3's in-warpgroup
//   overlap) needs S, P and O live at once, past the 152 registers a
//   consumer has here: ptxas then serializes every wgmma, which was slower;
//   turns on named barriers (FA3's ping-pong) changed nothing measurable.
// - Loads by TMA.  The producer's lead thread keeps I8_STAGES tiles of 128
//   int8 (int4: packed) rows of K and V in flight on mbarriers: 64-byte
//   boxes of a 3-D tensor map over the layer's cache [B, S, row bytes]
//   (rows past S arrive as zeros), or over the fresh rows [B, C, row bytes]
//   for tiles at or past base.  The maps are encoded once per (pointer,
//   shape) and cached.  The one tile of a block that straddles base (serving
//   admission's ragged lengths) takes its rows from base on by the
//   producer's own 16-byte loads.
// - bf16 (K2): no conversion.  The lead thread lands 128-byte (64-value) x
//   128-row boxes with the 128-byte swizzle straight into the tiles the
//   consumers' wgmma reads, BF_STAGES of them in flight; the score factor
//   is the constant 1/sqrt(hd) * log2(e).  A bf16 tile has no scale to zero,
//   and a masked p of 0 times a V row holding inf or NaN (a torch.empty
//   cache) is NaN inside wgmma, so rows the block cannot see must be zeros:
//   the tile that holds the block's visible end (without fresh rows) and the
//   tile that straddles base (with them) are written by all 128 producer
//   threads with 16-byte loads, zeros from the visible end on (TMA
//   zero-fills only past S), and handed on by the lead thread.
// - Conversion off the consumers' path (int8, int4).  The producer
//   warpgroup turns each landed int8 tile (int4: the head's nibble plane)
//   into the swizzled bf16 tile the consumers' wgmma reads, exactly (a byte
//   permute, two logic ops and a bf16x2 subtraction a pair, no conversion
//   unit), with the tile's scales: k_scale * 1/sqrt(hd) * log2(e) folded into one factor a column,
//   v_scale as is, both zero for columns the block cannot see (a
//   torch.empty cache may hold inf there: 0 * inf must never reach a sum),
//   the scale loads issued one tile ahead.  It arrives on the stage's
//   "full" barrier; the consumers release it on an "empty" barrier once
//   their P.V has read it.  Loads and conversion run BF_STAGES tiles ahead.
// - Softmax in the exp2 domain: one multiply a score (the folded factor),
//   the mask compare only on tiles that reach past the warpgroup's first
//   token's limit, the row maxima and sums as trees.
// - Bits.  No atomics and no split of the KV range: every launch on the same
//   inputs gives the same bits (the encode and encode_baseline contract).
// - Head dim 128 (B11's instance, the 8B target's int4 cache; Geo<128>): a
//   tile keeps its bytes at 64 positions, so the stages, the ring and the
//   consumers' registers (S 32, O 64, P 16) stay in budget beside a Q of
//   48 KB; a 128-value bf16 row is two 64-value halves of 128 bytes under
//   the swizzle (TMA's widest box), Q and K walk k16 steps 0-3 in the first
//   half and 4-7 in the second, and P.V runs one m64n64k16 a half of V
//   into its half of O.
#include <tuple>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace pfa {

using namespace md::sm90;

// the cache formats: bf16 (K2), int8 (K2q), int4 packed in head pairs (B11)
enum Fmt { kBF16 = 0, kI8 = 1, kI4 = 2 };
constexpr int NCONS = 3;                    // consumer warpgroups of 64 rows
constexpr int BM = 64 * NCONS;              // grouped query rows a block
constexpr int NTHREADS = 128 * (NCONS + 1);  // + the producer warpgroup
constexpr int I8_STAGES = 4;                // int8 tiles in flight (TMA)
constexpr int BF_STAGES = 3;                // converted tiles ready for wgmma
constexpr int NBARS = I8_STAGES + 2 * BF_STAGES;

// The geometry of the instance of head dim HD (64: K2, K2q, B11; 128: B11).
// A tile keeps its bytes: 128 positions at head dim 64, 64 at 128, so the
// stages and the consumers' score registers fit either way.  A bf16 row of
// 128 values is 256 bytes, past the 128-byte swizzle's box: Q, K and V
// tiles are stored as 64-value column halves, each [rows][128 bytes]
// under the swizzle, and wgmma's k16 steps walk both halves.
template <int HD_>
struct Geo {
  static constexpr int HD = HD_;
  static constexpr int BN = 8192 / HD;      // KV positions a tile
  static constexpr int NS = BN / 2;         // scores a consumer thread holds (S fragment)
  static constexpr int HALVES = HD / 64;    // 64-value column halves of a bf16 row
  static constexpr int HALF = BN * 128;     // bytes of one half of a bf16 K or V tile
  static constexpr int Q_HALF = 64 * 128;   // bytes of one half of a warpgroup's Q
  // 1/sqrt(HD) * log2(e)
  static constexpr float kFold = (HD == 64 ? 0.125f : 0.08838834764831845f) * 1.4426950408889634f;
  static constexpr int I8_TILE = BN * HD;    // bytes of one int8 K or V tile
  static constexpr int BF_TILE = BN * HD * 2;  // bytes of one bf16 K or V tile
  // shared memory, from a 1024-byte-aligned base (the swizzle's period)
  static constexpr int Q_OFF = 0;            // [BM][HD] bf16, swizzled halves
  static constexpr int BF_OFF = Q_OFF + BM * HD * 2;
  // a tile's column scales, laid out for the consumers: column c = 8 j + 2
  // t4 + e at t4 * SC_LD + 2 j + e, so the thread quad's lane t4 reads its
  // BN / 4 columns as 16-byte loads, each quad lane from other banks
  static constexpr int SC_LD = BN / 4 + 4;
  static constexpr int SC_FLOATS = 4 * SC_LD;
  static constexpr int BF_STAGE = 2 * BF_TILE + 2048;  // K, V, k factors and v scales
  static constexpr int I8_OFF = BF_OFF + BF_STAGES * BF_STAGE;
  static constexpr int I8_STAGE = 2 * I8_TILE;  // K, V
  // the barriers: after the int8 ring, or (bf16) where it would start
  __host__ __device__ static constexpr int bar_off(int fmt) {
    return I8_OFF + (fmt == kBF16 ? 0 : I8_STAGES * I8_STAGE);
  }
  __host__ __device__ static constexpr int smem(int fmt) {  // + slack to align the base
    return bar_off(fmt) + 8 * NBARS + 1024;
  }
};
template <int HD>
constexpr bool geo_ok() {
  using G = Geo<HD>;
  return G::BF_STAGE % 1024 == 0 && G::BF_OFF % 1024 == 0 && G::HALF % 1024 == 0 &&
         G::smem(kI8) <= 227 * 1024 && 2 * G::SC_FLOATS * 4 <= 2048;
}
static_assert(geo_ok<64>() && geo_ok<128>(),
              "bf16 tiles keep the swizzle period; one block's shared memory; the scales fit");
// named barriers (0 is __syncthreads): the producer warpgroup's, each
// consumer warpgroup's Q
constexpr int BAR_PRODUCER = 1;
constexpr int BAR_Q = 2;

struct Args {
  CUtensorMap kmap, vmap;    // layer's cache [B, S, Kw], box {HD, BN, 1} (bf16: 128-byte swizzle)
                             // (HD, BN: the instance's Geo)
  CUtensorMap knmap, vnmap;  // fresh rows [B, T, Kw], same box (with fresh rows)
  const __nv_bfloat16* q;    // [B, T, Hq, HD]
  const uint8_t* k;          // the layer's cache [B, S, Kw] (bf16: the producer's own loads)
  const uint8_t* v;
  const uint8_t* k_new;      // [B, T, Kw] or null
  const uint8_t* v_new;
  const void* k_scale;       // [L, B, Hkv, S] (quantized; f32, or bf16 with BFS)
  const void* v_scale;
  const void* ks_new;        // [B, Hkv, T] or null
  const void* vs_new;
  const int* base_lens;      // [B]
  __nv_bfloat16* out;        // [B, T, Hq, HD]
  int layer, B, S, T, Hq, Hkv, Kw;  // Kw: a row's values (int4: bytes of a head pair's rows)
};

namespace {

// S (+)= A B over one k16 step: m64n128k16, A (Q) and B (K) from shared
// memory (K-major, 128-byte swizzle), f32 accumulators in the D fragment
// layout (d[4j + e]: row 16 warp + g + 8 (e / 2), column 8 j + 2 t4 + e % 2).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at BN = 64 (head dim 128): m64n64k16, 32 accumulators (d[4j +
// e]: column 8 j + 2 t4 + e % 2).
__device__ __forceinline__ void wgmma_qk64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V over one k16 step: m64n64k16, A (P) from registers in the mma A
// fragment layout, B (V) from shared memory MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&pa)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(pa[0]), "r"(pa[1]), "r"(pa[2]), "r"(pa[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}


// Four int8 (one word, byte 0 first) -> four bf16 in order (lo: bytes 0 and
// 1), exactly: with x holding bytes at 0 and 2 of each half, low7 = v & 0x7F
// under bf16's exponent of 2^7 reads 128 + low7 and the sign bit under the
// same exponent reads 128 or 256, so their difference is v.  Two byte
// permutes, four logic ops and two bf16x2 subtractions; k7, ks and kb hold
// 0x007F007F, 0x00800080 and 0x43004300 in registers.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t k7, uint32_t ks, uint32_t kb,
                                          uint32_t& lo, uint32_t& hi) {
  const uint32_t x01 = __byte_perm(w, 0u, 0x4140), x23 = __byte_perm(w, 0u, 0x4342);
  lo = bf16x2_sub(lop3_and_or(x01, k7, kb), lop3_and_or(x01, ks, kb));
  hi = bf16x2_sub(lop3_and_or(x23, k7, kb), lop3_and_or(x23, ks, kb));
}

// Sixteen cache bytes -> sixteen bf16 values (int8, or the `shift` nibble
// plane of a packed int4 row) in order, as two 16-byte chunks.
template <bool INT4>
__device__ __forceinline__ void convert16(uint4 raw, int shift, const uint32_t (&k)[3],
                                          uint4& c0, uint4& c1) {
  uint32_t w[8];
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (INT4)
      i4x4_to_bf16x4(in[j], shift, w[2 * j], w[2 * j + 1]);
    else
      i8x4_bf16(in[j], k[0], k[1], k[2], w[2 * j], w[2 * j + 1]);
  }
  c0 = make_uint4(w[0], w[1], w[2], w[3]);
  c1 = make_uint4(w[4], w[5], w[6], w[7]);
}

// t[0] = op over t[0 .. N), as a tree (N a power of two; constant indices,
// so t stays in registers).
template <int N, typename Op>
__device__ __forceinline__ void tree(float* t, Op op) {
  if constexpr (N > 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) t[j] = op(t[j], t[j + N / 2]);
    tree<N / 2>(t, op);
  }
}

// The online softmax of one tile's scores s (the S accumulator: s[4 j + e]
// is row i = e / 2 of the thread's two, column c0 + 8 j + 2 t4 + e % 2) in
// the exp2 domain: y = s_raw * kf (SCALED: k_scale / sqrt(hd) * log2 e a
// column, else kFold), -1e30 where masked (MASKED: a tile reaching past the
// warpgroup's first limit); s becomes p, m and l are updated, corr is the
// factor for the accumulator.  kf points at the thread's BN / 4 columns (2
// j + e).  The row maxima and sums are trees, not chains: a warp has few
// neighbours to hide latency.  HD: the instance (Geo<HD>'s BN, NS, kFold).
template <int HD, bool MASKED, bool SCALED>
__device__ __forceinline__ void softmax_tile(float (&s)[Geo<HD>::NS], const float* kf, int c0,
                                             const int (&lim)[2], int t4, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) {
  constexpr int BN = Geo<HD>::BN, NS = Geo<HD>::NS;
  constexpr float kFold = Geo<HD>::kFold;
  if constexpr (SCALED) {
#pragma unroll
    for (int j2 = 0; j2 < BN / 16; ++j2) {
      const float4 f = *reinterpret_cast<const float4*>(kf + 4 * j2);
      const float fj[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[8 * j2 + 4 * h + e] *= fj[2 * h + (e & 1)];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] *= kFold;
  }
  if constexpr (MASKED) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + 8 * j + 2 * t4 + (e & 1) >= lim[e >> 1]) s[4 * j + e] = kNegInf;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[NS / 4];
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) t[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
    tree<NS / 4>(t, [](float x, float y) { return fmaxf(x, y); });
    float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = ex2(s[j] - m[(j >> 1) & 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[NS / 4];
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) t[j] = s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    tree<NS / 4>(t, [](float x, float y) { return x + y; });
    l[i] = l[i] * corr[i] + t[0];
  }
}

// P = bf16(p * v_scale) (SCALED) or bf16(p) as A fragments (pa[kk]:
// columns 16 kk .. 16 kk + 15); vsc points at the thread's BN / 4 columns
// (2 j + e).
template <int HD, bool SCALED>
__device__ __forceinline__ void pack_p(const float (&s)[Geo<HD>::NS], const float* vsc,
                                       uint32_t (&pa)[Geo<HD>::BN / 16][4]) {
  constexpr int BN = Geo<HD>::BN;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    // columns 16 kk + 2 t4 (+1) (j = 2 kk) and 16 kk + 8 + 2 t4 (+1) (j = 2 kk + 1)
    const float4 v = SCALED ? *reinterpret_cast<const float4*>(vsc + 4 * kk)
                            : make_float4(1.f, 1.f, 1.f, 1.f);
    pa[kk][0] = pack_bf16x2(s[8 * kk] * v.x, s[8 * kk + 1] * v.y);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2] * v.x, s[8 * kk + 3] * v.y);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4] * v.z, s[8 * kk + 5] * v.w);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6] * v.z, s[8 * kk + 7] * v.w);
  }
}

}  // namespace

// The producer warpgroup's own barrier.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(BAR_PRODUCER) : "memory");
}

// Scale i of an f32 or (BFS) bf16 array, widened to f32 exactly.
template <bool BFS>
__device__ __forceinline__ float load_scale(const void* scale, size_t i) {
  if constexpr (BFS)
    return __uint_as_float((uint32_t)__ldg(static_cast<const uint16_t*>(scale) + i) << 16);
  else
    return __ldg(static_cast<const float*>(scale) + i);
}

// Grid (row blocks, Hkv, B), NTHREADS threads: warpgroups 0 .. NCONS - 1
// consume (64 rows each), warpgroup NCONS produces; BFS: bf16 scales; HD:
// the head dim (128: the quantized formats only).
template <int FMT, bool BFS = false, int HD = 64>
__global__ void __launch_bounds__(NTHREADS, 1) prefill_sm90_kernel(const __grid_constant__ Args a) {
  constexpr bool INT4 = FMT == kI4, Q8 = FMT != kBF16;
  static_assert(HD == 64 || Q8, "the bf16 producer writes 64-value rows");
  using Gm = Geo<HD>;
  constexpr int BN = Gm::BN, NS = Gm::NS, HALVES = Gm::HALVES, HALF = Gm::HALF;
  constexpr int I8_TILE = Gm::I8_TILE, BF_TILE = Gm::BF_TILE, BF_OFF = Gm::BF_OFF;
  constexpr int BF_STAGE = Gm::BF_STAGE, I8_OFF = Gm::I8_OFF, I8_STAGE = Gm::I8_STAGE;
  constexpr int SC_LD = Gm::SC_LD, SC_FLOATS = Gm::SC_FLOATS;
  constexpr float kFold = Gm::kFold;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  // i8_full[s] (TMA bytes), bf_full[s] (the producer's 128 threads; bf16:
  // the lead thread, with the TMA bytes), bf_empty[s] (every consumer thread)
  const uint32_t i8_full = sbase + Gm::bar_off(FMT);
  const uint32_t bf_full = i8_full + 8 * I8_STAGES;
  const uint32_t bf_empty = bf_full + 8 * BF_STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  const int r_block = blockIdx.x * BM;
  const int base = a.base_lens[b];
  const bool fresh = a.k_new != nullptr;
  const int t_last = min((r_block + BM - 1) / G, a.T - 1);
  const int hi = min(base + t_last + 1, a.S);  // the block sees positions [0, hi)
  const int ntiles = (hi + BN - 1) / BN;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < I8_STAGES; ++s) mbar_init(i8_full + 8 * s, 1);
    for (int s = 0; s < BF_STAGES; ++s) {
      mbar_init(bf_full + 8 * s, Q8 ? 128 : 1);
      mbar_init(bf_empty + 8 * s, 128 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS && !Q8) {
    // ---- bf16 producer: TMA loads (lead thread), the tiles that need zeros
    // by hand (all 128) --------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int p = threadIdx.x - 128 * NCONS;
    if (p == 0) {
      prefetch_map(&a.kmap);
      prefetch_map(&a.vmap);
      if (fresh) {
        prefetch_map(&a.knmap);
        prefetch_map(&a.vnmap);
      }
    }
    const int c16 = p & 7;  // this thread's 16-byte chunk of every row
    const size_t col = (size_t)h * HD + c16 * 8;
    for (int i = 0; i < ntiles; ++i) {
      const int c0 = i * BN, s = i % BF_STAGES;
      // rows past the visible end come from the cache only in the block's
      // last tile without fresh rows; with them, the tile straddling base
      const bool by_hand = fresh ? c0 < base && c0 + BN > base : c0 + BN > hi && hi < a.S;
      // every thread waits for every tile in turn: a parity wait is right
      // only one phase ahead
      mbar_wait(bf_empty + 8 * s, ((i / BF_STAGES) & 1) ^ 1);  // the consumers let it go
      const uint32_t full = bf_full + 8 * s;
      if (!by_hand) {
        if (p != 0) continue;
        const uint32_t dst = sbase + BF_OFF + s * BF_STAGE;
        mbar_expect_tx(full, 2 * BF_TILE);
        const bool from_new = fresh && c0 >= base;
        const int row = from_new ? c0 - base : c0;
        tma_load_3d(dst, from_new ? &a.knmap : &a.kmap, full, h * HD, row, b);
        tma_load_3d(dst + BF_TILE, from_new ? &a.vnmap : &a.vmap, full, h * HD, row, b);
        continue;
      }
      // row c0 + r: fresh row r + c0 - base from base on, a cache row below
      // the visible end, else zeros; 128 bytes a row, 16-byte chunk c at c ^
      // r % 8 (the 128-byte swizzle TMA writes); four loads in flight
      uint8_t* tile = smem + BF_OFF + s * BF_STAGE;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint8_t* cache = kv ? a.v : a.k;
        const uint8_t* fr = kv ? a.v_new : a.k_new;
#pragma unroll
        for (int k0 = 0; k0 < BN / 16; k0 += 4) {
          uint4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = c0 + (p >> 3) + 16 * (k0 + k);
            v[k] = make_uint4(0, 0, 0, 0);
            if (fresh && r >= base) {
              if (r - base < a.T)
                v[k] = __ldg(reinterpret_cast<const uint4*>(
                    fr + (((size_t)b * a.T + (r - base)) * a.Kw + col) * 2));
            } else if (r < hi) {
              v[k] = __ldg(reinterpret_cast<const uint4*>(
                  cache + (((size_t)b * a.S + r) * a.Kw + col) * 2));
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = (p >> 3) + 16 * (k0 + k);
            *reinterpret_cast<uint4*>(tile + kv * BF_TILE + r * 128 + ((c16 ^ (r & 7)) << 4)) =
                v[k];
          }
        }
      }
      fence_proxy_async();  // the tile's generic writes before wgmma reads them
      producer_sync();
      if (p == 0) mbar_arrive(full);
    }
  } else if (wg == NCONS) {
    // ---- producer: TMA loads (lead thread), conversion (all 128) ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int p = threadIdx.x - 128 * NCONS;
    const int h_lane = INT4 ? (h >> 1) * HD : h * HD;  // the head's bytes in a row
    const int shift = (h & 1) * 4;                     // int4: its nibble plane
    auto issue = [&](int i) {
      const int c0 = i * BN, s = i % I8_STAGES;
      const uint32_t full = i8_full + 8 * s;
      const uint32_t dst = sbase + I8_OFF + s * I8_STAGE;
      mbar_expect_tx(full, I8_STAGE);
      if (fresh && c0 >= base) {
        tma_load_3d(dst, &a.knmap, full, h_lane, c0 - base, b);
        tma_load_3d(dst + I8_TILE, &a.vnmap, full, h_lane, c0 - base, b);
      } else {
        tma_load_3d(dst, &a.kmap, full, h_lane, c0, b);
        tma_load_3d(dst + I8_TILE, &a.vmap, full, h_lane, c0, b);
      }
    };
    if (p == 0) {
      prefetch_map(&a.kmap);
      prefetch_map(&a.vmap);
      if (fresh) {
        prefetch_map(&a.knmap);
        prefetch_map(&a.vnmap);
      }
      for (int i = 0; i < min(ntiles, I8_STAGES); ++i) issue(i);
    }
    const size_t srow = (((size_t)a.layer * a.B + b) * a.Hkv + h) * a.S;
    const size_t snew = ((size_t)b * a.Hkv + h) * a.T;
    // the scales of column c0 + p (threads p < BN), zero where the block
    // sees nothing
    const bool scaler = BN == 128 || p < BN;
    auto load_scales = [&](int c0, float& ksv, float& vsv) {
      const int col = c0 + p;
      const bool from_new = fresh && col >= base;
      const size_t kat = from_new ? snew + (col - base) : srow + col;
      ksv = scaler && col < hi ? load_scale<BFS>(from_new ? a.ks_new : a.k_scale, kat) : 0.f;
      vsv = scaler && col < hi ? load_scale<BFS>(from_new ? a.vs_new : a.v_scale, kat) : 0.f;
    };
    // this thread's chunks: 16-byte chunk c16 (of CPR a row) of rows row0 +
    // RSTEP k of each tile, whose two bf16 chunks land at fixed swizzled
    // offsets of column half c16 / 4
    constexpr int CPR = HD / 16, RSTEP = 128 / CPR;
    const int row0 = p / CPR, c16 = p % CPR, hc = c16 & 3;
    const uint32_t lo_off = (c16 >> 2) * HALF + (((2 * hc) ^ (row0 & 7)) << 4);
    const uint32_t hi_off = (c16 >> 2) * HALF + (((2 * hc + 1) ^ (row0 & 7)) << 4);
    const int slot = ((p >> 1) & 3) * SC_LD + (p >> 3) * 2 + (p & 1);
    const uint32_t kconst[3] = {0x007F007Fu, 0x00800080u, 0x43004300u};
    float ksv, vsv;
    load_scales(0, ksv, vsv);
    for (int i = 0; i < ntiles; ++i) {
      const int c0 = i * BN;
      float ks_next = 0.f, vs_next = 0.f;  // one tile ahead: the loads' latency
      if (i + 1 < ntiles) load_scales(c0 + BN, ks_next, vs_next);
      const int s8 = i % I8_STAGES, sb = i % BF_STAGES;
      mbar_wait(bf_empty + 8 * sb, ((i / BF_STAGES) & 1) ^ 1);  // the consumers let it go
      mbar_wait(i8_full + 8 * s8, (i / I8_STAGES) & 1);         // the int8 tile landed
      const uint8_t* src = smem + I8_OFF + s8 * I8_STAGE + row0 * HD + c16 * 16;
      uint8_t* dst = smem + BF_OFF + sb * BF_STAGE + row0 * 128;
      // rows row0 + RSTEP k of one tile, converted, into its bf16 tile
      // (each half 128 bytes a row, 16-byte chunk c at c ^ row % 8: the
      // 128-byte swizzle)
      auto put = [&](uint8_t* row, uint4 v) {
        uint4 lo, hi16;
        convert16<INT4>(v, shift, kconst, lo, hi16);
        *reinterpret_cast<uint4*>(row + lo_off) = lo;
        *reinterpret_cast<uint4*>(row + hi_off) = hi16;
      };
      // the tile that straddles base takes its rows from base on from the
      // fresh rows, by this thread's own loads (the TMA box brought cache rows)
      const bool straddle = fresh && c0 < base && c0 + BN > base;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint8_t* fr = (kv ? a.v_new : a.k_new) + h_lane + c16 * 16;
#pragma unroll
        for (int k = 0; k < BN / RSTEP; ++k) {
          uint4 v = *reinterpret_cast<const uint4*>(src + kv * I8_TILE + k * RSTEP * HD);
          if (straddle) {
            const int t = c0 + row0 + RSTEP * k - base;
            if (t >= 0)
              v = t < a.T ? __ldg(reinterpret_cast<const uint4*>(fr + ((size_t)b * a.T + t) * a.Kw))
                          : make_uint4(0, 0, 0, 0);
          }
          put(dst + kv * BF_TILE + k * RSTEP * 128, v);
        }
      }
      float* sc = reinterpret_cast<float*>(smem + BF_OFF + sb * BF_STAGE + 2 * BF_TILE);
      if (scaler) {
        sc[slot] = ksv * kFold;
        sc[SC_FLOATS + slot] = vsv;
      }
      ksv = ks_next;
      vsv = vs_next;
      fence_proxy_async();  // the tile's generic writes before wgmma reads them
      mbar_arrive(bf_full + 8 * sb);
      // every producer thread has read int8 stage s8: refill it
      asm volatile("bar.sync %0, 128;\n" ::"n"(BAR_PRODUCER) : "memory");
      if (p == 0 && i + I8_STAGES < ntiles) issue(i + I8_STAGES);
    }
  } else {
    // ---- consumers: 64 rows each -------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r_wg = r_block + 64 * wg;
    // Q: this warpgroup's 64 rows into shared memory, 128-byte swizzle, in
    // column halves of 64 values (16-byte chunk c of a row: half c / 8)
    uint8_t* qs = smem + Gm::Q_OFF + wg * 64 * HD * 2;
    for (int j = tid; j < 64 * (HD / 8); j += 128) {
      const int rl = j / (HD / 8), c = j % (HD / 8), r = r_wg + rl;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < GT) {
        const int t = r / G, gq = r % G;
        v = __ldg(reinterpret_cast<const uint4*>(
            a.q + (((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + c * 8));
      }
      *reinterpret_cast<uint4*>(qs + (c >> 3) * Gm::Q_HALF + rl * 128 +
                                (((c & 7) ^ (rl & 7)) << 4)) = v;
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_Q + wg) : "memory");
    const uint64_t qdesc = smem_desc(smem_u32(qs), 16, 1024);

    // this thread's rows: r_wg + 16 warp + g (+ 8); row i sees [0, lim[i])
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_wg + 16 * warp + g + 8 * i;
      lim[i] = r < GT ? min(base + r / G + 1, a.S) : 0;
    }
    // a tile ending at or below the first token's limit needs no mask
    const int lim_full = min(base + r_wg / G + 1, a.S);
    float o[HALVES][32];  // dims 64 h + 8 n + 2 t4 + e at o[h][4 n + 2 i + e]
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int n = 0; n < 32; ++n) o[hf][n] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float s[NS];
    uint32_t pa[BN / 16][4];  // P as the P.V product's A fragments
    auto stage = [&](int i) { return sbase + BF_OFF + (i % BF_STAGES) * BF_STAGE; };
    // k16 step kk reads column half kk / 4 of Q and of K, 32 bytes on per
    // step inside it
    auto issue_qk = [&](int i) {
      const uint64_t kdesc = smem_desc(stage(i), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t qa = qdesc + (kk >> 2) * (Gm::Q_HALF >> 4) + 2 * (kk & 3);
        const uint64_t kb = kdesc + (kk >> 2) * (HALF >> 4) + 2 * (kk & 3);
        if constexpr (BN == 128)
          wgmma_qk(s, qa, kb, kk);
        else
          wgmma_qk64(s, qa, kb, kk);
      }
      wgmma_commit();
    };
    // each column half of V into its half of O
    auto issue_pv = [&](int i) {
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        const uint64_t vdesc = smem_desc(stage(i) + BF_TILE + hf * HALF, 1024, 1024);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv(o[hf], pa[kk], vdesc + 128 * kk);
      }
      wgmma_commit();
    };
    auto scales = [&](int i) {
      return reinterpret_cast<const float*>(smem + (stage(i) - sbase) + 2 * BF_TILE) +
             t4 * SC_LD;
    };
    auto softmax = [&](int i) {
      if (i * BN + BN > lim_full)
        softmax_tile<HD, true, Q8>(s, scales(i), i * BN, lim, t4, m, l, corr);
      else
        softmax_tile<HD, false, Q8>(s, scales(i), i * BN, lim, t4, m, l, corr);
    };
    for (int i = 0; i < ntiles; ++i) {
      mbar_wait(bf_full + 8 * (i % BF_STAGES), (i / BF_STAGES) & 1);
      wgmma_fence();
      issue_qk(i);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(i);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[hf][4 * n] *= corr[0];
          o[hf][4 * n + 1] *= corr[0];
          o[hf][4 * n + 2] *= corr[1];
          o[hf][4 * n + 3] *= corr[1];
        }
      pack_p<HD, Q8>(s, scales(i) + SC_FLOATS, pa);
      wgmma_fence();
      issue_pv(i);
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) fence_regs(o[hf]);
      mbar_arrive(bf_empty + 8 * (i % BF_STAGES));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = r_wg + 16 * warp + g + 8 * i;
      if (r >= GT) continue;
      const int t = r / G, gq = r % G;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* op = a.out + (((size_t)b * a.T + t) * a.Hq + h * G + gq) * HD + 2 * t4;
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(op + 64 * hf + 8 * n) =
              __floats2bfloat162_rn(o[hf][4 * n + 2 * i] * inv, o[hf][4 * n + 2 * i + 1] * inv);
    }
  }
}

// ---- host side ----------------------------------------------------------------

// A map over `planes` planes of `rows` rows of `cols` bytes, box {HD, BN,
// 1} of the instance of head dim HD, encoded once per (pointer, shape) and
// instance.
template <int HD>
static CUresult rows_map(CUtensorMap* map, const void* ptr, int cols, int rows, int planes) {
  return cached_map(map, std::make_tuple(ptr, cols, rows, planes), [&](CUtensorMap* m) {
    return encode_3d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 1, cols, rows, planes, HD,
                     Geo<HD>::BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  });
}

// The same over bf16 values, the 128-byte swizzle the consumers' wgmma
// reads (head dim 64: a box is one 128-byte row of 64 values).
template <int HD>
static CUresult bf16_rows_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                              int planes) {
  return cached_map(map, std::make_tuple(ptr, cols, rows, planes), [&](CUtensorMap* m) {
    return encode_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 2, cols, rows, planes, HD,
                     Geo<HD>::BN, CU_TENSOR_MAP_SWIZZLE_128B);
  });
}

template <int FMT, bool BFS = false, int HD = 64>
static int prefill(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* k_new, const void* v_new, const void* ks_new,
                   const void* vs_new, const void* base_lens, void* out, int layer, int B, int S,
                   int T, int Hq, int Hkv, int hd, cudaStream_t st) {
  constexpr bool Q8 = FMT != kBF16;
  if (hd != HD || Hkv < 1 || Hq % Hkv != 0 || (FMT == kI4 && Hkv % 2 != 0) || B < 1 || S < 1 ||
      T < 1 || layer < 0 || (k_new == nullptr) != (v_new == nullptr) ||
      (Q8 && (k_new == nullptr) != (ks_new == nullptr)))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Geo<HD>::smem(FMT);
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_sm90_kernel<FMT, BFS, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  Args a;
  a.Kw = FMT == kI4 ? (Hkv / 2) * HD : Hkv * HD;
  const int elem = Q8 ? 1 : 2;
  const size_t layer_bytes = (size_t)B * S * a.Kw * elem;
  a.k = static_cast<const uint8_t*>(k) + (size_t)layer * layer_bytes;
  a.v = static_cast<const uint8_t*>(v) + (size_t)layer * layer_bytes;
  CUresult (*const map)(CUtensorMap*, const void*, int, int, int) =
      Q8 ? &rows_map<HD> : &bf16_rows_map<HD>;
  CUresult enc = map(&a.kmap, a.k, a.Kw, S, B);
  if (enc == CUDA_SUCCESS) enc = map(&a.vmap, a.v, a.Kw, S, B);
  if (enc == CUDA_SUCCESS && k_new != nullptr) enc = map(&a.knmap, k_new, a.Kw, T, B);
  if (enc == CUDA_SUCCESS && v_new != nullptr) enc = map(&a.vnmap, v_new, a.Kw, T, B);
  if (enc != CUDA_SUCCESS) return kEncodeError + (int)enc;
  if (k_new == nullptr) a.knmap = a.vnmap = a.kmap;  // never read
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const uint8_t*>(k_new);
  a.v_new = static_cast<const uint8_t*>(v_new);
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.ks_new = ks_new;
  a.vs_new = vs_new;
  a.base_lens = static_cast<const int*>(base_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  const int rows = (Hq / Hkv) * T;
  dim3 grid((rows + BM - 1) / BM, Hkv, B);
  prefill_sm90_kernel<FMT, BFS, HD><<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace pfa
}  // namespace md

// K2: q [B, T, Hq, 64] bf16; k/v bf16 [L, B, S, Hkv*64]; k_new/v_new bf16
// [B, T, Hkv*64], or both null; base_lens [B]; out [B, T, Hq, 64].  Returns
// cudaGetLastError(), or 0x10000 + the CUresult of a failed tensor-map
// encode.
extern "C" int md_prefill_attend(const void* q, const void* k, const void* v, const void* k_new,
                                 const void* v_new, const void* base_lens, void* out, int layer,
                                 int B, int S, int T, int Hq, int Hkv, int hd, void* stream) {
  return md::pfa::prefill<md::pfa::kBF16>(q, k, v, nullptr, nullptr, k_new, v_new, nullptr,
                                          nullptr, base_lens, out, layer, B, S, T, Hq, Hkv, hd,
                                          static_cast<cudaStream_t>(stream));
}

// K2q: q [B, T, Hq, 64] bf16; k/v int8 [L, B, S, Hkv*64] with f32 scales
// k_scale/v_scale [L, B, Hkv, S]; k_new/v_new [B, T, Hkv*64] and
// ks_new/vs_new [B, Hkv, T], or all four null; base_lens [B]; out [B, T, Hq,
// 64].  Returns as md_prefill_attend.
extern "C" int md_prefill_attend_quant(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* k_new, const void* v_new,
                                       const void* ks_new, const void* vs_new,
                                       const void* base_lens, void* out, int layer, int B,
                                       int S, int T, int Hq, int Hkv, int hd, void* stream) {
  return md::pfa::prefill<md::pfa::kI8>(q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                                        base_lens, out, layer, B, S, T, Hq, Hkv, hd,
                                        static_cast<cudaStream_t>(stream));
}

// B11: as md_prefill_attend_quant over packed int4 k/v [L, B, S, (Hkv/2)*64]
// (+ k_new/v_new [B, T, (Hkv/2)*64]); Hkv must be even.
extern "C" int md_prefill_attend_quant4(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* k_new, const void* v_new,
                                        const void* ks_new, const void* vs_new,
                                        const void* base_lens, void* out, int layer, int B,
                                        int S, int T, int Hq, int Hkv, int hd, void* stream) {
  return md::pfa::prefill<md::pfa::kI4>(q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                                        base_lens, out, layer, B, S, T, Hq, Hkv, hd,
                                        static_cast<cudaStream_t>(stream));
}

// B11 at head dim 128: as md_prefill_attend_quant4, with q [B, T, Hq,
// 128], k/v [L, B, S, (Hkv/2)*128] and out [B, T, Hq, 128] (f32 scales).
extern "C" int md_prefill_attend_quant4_hd128(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* k_new, const void* v_new,
                                              const void* ks_new, const void* vs_new,
                                              const void* base_lens, void* out, int layer,
                                              int B, int S, int T, int Hq, int Hkv, int hd,
                                              void* stream) {
  return md::pfa::prefill<md::pfa::kI4, false, 128>(q, k, v, k_scale, v_scale, k_new, v_new,
                                                    ks_new, vs_new, base_lens, out, layer, B, S,
                                                    T, Hq, Hkv, hd,
                                                    static_cast<cudaStream_t>(stream));
}

// K2q and B11 over bf16 scales (k_scale/v_scale and ks_new/vs_new bf16),
// the arguments otherwise md_prefill_attend_quant{,4}'s.
extern "C" int md_prefill_attend_quant_bf16s(const void* q, const void* k, const void* v,
                                             const void* k_scale, const void* v_scale,
                                             const void* k_new, const void* v_new,
                                             const void* ks_new, const void* vs_new,
                                             const void* base_lens, void* out, int layer,
                                             int B, int S, int T, int Hq, int Hkv, int hd,
                                             void* stream) {
  return md::pfa::prefill<md::pfa::kI8, true>(q, k, v, k_scale, v_scale, k_new, v_new, ks_new,
                                              vs_new, base_lens, out, layer, B, S, T, Hq, Hkv,
                                              hd, static_cast<cudaStream_t>(stream));
}

extern "C" int md_prefill_attend_quant4_bf16s(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* k_new, const void* v_new,
                                              const void* ks_new, const void* vs_new,
                                              const void* base_lens, void* out, int layer,
                                              int B, int S, int T, int Hq, int Hkv, int hd,
                                              void* stream) {
  return md::pfa::prefill<md::pfa::kI4, true>(q, k, v, k_scale, v_scale, k_new, v_new, ks_new,
                                              vs_new, base_lens, out, layer, B, S, T, Hq, Hkv,
                                              hd, static_cast<cudaStream_t>(stream));
}

// The decode / verify attention kernels on Hopper: K1 over the bf16 cache
// (the blocked target call and the whole-row draft call), K1q over an int8
// cache, B10 over an int4 cache packed in head pairs, and B12's paged twins
// of all three.
//
// Replaces magicdec_tpu/ops/pallas/decode_attention.py flash_decode_attend
// (:505; the blocked _decode_call :387 with _decode_kernel :84, the
// whole-row _whole_row_call :497 with _whole_row_kernel :395),
// flash_decode_attend_quant (:547; _decode_quant_kernel :171,
// _quant_online_update :150) over an int8 cache, flash_decode_attend_quant4
// (:585; _decode_quant4_kernel :255, _unpack_int4_planes :241) over an int4
// cache packed in head pairs, and paged_attention.py
// flash_paged_decode_attend (:122), flash_paged_decode_attend_quant (:147)
// and flash_paged_decode_attend_quant4 (:176) (_paged_call :109) over page
// pools of each, at head dim 64 (every instance) and 128 (the int4 ones).  A window of T <= 16 query tokens of request b attends
// layer `layer`'s cache rows [0, base_b) (quantized: each with its f32
// per-(token, kv head) k and v scale, f32 or bf16) plus, when given, its own T fresh
// rows, read at their positions [base_b, base_b + T) (causal: token t sees
// positions [0, base_b + t + 1)).  The numerics are the TPU kernel's
// (attention_common.cuh): the score is s_raw * 1/sqrt(hd) (quantized:
// times k_scale[c]) (here in the exp2 domain, times log2 e), masked to -1e30
// after scaling; the running max starts at -1e30; l sums the (unscaled) p;
// P.V takes bf16(p) (quantized: bf16(p * v_scale[c])); the output is acc /
// max(l, 1e-30).
//
// Bound: HBM bytes (a visible row is HD bf16 values of k and of v a head,
// HD int8 bytes, or HD/2 packed, plus 4 (bf16: 2) bytes of scale each; the
// flops a byte are ~G*T).  The earlier one-warp design (blocks walking 32-row
// tiles, two cp.async stages, the quantized rows converted to bf16 in
// shared memory between two block barriers) ran K1 at 77%, K1q at 47% and
// B10 at 25% of that bound, B12 at 28% over 16 ragged slots (H100 80GB HBM3,
// 700 W; PERF.md).  This design:
//
// - Four warps a block, each with its own ring.  A block serves one (split
//   of the positions, request, kv head or pair, run of grouped query rows);
//   the split is walked in 16-position tiles, tile j by warp j % 4, each
//   warp through a ring of its own three stages, two tiles in flight: no
//   block barrier in the loop.  The four warps merge their (m, l, o)
//   through shared memory in warp order at the end.
// - bf16 (K1, B12's bf16 pool): a block a kv head, 128 bytes a position
//   (on the H100 at 700 W, the int8 kernel's 64-byte rows streamed at ~3/4
//   the rate, 128-byte rows at full rate; a pair's rings would take twice
//   the shared memory and halve the blocks an SM).  The tiles land in
//   TMA's 128-byte swizzle (16-byte chunk c of position r at c ^ r % 8), so
//   ldmatrix reads K as mma B fragments and ldmatrix.trans reads V, free of
//   bank conflicts, with no conversion.
//   A tile wholly below both the visible end and base (the first fresh
//   position) is two TMA boxes {64 dims, 16 positions} of the layer's cache
//   (paged: of the page that holds the tile, when the page size is a
//   multiple of 16), landed on the stage's mbarrier: one instruction a
//   tile, no per-lane address arithmetic.  The tile straddling base, the
//   fresh rows and the block's last tile take cp.async per 16-byte chunk,
//   with zeros past the visible end (a masked p of 0 times an inf or NaN V
//   row would be NaN in the product); so does every tile of a pool whose
//   pages are not multiples of 16 rows, each chunk through its page.  A warp
//   holds MT = 1..3 row tiles of 16 grouped query rows (Q as A fragments,
//   each tile's (m, l, o) in registers), so up to 48 rows (T <= 12 at G =
//   4) take one pass over the cache; more rows take a block per 48.
// - int8 / int4 (K1q, B10, B12's quantized pools): a block a pair of kv
//   heads: int8, the pair's 128 contiguous bytes a position; B10 the packed
//   pair's 64, each warp converting both nibble planes of the words it
//   loads, so a packed byte is read from HBM and shared memory once.  An
//   odd Hkv (int8) takes one head a block.  The tile stays in shared memory
//   as it landed (HD bytes a position at a stride of HD + 16, so ldmatrix is
//   free of bank conflicts).  ldmatrix of the bytes as 16-bit pairs gives
//   each lane four bytes of one position (K: dims d..d+3) and ldmatrix.trans
//   four bytes of two positions and two dims (V: (2t4, 2g), (2t4, 2g+1),
//   (2t4+1, 2g), (2t4+1, 2g+1)).  Bytes 0 and 2 and bytes 1 and 3 of such a
//   word are exactly the pairs an m16n8k16 B fragment register holds: for V
//   the two positions of one dim, for K two dims of one position once the
//   head dims of each 16-dim step are permuted (slots 2t4, 2t4+1, 2t4+8,
//   2t4+9 <- dims d, d+2, d+1, d+3, Q's A fragments loaded in the same
//   order).  Each pair converts exactly without the conversion unit
//   (i8_pair: two logic ops and a bf16x2 subtraction; i4_pair: one) and
//   feeds the tensor cores directly, and the output dims come out in the
//   permuted order the epilogue undoes.  The rows and scales are copied per
//   16-byte chunk (4-byte per scale) by cp.async.
// - bf16 scales (BFS: the JAX package's kv_scale_dtype=bf16, magicdec_tpu/
//   ops/pallas/decode_attention.py:150-153): the stage keeps them as they
//   are stored, 2 bytes a position, and each is widened to f32 exactly as it
//   is read from shared memory, so all arithmetic is the f32 instance's and
//   a launch on bf16 scales gives the bits of one on f32 scales holding the
//   widened values.  cp.async copies at least 4 bytes: a tile of cache rows
//   takes its scales as 4-byte pairs of positions (a tile starts at a
//   multiple of 16, so a pair is aligned when a scale row, S positions or a
//   page's ps, has an even length); a tile that holds the visible end or
//   fresh rows (whose window may start at an odd position), or any tile of
//   an odd-length row, loads each position's scale by a plain 2-byte load
//   and stores it, zero past the visible end.
// - The softmax runs in the exp2 domain (log2 e folded into the score's
//   scale) and skips the masks on a tile every row of the warp sees whole.
// - Head dim 128 (QD = 128: B10 and B12's int4 pool, the 8B target's int4
//   cache; f32 scales): the packed pair's row is 128 bytes; a warp holds
//   both heads' output (128 registers a thread), so the Q fragments live
//   in shared memory (warp 0 writes them, each warp reads 16 bytes a lane a
//   16-dim step), K takes two ldmatrix per 8 positions and V four blocks of
//   32 dims; the launch bound asks for two blocks an SM and
//   quant_split_plan aims at two.  Head dim 64 keeps its registers and code.
//
// Splits: kernels/decode_attention.py split_plan (bf16) and
// quant_split_plan, functions of (B, Hkv, S) only; with more than one split
// a block writes its (o, m, l) partial and combine_kernel
// (attention_common.cuh) merges, for each row, the splits below its visible
// end (a bf16 block with no visible position exits at once and writes
// nothing).  Which positions go to which split, warp and tile, and in which
// order, depend on static shapes alone, never on T, on the lengths or on
// the query rows, and each row's arithmetic is the same whatever rows share
// its warp, so a verify row and the same token's autoregressive step give
// the same bits.  PAGED: only a row's address changes (RowAddr, or the TMA
// box's page), so a paged launch equals the contiguous launch over the
// gathered pool bit for bit.
#include <tuple>
#include <type_traits>

#include "attention_common.cuh"
#include "sm90_common.cuh"

namespace md {
namespace dq90 {
namespace {  // internal linkage: a second build of this file loads beside it

using sm90::fence_proxy_async;
using sm90::ldsm_x4_trans_u32;
using sm90::ldsm_x4_u32;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_3d;

constexpr int kI8 = 0, kI4 = 1, kBF16 = 2;  // the cache formats
constexpr int HD = 64;     // the head dim of the bf16 instances (the quantized: QD)
constexpr int NR = 16;     // positions a warp tile
constexpr int NW = 4;      // warps a block
constexpr int STAGES = 3;  // each warp's ring
constexpr int MT_MAX = 3;  // bf16: 16-row tiles of query rows a warp holds

// A scale at rest: f32, or bf16 kept as its 16 bits (BFS).
template <bool BFS>
using ScaleT = std::conditional_t<BFS, uint16_t, float>;

// One stage of a warp's ring: the k and v bytes of NR positions (RB bytes a
// position: the block's HEADS int8 heads side by side, or one packed pair,
// at a stride of RB + 16 so that ldmatrix is free of bank conflicts) and
// their scales as stored (f32, or bf16 with BFS); QD: the head dim.
template <bool INT4, int HEADS, bool BFS, int QD>
struct Stage {
  static constexpr int RB = INT4 ? QD : HEADS * QD;
  static constexpr int LDB = RB + 16;
  int8_t k[NR * LDB];
  int8_t v[NR * LDB];
  ScaleT<BFS> ks[HEADS][NR];
  ScaleT<BFS> vs[HEADS][NR];
};

// The rings, and after the loop the four warps' states for the merge.
template <bool INT4, int HEADS, bool BFS, int QD>
union Smem {
  Stage<INT4, HEADS, BFS, QD> ring[NW][STAGES];
  struct {
    float o[NW][HEADS][16][QD];
    float ml[NW][HEADS][16][2];
  } merge;
};

// Head dim 128 keeps the Q fragments in shared memory past the Smem union
// (HEADS x QD/16 x 32 lanes of 16 bytes: a warp's registers cannot hold
// them beside the output of two heads); head dim 64 keeps them in
// registers.
template <int HEADS, int QD>
constexpr int QSM_BYTES = QD > 64 ? HEADS * (QD / 16) * 32 * 16 : 0;
template <bool INT4, int HEADS, bool BFS, int QD>
constexpr int QUANT_SMEM = sizeof(Smem<INT4, HEADS, BFS, QD>) + QSM_BYTES<HEADS, QD>;

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// (a & b) op c in one logic op (the compiler splits it when b and c are
// both immediates, so the constants ride in registers).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The scales of positions p and p + 1 (p even) from a stage, widened to f32
// exactly (a bf16 is the high half of its f32).
__device__ __forceinline__ float2 scale_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 scale_pair(const uint16_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

// The conversion constants, held in registers.
struct Consts {
  uint32_t k7, ks, kb, m4, b4;
};

// Bytes 0 and 2 of w (signed int8) -> bf16x2 {byte 0, byte 2}, exactly:
// with low7 = v & 0x7F and sign = v & 0x80, bf16 0x4300 | low7 reads 128 +
// low7 and 0x4300 | sign reads 128 or 256, so their difference is v.
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, const Consts& c) {
  return bf16x2_sub(and_or(w, c.k7, c.kb), and_or(w, c.ks, c.kb));
}

// The low nibbles of bytes 0 and 2 of w (signed int4) -> bf16x2, exactly: a
// nibble with its bit 3 flipped is v + 8 in [0, 15], 0x4300 | (v + 8) reads
// 136 + v, and 136 (0x4308) is subtracted.
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, const Consts& c) {
  return bf16x2_sub(and_xor(w, c.m4, c.b4), c.b4);
}

// The B fragment pair {even, odd} of word w: bytes {0, 2} and {1, 3} of
// the int8 word, or of the `plane` nibbles of the packed word.
template <bool INT4>
__device__ __forceinline__ void pairs(uint32_t w, int plane, const Consts& c, uint32_t& even,
                                      uint32_t& odd) {
  if constexpr (INT4) {
    even = i4_pair(w >> (4 * plane), c);
    odd = i4_pair(w >> (8 + 4 * plane), c);
  } else {
    even = i8_pair(w, c);
    odd = i8_pair(w >> 8, c);
  }
}

// The quantized body (K1q, B10, B12's int8 / int4 pools), HEADS kv heads a
// block: INT4, the packed pair; int8, a pair of heads (one when Hkv is odd),
// so that a block reads 128 contiguous bytes a position; one 16-row tile of
// grouped query rows; BFS: bf16 scales; QD: the head dim (64, or 128 with
// the Q fragments in shared memory, QSM).
template <bool INT4, int HEADS, bool PAGED, bool BFS, int QD>
__device__ __forceinline__ void quant_body(const AttnArgs& a, int R, unsigned char* dq_smem) {
  static_assert(HEADS == 2 || (!INT4 && HEADS == 1), "a packed row holds a pair of heads");
  static_assert(QD == 64 || QD == 128, "head dim 64 or 128");
  using St = Stage<INT4, HEADS, BFS, QD>;
  using SC = ScaleT<BFS>;
  constexpr int LDB = St::LDB;
  constexpr int CH = St::RB / 16;  // 16-byte chunks of a position
  constexpr int PPI = 32 / CH;     // positions one copy instruction of a warp covers
  constexpr bool QSM = QSM_BYTES<HEADS, QD> > 0;
  Smem<INT4, HEADS, BFS, QD>& sm = *reinterpret_cast<Smem<INT4, HEADS, BFS, QD>*>(dq_smem);
  uint4* qsm = reinterpret_cast<uint4*>(dq_smem + sizeof(sm));  // QSM: [HEADS][QD/16][32]

  const int b = blockIdx.z;
  const int rb = blockIdx.x / a.nsplit, split = blockIdx.x % a.nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  const int h0 = blockIdx.y * HEADS;  // the block's first kv head
  const int K = INT4 ? (a.Hkv / 2) * QD : a.Hkv * QD;  // a cache row's bytes
  const int lane_off = blockIdx.y * St::RB;  // the block's bytes in a row
  const int base = a.base_lens[b];
  const bool fresh = a.kq_new != nullptr;
  const int r_block = rb * 16;
  // 1/sqrt(hd), times log2(e): the softmax runs in the exp2 domain
  const float scale = 1.f / sqrtf((float)QD) * 1.4426950408889634f;

  const int t_last = min((r_block + 15) / G, a.T - 1);
  const int hi = min(base + t_last + 1, a.S);
  const int lo = split * a.chunk;
  const int hi_s = min(hi, lo + a.chunk);
  // positions [0, lim) visible to the thread's rows g and g + 8; a padding
  // row (past G*T, never written) sees the block's whole range, so that the
  // tiles every row sees whole take the softmax without masks
  int lim[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_block + g + 8 * i;
    valid[i] = row < GT;
    lim[i] = valid[i] ? min(base + row / G + 1, hi_s) : hi_s;
  }
  const int lim_min = min(lim[0], lim[1]);

  // Q as A fragments, the dims of each 16-dim step in the order (d, d+2 |
  // d+1, d+3) of the converted K pairs (QSM: warp 0's, in shared memory,
  // lane-major; every warp of the block holds the same rows)
  uint32_t qf[QSM ? 1 : HEADS][QSM ? 1 : QD / 16][4];
  if (!QSM || warp == 0) {
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh)
#pragma unroll
      for (int mi = 0; mi < QD / 16; ++mi) {
        uint32_t f[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r_block + g + 8 * i, t = row / G, gq = row % G;
          uint2 qv = make_uint2(0u, 0u);
          if (valid[i])
            qv = *reinterpret_cast<const uint2*>(
                a.q + (((size_t)b * a.T + t) * a.Hq + (h0 + hh) * G + gq) * QD + 16 * mi +
                4 * t4);
          f[i] = __byte_perm(qv.x, qv.y, 0x5410);
          f[i + 2] = __byte_perm(qv.x, qv.y, 0x7632);
        }
        if constexpr (QSM) {
          qsm[(hh * (QD / 16) + mi) * 32 + lane] = make_uint4(f[0], f[1], f[2], f[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) qf[hh][mi][i] = f[i];
        }
      }
  }
  if constexpr (QSM) __syncthreads();  // warp 0's fragments are every warp's
  float o[HEADS][QD / 8][4];
  float m[HEADS][2], l[HEADS][2];
#pragma unroll
  for (int hh = 0; hh < HEADS; ++hh) {
#pragma unroll
    for (int n = 0; n < QD / 8; ++n) o[hh][n][0] = o[hh][n][1] = o[hh][n][2] = o[hh][n][3] = 0.f;
    m[hh][0] = m[hh][1] = kNegInf;
    l[hh][0] = l[hh][1] = 0.f;
  }
  const Consts cs{0x007F007Fu, 0x00800080u, 0x43004300u, 0x000F000Fu, 0x43084308u};

  const RowAddr<int8_t, PAGED> krows = kv_rows<int8_t, PAGED>(a, a.kq, b, K, lane_off);
  const RowAddr<int8_t, PAGED> vrows = kv_rows<int8_t, PAGED>(a, a.vq, b, K, lane_off);
  // a lane copies the k scales (lanes 0-15) or the v scales (16-31)
  const bool is_v = lane >= 16;
  RowAddr<SC, PAGED> srows[HEADS];
  const SC* sfresh[HEADS];
#pragma unroll
  for (int hh = 0; hh < HEADS; ++hh) {
    srows[hh] = scale_rows<SC, PAGED>(a, static_cast<const SC*>(is_v ? a.v_scale : a.k_scale),
                                      b, h0 + hh);
    const size_t sn = ((size_t)b * a.Hkv + h0 + hh) * a.T;
    sfresh[hh] = fresh ? static_cast<const SC*>(is_v ? a.vs_new : a.ks_new) + sn : nullptr;
  }
  // bf16: a tile of cache rows copies its scales as aligned 4-byte pairs of
  // positions when every scale row has an even length
  const bool pairs_ok = !BFS || (PAGED ? a.ps % 2 == 0 : a.S % 2 == 0);
  const size_t f_off = (size_t)b * a.T * K + lane_off;
  const int8_t* kqn = fresh ? a.kq_new + f_off : nullptr;
  const int8_t* vqn = fresh ? a.vq_new + f_off : nullptr;
  const int fresh_at = fresh ? base : a.S;  // the first position read from the fresh rows

  // Copy the tile at position c into stage st of this warp's ring: each lane
  // 16-byte chunks of k and of v (chunk lane % CH of positions lane / CH +
  // PPI i) and the scales of position lane % 16 (k for lanes 0-15, v for
  // 16-31) of each head (bf16, a tile of cache rows: positions 2 (lane % 8)
  // and + 1, lanes 0-7 and 16-23); zeros past hi_s, where nothing is read.
  auto issue = [&](int st, int c) {
    St& s = sm.ring[warp][st];
    if (c + NR <= min(hi_s, fresh_at) && pairs_ok) {  // cache rows only, all read
#pragma unroll
      for (int i = 0; i < NR / PPI; ++i) {
        const int r = lane / CH + PPI * i, c16 = 16 * (lane % CH);
        cp_async16(s.k + r * LDB + c16, krows(c + r) + c16, true);
        cp_async16(s.v + r * LDB + c16, vrows(c + r) + c16, true);
      }
      if constexpr (BFS) {
        if ((lane & 15) < NR / 2) {
          const int r = 2 * (lane & 7);
#pragma unroll
          for (int hh = 0; hh < HEADS; ++hh)
            cp_async4((is_v ? s.vs[hh] : s.ks[hh]) + r, srows[hh](c + r), true);
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < HEADS; ++hh)
          cp_async4((is_v ? s.vs[hh] : s.ks[hh]) + (lane & 15), srows[hh](c + (lane & 15)), true);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < NR / PPI; ++i) {
      const int r = lane / CH + PPI * i, c16 = 16 * (lane % CH), pos = c + r;
      const bool ok = pos < hi_s;
      const bool cached = pos < fresh_at;
      const size_t f = (size_t)(pos - fresh_at) * K + c16;  // its fresh row's chunk
      const int8_t* ks = !ok ? a.kq : cached ? krows(pos) + c16 : kqn + f;
      const int8_t* vs = !ok ? a.vq : cached ? vrows(pos) + c16 : vqn + f;
      cp_async16(s.k + r * LDB + c16, ks, ok);
      cp_async16(s.v + r * LDB + c16, vs, ok);
    }
    const int r = lane & 15, pos = c + r;
    const bool ok = pos < hi_s, cached = pos < fresh_at;
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh) {
      const SC* src = !ok ? static_cast<const SC*>(a.k_scale)
                          : cached ? srows[hh](pos) : sfresh[hh] + (pos - fresh_at);
      if constexpr (BFS)  // one position's 2 bytes: a plain load, seen after __syncwarp
        (is_v ? s.vs[hh] : s.ks[hh])[r] = ok ? __ldg(src) : (uint16_t)0;
      else
        cp_async4((is_v ? s.vs[hh] : s.ks[hh]) + r, src, ok);
    }
  };

  const int ntiles = hi_s > lo ? (hi_s - lo + NR - 1) / NR : 0;
  const int mine = ntiles > warp ? (ntiles - warp + NW - 1) / NW : 0;  // tiles warp, warp + NW, ...
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < mine) issue(st, lo + (warp + st * NW) * NR);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of tile `it` have landed
    __syncwarp();                 // every lane's; and tile it - 1's reads are done
    if (it + STAGES - 1 < mine)
      issue((it + STAGES - 1) % STAGES, lo + (warp + (it + STAGES - 1) * NW) * NR);
    cp_async_commit();
    const St& s = sm.ring[warp][it % STAGES];
    const int c0 = lo + (warp + it * NW) * NR;

    // S of each head.  K words (ldmatrix j (and hq, the 64 dims), register
    // mi): positions 8j..8j+7, dims 16mi..16mi+15 of the head (int4: of the
    // pair)
    float sc[HEADS][2][4];
    uint32_t w[QD / 32][QD / 16];  // K: [j][mi]; V (below): [D][0..3]
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh) {
      if (!INT4 || hh == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hq = 0; hq < QD / 64; ++hq)
            ldsm_x4(w[j] + 4 * hq, reinterpret_cast<const __nv_bfloat16*>(
                                       s.k + (INT4 ? 0 : hh * QD) + (8 * j + (lane & 7)) * LDB +
                                       64 * hq + 16 * (lane >> 3)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[hh][j][0] = sc[hh][j][1] = sc[hh][j][2] = sc[hh][j][3] = 0.f;
#pragma unroll
      for (int mi = 0; mi < QD / 16; ++mi) {
        uint32_t qa[4];
        if constexpr (QSM) {
          const uint4 qv = qsm[(hh * (QD / 16) + mi) * 32 + lane];
          qa[0] = qv.x, qa[1] = qv.y, qa[2] = qv.z, qa[3] = qv.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[hh][mi][i];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b0, b1;
          pairs<INT4>(w[j][mi], hh, cs, b0, b1);
          mma_bf16_16816(sc[hh][j], qa, b0, b1);
        }
      }
    }

    // The online softmax of each head (sc[hh][j][e]: row g + 8 (e >> 1),
    // position c0 + 8 j + 2 t4 + (e & 1)), in the exp2 domain (scores and
    // the running max times log2 e); P as the A fragment, bf16(p * v_scale)
    // as the reference.  A tile every row sees whole skips the masks (the
    // same arithmetic, so the bits do not depend on which rows share it).
    const bool whole = __all_sync(0xffffffffu, c0 + NR <= lim_min);
    uint32_t pa[HEADS][4];
    float corr[HEADS][2];
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh) {
      const float2 kf[2] = {scale_pair(s.ks[hh] + 2 * t4), scale_pair(s.ks[hh] + 8 + 2 * t4)};
      const float2 vf[2] = {scale_pair(s.vs[hh] + 2 * t4), scale_pair(s.vs[hh] + 8 + 2 * t4)};
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float f = (e & 1 ? kf[j].y : kf[j].x) * scale;
          const float x =
              whole || c0 + 8 * j + 2 * t4 + (e & 1) < lim[i] ? sc[hh][j][e] * f : kNegInf;
          sc[hh][j][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[hh][i], mx[i]);
        corr[hh][i] = ex2(m[hh][i] - m_new);
        m[hh][i] = m_new;
        l[hh][i] *= corr[hh][i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = whole || c0 + 8 * j + 2 * t4 + (e & 1) < lim[i]
                              ? ex2(sc[hh][j][e] - m[hh][i])
                              : 0.f;
          sc[hh][j][e] = p;
          l[hh][i] += p;
        }
      pa[hh][0] = pack_bf16x2(sc[hh][0][0] * vf[0].x, sc[hh][0][1] * vf[0].y);
      pa[hh][1] = pack_bf16x2(sc[hh][0][2] * vf[0].x, sc[hh][0][3] * vf[0].y);
      pa[hh][2] = pack_bf16x2(sc[hh][1][0] * vf[1].x, sc[hh][1][1] * vf[1].y);
      pa[hh][3] = pack_bf16x2(sc[hh][1][2] * vf[1].x, sc[hh][1][3] * vf[1].y);
    }
    bool rescale = false;
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh) rescale |= corr[hh][0] != 1.f || corr[hh][1] != 1.f;
    if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
      for (int hh = 0; hh < HEADS; ++hh)
#pragma unroll
        for (int n = 0; n < QD / 8; ++n) {
          o[hh][n][0] *= corr[hh][0];
          o[hh][n][1] *= corr[hh][0];
          o[hh][n][2] *= corr[hh][1];
          o[hh][n][3] *= corr[hh][1];
        }
    }

    // O += P V.  V words (ldmatrix.trans D, register 2 h2 + k): positions
    // 8k..8k+7, dims 32D + 16 h2 .. + 15; n-block 4D + 2h2 (+1) holds dims
    // 32D + 16h2 + 2n (+1) for its column n
#pragma unroll
    for (int hh = 0; hh < HEADS; ++hh)
#pragma unroll
      for (int D = 0; D < QD / 32; ++D) {
        if (!INT4 || hh == 0)
          ldsm_x4_trans(w[D], reinterpret_cast<const __nv_bfloat16*>(
                                  s.v + (INT4 ? 0 : hh * QD) +
                                  ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB + 32 * D +
                                  16 * (lane >> 4)));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t e0, o0, e1, o1;
          pairs<INT4>(w[D][2 * h2], hh, cs, e0, o0);
          pairs<INT4>(w[D][2 * h2 + 1], hh, cs, e1, o1);
          mma_bf16_16816(o[hh][4 * D + 2 * h2], pa[hh], e0, e1);
          mma_bf16_16816(o[hh][4 * D + 2 * h2 + 1], pa[hh], o0, o1);
        }
      }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < HEADS; ++hh)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[hh][i] += __shfl_xor_sync(0xffffffffu, l[hh][i], 1);
      l[hh][i] += __shfl_xor_sync(0xffffffffu, l[hh][i], 2);
    }

  // Merge the four warps' states, in warp order.  o[hh][4D + k][e] is row
  // g + 8 (e >> 1), dim 32D + 16 (k >> 1) + 4 t4 + 2 (e & 1) + (k & 1).
  __syncthreads();  // every warp's ring is idle: the shared memory is the merge's
#pragma unroll
  for (int hh = 0; hh < HEADS; ++hh) {
#pragma unroll
    for (int D = 0; D < QD / 32; ++D)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.merge.o[warp][hh][g + 8 * (e >> 1)][32 * D + 16 * (k >> 1) + 4 * t4 + 2 * (e & 1) +
                                                 (k & 1)] = o[hh][4 * D + k][e];
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.merge.ml[warp][hh][g + 8 * i][0] = m[hh][i];
        sm.merge.ml[warp][hh][g + 8 * i][1] = l[hh][i];
      }
    }
  }
  __syncthreads();
  const size_t part_base = ((size_t)b * a.Hkv + h0) * a.nsplit + split;
  for (int item = threadIdx.x; item < HEADS * 16 * (QD / 8); item += NW * 32) {
    const int hh = item / (16 * (QD / 8)), row = (item / (QD / 8)) % 16, d0 = 8 * (item % (QD / 8));
    const int gr = r_block + row;
    if (gr >= GT) continue;
    float mw[NW], mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mw[w] = sm.merge.ml[w][hh][row][0];
      mm = fmaxf(mm, mw[w]);
    }
    float ll = 0.f, acc[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = ex2(mw[w] - mm);
      ll += sm.merge.ml[w][hh][row][1] * c;
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] += sm.merge.o[w][hh][row][d0 + d] * c;
    }
    if (a.nsplit == 1) {
      const int t = gr / G, gq = gr % G;
      const float inv = 1.f / fmaxf(ll, 1e-30f);
      uint4 v;
      v.x = pack_bf16x2(acc[0] * inv, acc[1] * inv);
      v.y = pack_bf16x2(acc[2] * inv, acc[3] * inv);
      v.z = pack_bf16x2(acc[4] * inv, acc[5] * inv);
      v.w = pack_bf16x2(acc[6] * inv, acc[7] * inv);
      *reinterpret_cast<uint4*>(a.out + (((size_t)b * a.T + t) * a.Hq + (h0 + hh) * G + gq) * QD +
                                d0) = v;
    } else {
      const size_t pr = (part_base + (size_t)hh * a.nsplit) * R + gr;
      float4* po = reinterpret_cast<float4*>(a.part_o + pr * QD + d0);
      po[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      po[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (d0 == 0) {
        a.part_ml[pr * 2] = mm * 0.6931471805599453f;  // natural log units for combine_kernel
        a.part_ml[pr * 2 + 1] = ll;
      }
    }
  }
}

// ---- bf16 (K1, B12's bf16 pool) -------------------------------------------------

// The layer's k and v rows as TMA sees them: contiguous, [B, S, K] (box at
// position c of plane b); paged, [P, ps, K] (box at row c % ps of the page
// the table names).  Box {HD, NR, 1}, 128-byte swizzle; `tma` is 0 when no
// tile can take a box (S < NR, or pages not a multiple of NR rows).
struct Maps {
  CUtensorMap k, v;
  int tma;
};

// One stage of a bf16 warp ring: the k and v rows of NR positions, 128
// bytes a position, 16-byte chunk c of position r at (c ^ r % 8) * 16.
// BF_STAGES - 1 tiles a warp in flight.
constexpr int BF_STAGES = 3;
constexpr int BF_TILE = NR * HD * 2;
struct BfStage {
  __nv_bfloat16 k[NR * HD];
  __nv_bfloat16 v[NR * HD];
};

// The rings, and after the loop the four warps' states of one row tile.
union BfSmem {
  BfStage ring[NW][BF_STAGES];
  struct {
    float o[NW][16][HD];
    float ml[NW][16][2];
  } merge;
};
// from a 1024-byte-aligned base (the swizzle's period): the union, then
// each warp's stage barriers
constexpr int BF_BARS = sizeof(BfSmem);
constexpr int BF_SMEM = BF_BARS + 8 * NW * BF_STAGES + 1024;
static_assert(sizeof(BfStage) % 1024 == 0 && BF_TILE % 1024 == 0, "tiles keep the swizzle period");

__device__ __forceinline__ uint32_t ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A block: split blockIdx.x / nrb of the positions, rows [16 MT rb, 16 MT
// (rb + 1)) of kv head blockIdx.y of request blockIdx.z (rb = blockIdx.x %
// nrb).  Each warp holds MT row tiles: Q as A fragments, and (m, l, o).
template <int MT, bool PAGED>
__device__ __forceinline__ void bf16_body(const AttnArgs& a, int R, const Maps& maps,
                                          unsigned char* raw_smem) {
  const uint32_t raw = smem_u32(raw_smem);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  BfSmem& sm = *reinterpret_cast<BfSmem*>(raw_smem + pad);
  const int nrb = gridDim.x / a.nsplit;
  const int split = blockIdx.x / nrb, rb = blockIdx.x % nrb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.Hq / a.Hkv, GT = G * a.T;
  const int K = a.Hkv * HD;  // a cache row's elements
  const int base = a.base_lens[b];
  const int r_block = rb * 16 * MT;
  const int t_last = min((r_block + 16 * MT - 1) / G, a.T - 1);
  const int hi = min(base + t_last + 1, a.S);
  const int lo = split * a.chunk;
  if (lo >= hi) return;  // no position visible: combine_kernel never reads this split
  const int hi_s = min(hi, lo + a.chunk);
  const bool fresh = a.k_new != nullptr;
  const int fresh_at = fresh ? base : a.S;  // the first position read from the fresh rows
  // a tile [c, c + NR) with c + NR <= tma_end lands by TMA
  const int tma_end = maps.tma ? min(hi_s, fresh_at) : 0;
  // 1/sqrt(hd), times log2(e): the softmax runs in the exp2 domain
  const float scale = 0.125f * 1.4426950408889634f;

  // positions [0, lim) visible to the thread's rows g and g + 8 of each row
  // tile; a padding row (past G*T, never written) sees the block's whole
  // range, so that the tiles every row sees whole take the softmax without
  // masks
  int lim[MT][2], lim_min[MT];
  uint32_t qf[MT][HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_block + 16 * mt + g + 8 * i;
      const bool valid = row < GT;
      lim[mt][i] = valid ? min(base + row / G + 1, hi_s) : hi_s;
      const __nv_bfloat16* qp =
          a.q + (((size_t)b * a.T + row / G) * a.Hq + h * G + row % G) * HD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qf[mt][kk][i] = valid ? ldg_u32(qp + 16 * kk) : 0u;
        qf[mt][kk][i + 2] = valid ? ldg_u32(qp + 16 * kk + 8) : 0u;
      }
    }
    lim_min[mt] = min(lim[mt][0], lim[mt][1]);
  }
  float o[MT][HD / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const RowAddr<__nv_bfloat16, PAGED> krows =
      kv_rows<__nv_bfloat16, PAGED>(a, a.k, b, K, h * HD);
  const RowAddr<__nv_bfloat16, PAGED> vrows =
      kv_rows<__nv_bfloat16, PAGED>(a, a.v, b, K, h * HD);
  const size_t f_off = (size_t)b * a.T * K + h * HD;
  const __nv_bfloat16* kn = fresh ? a.k_new + f_off : nullptr;
  const __nv_bfloat16* vn = fresh ? a.v_new + f_off : nullptr;
  const uint32_t bars = raw + pad + BF_BARS + 8 * BF_STAGES * warp;  // this warp's
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < BF_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Fill stage st with the tile at position c: two boxes by lane 0 on the
  // stage's barrier, or each lane four 16-byte chunks of k and of v (chunk i
  // = lane + 32 j: position i / 8, chunk i % 8), zeros past hi_s, where
  // nothing is read.
  auto fill = [&](int st, int c) {
    BfStage& s = sm.ring[warp][st];
    if (c + NR <= tma_end) {
      if (lane == 0) {
        fence_proxy_async();  // the stage's last generic reads and writes first
        const uint32_t bar = bars + 8 * st;
        int row = c, plane = b;
        if constexpr (PAGED) {
          row = c % a.ps;
          plane = __ldg(a.table + (size_t)b * a.npr + c / a.ps);
        }
        mbar_expect_tx(bar, 2 * BF_TILE);
        tma_load_3d(smem_u32(s.k), &maps.k, bar, h * HD, row, plane);
        tma_load_3d(smem_u32(s.v), &maps.v, bar, h * HD, row, plane);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < NR * HD / 8 / 32; ++j) {
      const int i = lane + 32 * j, r = i >> 3, c8 = i & 7, pos = c + r;
      const bool ok = pos < hi_s, cached = pos < fresh_at;
      const size_t f = (size_t)(pos - fresh_at) * K + 8 * c8;  // its fresh row's chunk
      const __nv_bfloat16* ks = !ok ? a.k : cached ? krows(pos) + 8 * c8 : kn + f;
      const __nv_bfloat16* vs = !ok ? a.v : cached ? vrows(pos) + 8 * c8 : vn + f;
      const int at = r * HD + ((c8 ^ (r & 7)) << 3);
      cp_async16(s.k + at, ks, ok);
      cp_async16(s.v + at, vs, ok);
    }
  };

  const int ntiles = (hi_s - lo + NR - 1) / NR;
  const int mine = ntiles > warp ? (ntiles - warp + NW - 1) / NW : 0;  // tiles warp, warp + NW, ...
#pragma unroll
  for (int st = 0; st < BF_STAGES - 1; ++st) {
    if (st < mine) fill(st, lo + (warp + st * NW) * NR);
    cp_async_commit();
  }
  // ldmatrix addresses within a tile: K (positions 8 (lane / 16) + lane % 8,
  // chunk 2 kk + lane / 8 % 2) and V (positions lane % 8 + 8 (lane / 8 % 2),
  // chunk 2 np + lane / 16), each chunk at its swizzled place
  const int k_row = 8 * (lane >> 4) + (lane & 7), k_c = (lane >> 3) & 1;
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1), v_c = lane >> 4;
  uint32_t phase = 0;  // the parity each stage's barrier waits for next
  for (int it = 0; it < mine; ++it) {
    const int st = it % BF_STAGES;
    const int c0 = lo + (warp + it * NW) * NR;
    cp_async_wait<BF_STAGES - 2>();  // this lane's copies of tile `it` have landed
    if (c0 + NR <= tma_end) {     // or its boxes
      mbar_wait(bars + 8 * st, (phase >> st) & 1u);
      phase ^= 1u << st;
    }
    __syncwarp();  // every lane's; and tile it - 1's reads are done
    if (it + BF_STAGES - 1 < mine)
      fill((it + BF_STAGES - 1) % BF_STAGES, lo + (warp + (it + BF_STAGES - 1) * NW) * NR);
    cp_async_commit();
    const uint32_t ks = smem_u32(sm.ring[warp][st].k), vs = smem_u32(sm.ring[warp][st].v);

    // Each row tile: S = Q K^T (K words (ldmatrix, kk): positions 0-7 and
    // 8-15, dims 16 kk .. 16 kk + 15), then the online softmax in the exp2
    // domain (sc[j][e]: row g + 8 (e >> 1), position c0 + 8 j + 2 t4 + (e &
    // 1)); P as the A fragment, bf16(p) as the reference.  A tile every row
    // of the warp sees whole skips the masks (the same arithmetic, so the
    // bits do not depend on which rows share it); the products and sums are
    // rounded one by one (no contraction), the same in every instance.
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (r_block + 16 * mt >= GT) break;  // a row tile of padding only
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4_u32(kb, ks + k_row * 128 + (((2 * kk + k_c) ^ (k_row & 7)) << 4));
        mma_bf16_16816(sc[0], qf[mt][kk], kb[0], kb[1]);
        mma_bf16_16816(sc[1], qf[mt][kk], kb[2], kb[3]);
      }
      const bool whole = __all_sync(0xffffffffu, c0 + NR <= lim_min[mt]);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = whole || c0 + 8 * j + 2 * t4 + (e & 1) < lim[mt][i]
                              ? __fmul_rn(sc[j][e], scale)
                              : kNegInf;
          sc[j][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[mt][i], mx[i]);
        corr[i] = ex2(__fsub_rn(m[mt][i], m_new));
        m[mt][i] = m_new;
        l[mt][i] = __fmul_rn(l[mt][i], corr[i]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = whole || c0 + 8 * j + 2 * t4 + (e & 1) < lim[mt][i]
                              ? ex2(__fsub_rn(sc[j][e], m[mt][i]))
                              : 0.f;
          sc[j][e] = p;
          l[mt][i] = __fadd_rn(l[mt][i], p);
        }
      pa[mt][0] = pack_bf16x2(sc[0][0], sc[0][1]);
      pa[mt][1] = pack_bf16x2(sc[0][2], sc[0][3]);
      pa[mt][2] = pack_bf16x2(sc[1][0], sc[1][1]);
      pa[mt][3] = pack_bf16x2(sc[1][2], sc[1][3]);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[mt][n][0] *= corr[0];
          o[mt][n][1] *= corr[0];
          o[mt][n][2] *= corr[1];
          o[mt][n][3] *= corr[1];
        }
      }
    }

    // O += P V.  V words (ldmatrix.trans, np): positions 0-7 and 8-15 of
    // dims 16 np .. 16 np + 7 (n-block 2 np) and 16 np + 8 .. 16 np + 15
    // (n-block 2 np + 1); o[mt][n][e] is row g + 8 (e >> 1), dim 8 n + 2 t4 +
    // (e & 1)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans_u32(vb, vs + v_row * 128 + (((2 * np + v_c) ^ (v_row & 7)) << 4));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (r_block + 16 * mt >= GT) break;
        mma_bf16_16816(o[mt][2 * np], pa[mt], vb[0], vb[1]);
        mma_bf16_16816(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Merge the four warps' states of each row tile, in warp order, then the
  // output (one split) or the partial (natural log units for combine_kernel).
  const size_t part = ((size_t)b * a.Hkv + h) * a.nsplit + split;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (r_block + 16 * mt >= GT) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] = __fadd_rn(l[mt][i], __shfl_xor_sync(0xffffffffu, l[mt][i], 1));
      l[mt][i] = __fadd_rn(l[mt][i], __shfl_xor_sync(0xffffffffu, l[mt][i], 2));
    }
    __syncthreads();  // every warp's ring (or the last row tile's merge) is idle
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(&sm.merge.o[warp][g + 8 * i][8 * n + 2 * t4]) =
            make_float2(o[mt][n][2 * i], o[mt][n][2 * i + 1]);
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.merge.ml[warp][g + 8 * i][0] = m[mt][i];
        sm.merge.ml[warp][g + 8 * i][1] = l[mt][i];
      }
    }
    __syncthreads();
    const int row = threadIdx.x >> 3, d0 = 8 * (threadIdx.x & 7);  // 16 rows x 8 chunks
    const int gr = r_block + 16 * mt + row;
    if (gr < GT) {
      float mw[NW], mm = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        mw[w] = sm.merge.ml[w][row][0];
        mm = fmaxf(mm, mw[w]);
      }
      float ll = 0.f, acc[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = ex2(__fsub_rn(mw[w], mm));
        ll = __fadd_rn(ll, __fmul_rn(sm.merge.ml[w][row][1], c));
#pragma unroll
        for (int d = 0; d < 8; ++d)
          acc[d] = __fadd_rn(acc[d], __fmul_rn(sm.merge.o[w][row][d0 + d], c));
      }
      if (a.nsplit == 1) {
        const float inv = 1.f / fmaxf(ll, 1e-30f);
        uint4 v;
        v.x = pack_bf16x2(acc[0] * inv, acc[1] * inv);
        v.y = pack_bf16x2(acc[2] * inv, acc[3] * inv);
        v.z = pack_bf16x2(acc[4] * inv, acc[5] * inv);
        v.w = pack_bf16x2(acc[6] * inv, acc[7] * inv);
        const size_t at = (((size_t)b * a.T + gr / G) * a.Hq + h * G + gr % G) * HD + d0;
        *reinterpret_cast<uint4*>(a.out + at) = v;
      } else {
        float4* po = reinterpret_cast<float4*>(a.part_o + (part * R + gr) * HD + d0);
        po[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        po[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        if (d0 == 0) {
          a.part_ml[(part * R + gr) * 2] = mm * 0.6931471805599453f;
          a.part_ml[(part * R + gr) * 2 + 1] = ll;
        }
      }
    }
  }
}

// Blocks an SM the launch bound asks for: quantized, three pair blocks (168
// registers) or four one-head blocks, two pair blocks at head dim 128 (the
// output of two heads takes 128 registers a thread); bf16, by its row tiles.
constexpr int min_blocks(int FMT, int HEADS, int MT, int QD) {
  return FMT == kBF16 ? (MT == 1 ? 4 : MT == 2 ? 3 : 2)
                      : (QD > 64 ? 2 : HEADS == 1 ? 4 : 3);
}

// FMT kBF16: one kv head a block (HEADS 1), MT row tiles a warp, the tensor
// maps of the layer's rows; kI8 / kI4: HEADS kv heads a block (INT4: the
// packed pair), MT 1, the maps unused, BFS: bf16 scales, QD: the head dim.
template <int FMT, int HEADS, int MT, bool PAGED, bool BFS = false, int QD = HD>
__global__ void __launch_bounds__(NW * 32, min_blocks(FMT, HEADS, MT, QD))
    decode_sm90_kernel(const __grid_constant__ AttnArgs a, int R,
                       const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) unsigned char dq_smem[];
  if constexpr (FMT == kBF16)
    bf16_body<MT, PAGED>(a, R, maps, dq_smem);
  else
    quant_body<FMT == kI4, HEADS, PAGED, BFS, QD>(a, R, dq_smem);
}

// ---- host side ------------------------------------------------------------------

// The operands of a quantized cache (int8, or int4 packed in head pairs
// with INT4): q [B, T, Hq, QD] bf16; k/v int8 [L, B, S, K] (K = Hkv*QD, or
// (Hkv/2)*QD packed) with f32 or bf16 scales [L, B, Hkv, S]; k_new/v_new [B, T, K]
// and ks_new/vs_new [B, Hkv, T], or all four null; base_lens [B]; out [B, T,
// Hq, QD]; the partials [B, Hkv, nsplit, R, QD] and [.., R, 2] when nsplit
// > 1.  False when the shapes are not the kernel's.
template <bool INT4, int QD>
bool quant_args(AttnArgs& a, const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* k_new, const void* v_new, const void* ks_new,
                const void* vs_new, const void* base_lens, void* out, void* part_o,
                void* part_ml, int layer, int B, int S, int T, int Hq, int Hkv, int hd,
                int nsplit, int chunk) {
  if (hd != QD || Hkv < 1 || Hq % Hkv != 0 || (INT4 && Hkv % 2 != 0) || T < 1 || T > 16 ||
      nsplit < 1 || chunk < NR || chunk % NR != 0 || (k_new == nullptr) != (ks_new == nullptr))
    return false;
  a = AttnArgs{};  // the bf16 fields stay null
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kq = static_cast<const int8_t*>(k);
  a.vq = static_cast<const int8_t*>(v);
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.kq_new = static_cast<const int8_t*>(k_new);
  a.vq_new = static_cast<const int8_t*>(v_new);
  a.ks_new = ks_new;
  a.vs_new = vs_new;
  a.base_lens = static_cast<const int*>(base_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.nsplit = nsplit;
  a.chunk = chunk;
  return true;
}

// The bf16 operands (K1, B12's bf16 pool): q [B, T, Hq, 64]; k/v [L, B, S,
// Hkv*64]; k_new/v_new [B, T, Hkv*64] or both null; base_lens [B]; out [B,
// T, Hq, 64]; the partials as above.  G*T <= 128 rows.
bool dense_args(AttnArgs& a, const void* q, const void* k, const void* v, const void* k_new,
                const void* v_new, const void* base_lens, void* out, void* part_o,
                void* part_ml, int layer, int B, int S, int T, int Hq, int Hkv, int hd,
                int nsplit, int chunk) {
  if (hd != HD || Hkv < 1 || Hq % Hkv != 0 || T < 1 || T > 16 || (Hq / Hkv) * T > 128 ||
      nsplit < 1 || chunk < NR || chunk % NR != 0 || (long long)nsplit * chunk < S ||
      (k_new == nullptr) != (v_new == nullptr))
    return false;
  a = AttnArgs{};  // the int8 fields stay null
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.base_lens = static_cast<const int*>(base_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.layer = layer;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.nsplit = nsplit;
  a.chunk = chunk;
  return true;
}

// The partials' rows a (request, kv head, split): R = 16 * 2^k >= G*T
// (kernels/decode_attention.py rows_pad).
int rows_pad(const AttnArgs& a) {
  const int rows = (a.Hq / a.Hkv) * a.T;
  int R = 16;
  while (R < rows) R *= 2;
  return R;
}

// One launch of the kernel (grid: nsplit x blocks of grouped query rows,
// kv heads or head pairs, requests), then the combine pass when nsplit > 1.
// Returns cudaGetLastError().
template <int FMT, int HEADS, int MT, bool PAGED, bool BFS = false, int QD = HD>
int launch_kernel(const AttnArgs& a, const Maps& maps, int bytes, cudaStream_t stream) {
  // once per instantiation: the shared memory past 48 KB
  static const cudaError_t attr =
      cudaFuncSetAttribute(decode_sm90_kernel<FMT, HEADS, MT, PAGED, BFS, QD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int R = rows_pad(a);
  const int row_blocks = ((a.Hq / a.Hkv) * a.T + 16 * MT - 1) / (16 * MT);
  const dim3 grid(a.nsplit * row_blocks, a.Hkv / HEADS, a.B);
  decode_sm90_kernel<FMT, HEADS, MT, PAGED, BFS, QD><<<grid, NW * 32, bytes, stream>>>(a, R,
                                                                                      maps);
  if (a.nsplit > 1) launch_combine<QD>(a, R, stream);
  return (int)cudaGetLastError();
}

// int4: one block a packed pair; int8: a pair of heads, or one when Hkv is
// odd (kernels/decode_attention.py quant_split_plan counts the same blocks);
// BFS: the bf16-scale instances; QD: the head dim
template <bool INT4, bool PAGED, bool BFS, int QD = HD>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const Maps none{};
  if constexpr (INT4)
    return launch_kernel<kI4, 2, 1, PAGED, BFS, QD>(a, none, QUANT_SMEM<true, 2, BFS, QD>,
                                                    stream);
  else
    return a.Hkv % 2 == 0
               ? launch_kernel<kI8, 2, 1, PAGED, BFS, QD>(a, none,
                                                          QUANT_SMEM<false, 2, BFS, QD>, stream)
               : launch_kernel<kI8, 1, 1, PAGED, BFS, QD>(a, none,
                                                          QUANT_SMEM<false, 1, BFS, QD>, stream);
}

// bf16: one block a kv head, min(row tiles, MT_MAX) row tiles a warp
template <bool PAGED>
int launch_bf16(const AttnArgs& a, const Maps& maps, cudaStream_t stream) {
  const int tiles = ((a.Hq / a.Hkv) * a.T + 15) / 16;
  if (tiles == 1) return launch_kernel<kBF16, 1, 1, PAGED>(a, maps, BF_SMEM, stream);
  if (tiles == 2) return launch_kernel<kBF16, 1, 2, PAGED>(a, maps, BF_SMEM, stream);
  return launch_kernel<kBF16, 1, MT_MAX, PAGED>(a, maps, BF_SMEM, stream);
}

// The map of `planes` x `rows` rows of `cols` bf16 values (one layer's k or
// v), box {HD, NR, 1}, 128-byte swizzle; encoded once per (pointer, shape).
CUresult rows_map(CUtensorMap* map, const void* ptr, int cols, int rows, int planes) {
  return sm90::cached_map(map, std::make_tuple(ptr, cols, rows, planes), [&](CUtensorMap* m) {
    return sm90::encode_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 2, cols, rows, planes, HD,
                           NR, CU_TENSOR_MAP_SWIZZLE_128B);
  });
}

// The maps of layer a.layer of caches k/v, whose layers hold `planes` x
// `rows` rows (contiguous: B x S; a pool: P x ps); none when no tile can
// take a box.
CUresult layer_maps(Maps& maps, const AttnArgs& a, int planes, int rows, bool boxes) {
  maps = Maps{};
  if (!boxes) return CUDA_SUCCESS;
  const int K = a.Hkv * HD;
  const size_t layer = (size_t)a.layer * planes * rows * K;
  CUresult enc = rows_map(&maps.k, a.k + layer, K, rows, planes);
  if (enc == CUDA_SUCCESS) enc = rows_map(&maps.v, a.v + layer, K, rows, planes);
  maps.tma = enc == CUDA_SUCCESS;
  return enc;
}

template <bool INT4, bool BFS, int QD = HD>
int contiguous(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* k_new, const void* v_new, const void* ks_new,
               const void* vs_new, const void* base_lens, void* out, void* part_o, void* part_ml,
               int layer, int B, int S, int T, int Hq, int Hkv, int hd, int nsplit, int chunk,
               void* stream) {
  AttnArgs a;
  if (!quant_args<INT4, QD>(a, q, k, v, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
                            base_lens, out, part_o, part_ml, layer, B, S, T, Hq, Hkv, hd, nsplit,
                            chunk))
    return (int)cudaErrorInvalidValue;
  return launch<INT4, false, BFS, QD>(a, static_cast<cudaStream_t>(stream));
}

template <bool INT4, bool BFS, int QD = HD>
int paged(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
          const void* v_scale, const void* table, const void* k_new, const void* v_new,
          const void* ks_new, const void* vs_new, const void* base_lens, void* out, void* part_o,
          void* part_ml, int layer, int B, int P, int ps, int npr, int T, int Hq, int Hkv,
          int hd, int nsplit, int chunk, void* stream) {
  AttnArgs a;
  if (!quant_args<INT4, QD>(a, q, k_pool, v_pool, k_scale, v_scale, k_new, v_new, ks_new,
                            vs_new, base_lens, out, part_o, part_ml, layer, B, npr * ps, T, Hq,
                            Hkv, hd, nsplit, chunk) ||
      !paged_shape(a, table, P, ps, npr))
    return (int)cudaErrorInvalidValue;
  return launch<INT4, true, BFS, QD>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace dq90
}  // namespace md

// K1: q [B, T, Hq, hd] bf16 (T <= 16, G*T <= 128), k/v bf16 [L, B, S,
// Hkv*hd], k_new/v_new [B, T, Hkv*hd] or both null, base_lens [B], out [B,
// T, Hq, hd], the partials part_o/part_ml of nsplit splits of `chunk`
// positions (a multiple of 16).  Returns cudaGetLastError(), or 0x10000 +
// the CUresult of a failed tensor-map encode.
extern "C" int md_decode_attend(const void* q, const void* k, const void* v, const void* k_new,
                                const void* v_new, const void* base_lens, void* out,
                                void* part_o, void* part_ml, int layer, int B, int S, int T,
                                int Hq, int Hkv, int hd, int nsplit, int chunk, void* stream) {
  using namespace md::dq90;
  md::AttnArgs a;
  if (!dense_args(a, q, k, v, k_new, v_new, base_lens, out, part_o, part_ml, layer, B, S, T, Hq,
                  Hkv, hd, nsplit, chunk))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const CUresult enc = layer_maps(maps, a, B, S, S >= NR);
  if (enc != CUDA_SUCCESS) return md::sm90::kEncodeError + (int)enc;
  return launch_bf16<false>(a, maps, static_cast<cudaStream_t>(stream));
}

// B12 over a bf16 pool: as md_decode_attend, with k_pool/v_pool [L, P, ps,
// Hkv*hd] read through table [B, npr] (S = npr * ps; a tile takes a box of
// its page when ps is a multiple of 16).
extern "C" int md_paged_decode_attend(const void* q, const void* k_pool, const void* v_pool,
                                      const void* table, const void* k_new, const void* v_new,
                                      const void* base_lens, void* out, void* part_o,
                                      void* part_ml, int layer, int B, int P, int ps, int npr,
                                      int T, int Hq, int Hkv, int hd, int nsplit, int chunk,
                                      void* stream) {
  using namespace md::dq90;
  md::AttnArgs a;
  if (!dense_args(a, q, k_pool, v_pool, k_new, v_new, base_lens, out, part_o, part_ml, layer, B,
                  npr * ps, T, Hq, Hkv, hd, nsplit, chunk) ||
      !md::paged_shape(a, table, P, ps, npr))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const CUresult enc = layer_maps(maps, a, P, ps, ps % NR == 0);
  if (enc != CUDA_SUCCESS) return md::sm90::kEncodeError + (int)enc;
  return launch_bf16<true>(a, maps, static_cast<cudaStream_t>(stream));
}

// K1q: q [B, T, Hq, hd] bf16, k/v int8 [L, B, S, Hkv*hd] with f32 scales
// k_scale/v_scale [L, B, Hkv, S], k_new/v_new [B, T, Hkv*hd] with
// ks_new/vs_new [B, Hkv, T] or all null, base_lens [B], out [B, T, Hq, hd],
// the partials part_o/part_ml of nsplit splits of `chunk` positions (a
// multiple of 16).  Returns cudaGetLastError().  The _bf16s entries take
// bf16 scales (the cache's and the fresh rows'), the arguments otherwise
// the same.
#define MD_DECODE_QUANT(NAME, INT4, BFS, QD)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* k_scale,    \
                      const void* v_scale, const void* k_new, const void* v_new,           \
                      const void* ks_new, const void* vs_new, const void* base_lens,       \
                      void* out, void* part_o, void* part_ml, int layer, int B, int S,     \
                      int T, int Hq, int Hkv, int hd, int nsplit, int chunk,               \
                      void* stream) {                                                      \
    return md::dq90::contiguous<INT4, BFS, QD>(q, k, v, k_scale, v_scale, k_new, v_new,    \
                                               ks_new, vs_new, base_lens, out, part_o,     \
                                               part_ml, layer, B, S, T, Hq, Hkv, hd,       \
                                               nsplit, chunk, stream);                     \
  }
MD_DECODE_QUANT(md_decode_attend_quant, false, false, 64)
MD_DECODE_QUANT(md_decode_attend_quant_bf16s, false, true, 64)
// B10: as md_decode_attend_quant, with packed int4 k/v [L, B, S,
// (Hkv/2)*hd] (+ k_new/v_new [B, T, (Hkv/2)*hd]); Hkv even.  The _hd128
// entry: head dim 128 (f32 scales); the others take head dim 64.
MD_DECODE_QUANT(md_decode_attend_quant4, true, false, 64)
MD_DECODE_QUANT(md_decode_attend_quant4_bf16s, true, true, 64)
MD_DECODE_QUANT(md_decode_attend_quant4_hd128, true, false, 128)

// B12 over an int8 pool (INT4 = 0) or an int4 pool packed in head pairs:
// as md_decode_attend_quant{,4}, with the pools [L, P, ps, Kc] and the scale
// pools [L, P, Hkv, ps] read through table [B, npr] (S = npr * ps); _bf16s:
// bf16 scales.
#define MD_PAGED_QUANT(NAME, INT4, BFS, QD)                                               \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,               \
                      const void* k_scale, const void* v_scale, const void* table,         \
                      const void* k_new, const void* v_new, const void* ks_new,            \
                      const void* vs_new, const void* base_lens, void* out, void* part_o,  \
                      void* part_ml, int layer, int B, int P, int ps, int npr, int T,      \
                      int Hq, int Hkv, int hd, int nsplit, int chunk, void* stream) {      \
    return md::dq90::paged<INT4, BFS, QD>(q, k_pool, v_pool, k_scale, v_scale, table,      \
                                          k_new, v_new, ks_new, vs_new, base_lens, out,    \
                                          part_o, part_ml, layer, B, P, ps, npr, T, Hq,    \
                                          Hkv, hd, nsplit, chunk, stream);                 \
  }
MD_PAGED_QUANT(md_paged_decode_attend_quant, false, false, 64)
MD_PAGED_QUANT(md_paged_decode_attend_quant_bf16s, false, true, 64)
MD_PAGED_QUANT(md_paged_decode_attend_quant4, true, false, 64)
MD_PAGED_QUANT(md_paged_decode_attend_quant4_bf16s, true, true, 64)
MD_PAGED_QUANT(md_paged_decode_attend_quant4_hd128, true, false, 128)

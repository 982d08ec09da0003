// The backward of ring attention on Hopper, bfloat16: dQ, dK and dV from q,
// k, v, the forward's output o, its cotangent dO and the rows' log-sum-exp
// that the sm90 forward (ring_attention_sm90.cu) writes, with S, P, dP and
// dS kept on the chip.
//
// Replaces no TPU kernel: the JAX package's gradient of its ring
// (tpu_mpi/parallel/ring.py) is XLA's autodiff, with no kernel of its own.
// It takes the place of kernels/attention.py:attention_backward on the
// calls the sm90 forward served; that function stays the plain version,
// the route of every other call, and this kernel's oracle on the card.
//
// The function: full attention over the global sequence of the n stacked
// blocks (global row r t + i of rank r's row i), causal by global position
// or not. Per (query, key) pair, with S = Q K^T in float32 and LSE in log2
// units (scores times scale * log2(e)):
//   P = 2^(S scale log2(e) - LSE)           (ex2.approx, masked pairs 0)
//   dV += P^T dO                           (P rounded to bfloat16)
//   dP = dO V^T,  dS = P (dP - D),  D = rowsum(dO o) in float32
//   dK += dS^T Q,  dQ += dS K               (dS rounded to bfloat16)
//   dK, dQ times scale at the end, every gradient rounded to bfloat16.
// Every product sums in float32. P and dS round to bfloat16 before their
// products as the eager backward rounds them; dS is formed from the
// bfloat16 P (the eager backward forms it from the float32 P: a relative
// difference of at most 2^-8 in one factor). The card tests hold all three
// gradients to attention_backward within 2^-5 of each one's largest
// magnitude.
//
// Bound on the card: 2 (3 dq + 2 dv) flops per unmasked pair against the
// bytes of q, k, v, o, dO, dq, dk and dv once; compute bound at both
// shapes it serves (Moonlight's (64, 4096, 192/128): 0.894 TFLOP, 0.90 ms
// at 989 TFLOP/s, its bytes 0.2 ms; the flagship's (4 x 128, 256, 64): 43
// GFLOP, 0.044 ms, bytes 0.040 ms). What the design does:
//  * a small first launch writes, per 64-row query tile, the rows' LSE
//    (copied from the forward) and D = rowsum(dO o) in float32, zero past
//    t. Every launch reads and writes the stacked (n, BH, t, d) layout in
//    place: no transposes;
//  * the main launch: one block per (key tile, batch-head, rank), the
//    heaviest key tiles (the earliest, which see the most queries under
//    the causal mask) first. K and V of the tile are loaded once; a
//    producer warp keeps TMA loads of Q, dO (64-row tiles, 128-byte
//    swizzle) and the tile's LSE and D (one bulk copy) in flight over a
//    ring of STAGES; the consumers walk the query tiles that can see their
//    keys (causal: from the key tile's own rows on, rank by rank), so key
//    tiles wholly above the diagonal are never visited and only diagonal
//    and ragged tiles take the mask;
//  * per query tile: S^T = K Q^T (wgmma, both operands K-major in shared
//    memory), P^T = 2^(S^T scale log2(e) - LSE) rounded to bfloat16 into
//    shared memory (swizzled as TMA would), dV += P^T dO, dP^T = V dO^T,
//    dS^T = P^T (dP^T - D) rounded to bfloat16 in shared memory, and dK +=
//    dS^T Q: every product from shared memory, dK and dV one m64nD
//    accumulator each, in registers for the whole launch and written once,
//    scaled. A thread may hold 168 registers (9 warps a block: 3 to each
//    of an SM's register files), which sets the split of the work:
//  * q/k 64: a block of 128 keys, each consumer warpgroup doing all of the
//    above for its own 64 (dK and dV: 64 registers a thread). dQ += dS K
//    sums over the block's 128 keys: the two warpgroups split dQ's panels
//    (wgmma with both operands MN-major), write them into a float32 staging
//    tile in the accumulator's own order, and one bulk reduce-add
//    (cp.reduce.async.bulk) adds the tile into a float32 accumulator in L2;
//    a last small launch undoes the order, scales dQ and casts it;
//  * q/k 128 and 192: dK and dV of 64 keys take 128 and 160 registers a
//    thread, so a block takes 64 keys and splits the work: warpgroup A
//    computes S^T and P^T and holds dK, warpgroup B computes dP^T and dS^T
//    and holds dV, with two P^T buffers taken in turn so that A runs one
//    tile ahead. Here dQ's reduce-add would move 48 KB of float32 into L2
//    per 64 x 64 tile (6.6 GB a Moonlight launch), which bound the launch
//    at 6.4 ms where the rest took 2.4; so dQ has a pass of its own, the
//    third launch: a block per 128 query rows walks the key tiles its rows
//    see, recomputes S and dP, and keeps dQ (64 x 192 a warpgroup) in
//    registers, dS the A fragments of dQ += dS K. Its sum order is fixed.
//    At q/k 64 that design is the slower: 0.328 ms a call against the
//    fused one's 0.266 at the flagship's (4 x 128, 256), 0.538 against
//    0.397 without the mask (one H100), so each head dim keeps its own.
// dQ's sum order at q/k 64: the blocks of one query tile add in whatever
// order they finish, so dQ there is not bitwise deterministic from run to
// run (dK and dV, and dQ at 128 and 192, are: one block sums each in a
// fixed order). A deterministic order at 64 would cost the dQ pass of the
// wide head dims: S and dP once more, about 40 % more operations.
//
// Layout: q and k are (n, BH, t, d), v, o and dO (n, BH, t, dv), contiguous
// bfloat16 with 16-byte-aligned bases; lse (n, BH, t) float32 from the
// forward. d and dv multiples of 8: d == dv <= 128, or latent attention's
// d <= 192 beside 64 < dv <= 128; each pads to 64-column panels through
// TMA's zero fill.
//
// C interface (bound with ctypes): returns 0 on success, the cudaError_t of a
// refused launch, or TMT_EBADARG for arguments the kernels do not take. It
// launches on the given stream and never synchronises; the caller
// allocates dq, dk, dv and the float32 scratch (the per-tile LSE and D, and
// at q/k 64 the dQ accumulator: tmt_attention_backward_sm90_scratch floats).

#include "sm90.cuh"        // TMA, wgmma, packing, the tensor-map encoder
#include <math.h>

namespace sm90 {

const int NC = 2;                     // consumer warpgroups per block
const int BQ = 64;                    // query rows per tile
static_assert(BQ == BOX, "one box per 64-row query tile");
const int kThreads = 128 * NC + 32;   // consumers, then the producer warp
const int kSmallThreads = 256;        // the two small launches
const float kLog2e = 1.4426950408889634f;

// A block's key tile and the work of its two consumer warpgroups. A thread
// may hold 168 registers (9 warps: 3 to each of an SM's 4 register files).
// At q/k 64 each warpgroup owns 64 of the block's 128 keys and computes
// everything for them: its dK and dV accumulators take 64 registers a
// thread. At q/k 128 and 192 dK and dV of 64 keys take 128 and 160, so the
// block takes 64 keys and splits the work: warpgroup A computes S^T and P^T
// and holds dK, warpgroup B computes dP^T and dS^T, holds dV and computes dQ.
//
// Shared memory (1024-aligned regions first): K and V of the key tile
// (64-column panels of kKeys rows), STAGES Q and dO tiles (panels of 64
// rows), the P^T and dS^T tiles (bfloat16 rows of 64 queries: at 64 one
// buffer of 128 key rows, P^T then dS^T in place; split, two P^T buffers
// taken in turn and one dS^T), the float32 dQ staging tile, STAGES tiles of
// LSE and D, the mbarriers, and slack to align the start.
template <int DQ, int DV, int STAGES>
struct Plan {
  static constexpr bool kSplit = DQ > 64;
  static constexpr int kKeys = kSplit ? 64 : 128;
  static constexpr int kQP = DQ / 64;
  static constexpr int kVP = DV / 64;
  static constexpr int kKPanel = kKeys * ROW;
  static constexpr int kQPanel = BQ * ROW;
  static constexpr int kK = kQP * kKPanel;
  static constexpr int kV = kVP * kKPanel;
  static constexpr int kStageQ = kQP * kQPanel;
  static constexpr int kStageDO = kVP * kQPanel;
  static constexpr int kTileP = 64 * ROW;          // 64 key rows of 64 queries
  static constexpr int kPS = kSplit ? 3 * kTileP : 2 * kTileP;
  static constexpr int kStaging = kSplit ? 0 : BQ * DQ * 4;
  static constexpr int kStat = 2 * BQ * 4;
  static constexpr int kBars = 8 * (1 + 2 * STAGES);
  static constexpr int kBytes = kK + kV + STAGES * (kStageQ + kStageDO) + kPS + kStaging +
                                STAGES * kStat + kBars + 1024;
};

// The dQ pass at q/k 128 and 192: Q and dO of the block's 128 query rows
// (64-column panels), STAGES K and V tiles of 64 keys, the mbarriers, and
// slack to align the start.
template <int DQ, int DV, int STAGES>
struct DqPlan {
  static constexpr int kQP = DQ / 64;
  static constexpr int kVP = DV / 64;
  static constexpr int kRowPanel = 2 * BQ * ROW;
  static constexpr int kKPanel = 64 * ROW;
  static constexpr int kQ = kQP * kRowPanel;
  static constexpr int kDO = kVP * kRowPanel;
  static constexpr int kTileK = kQP * kKPanel;
  static constexpr int kTileV = kVP * kKPanel;
  static constexpr int kBars = 8 * (1 + 2 * STAGES);
  static constexpr int kBytes = kQ + kDO + STAGES * (kTileK + kTileV) + kBars + 1024;
};

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b, float c,
                                             float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dst[i] += src[i] for `bytes` of float32 in L2, one bulk operation
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk operations have read their source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Bytes 16 j + 4 tq of a 128-byte row of 64 bfloat16 queries in the P^T /
// dS^T buffer, the 16-byte chunk swizzled by the row as TMA's 128-byte
// swizzle places it (rows r and r + 8 share r % 8).
__device__ __forceinline__ uint32_t ps_at(uint32_t base, int row, int j, int tq) {
  return base + row * ROW + ((j ^ (row & 7)) << 4) + 4 * tq;
}

// P^T over one query tile for a thread's two key rows, from the raw scores
// s of S^T = K Q^T (accumulator layout: s[4j + e] is key row kr[e / 2],
// query column 8j + 2 tq + e % 2 of the tile), rounded to bfloat16 into
// rows krow and krow + 8 of the P^T buffer at ps. MASK: a pair is 0 where
// the key row is padding (kr >= t), the query is padding (q0 + column >= t)
// or the query precedes the key (column + q0 + shift < kr; shift is the
// query block's offset from the key block's under the causal mask, larger
// than any t without it).
template <bool MASK>
__device__ __forceinline__ void p_tile(const float (&s)[32], uint32_t ps, int krow,
                                       const float* lse, int tq, float scale_log2,
                                       const int (&kr)[2], int q0, int t, int shift) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 L = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(s[4 * j + e], scale_log2, -((e & 1) ? L.y : L.x)));
      if (MASK) {
        const int qq = q0 + 8 * j + 2 * tq + (e & 1);
        const int k = kr[e >> 1];
        if (k >= t || qq >= t || qq + shift < k) p[e] = 0.f;
      }
    }
    st_shared_u32(ps_at(ps, krow, j, tq), pack_rn(p[0], p[1]));
    st_shared_u32(ps_at(ps, krow + 8, j, tq), pack_rn(p[2], p[3]));
  }
}

// ---- the small launches ---------------------------------------------------------

// One block per (slab, 64-row query tile): the tile's LSE (copied) and D =
// rowsum(dO o) in float32, both 0 past t, into stats (slab, tiles, 2, 64);
// the tile's dQ accumulator zeroed where there is one (q/k 64).
template <int DQ>
__global__ void __launch_bounds__(kSmallThreads)
attention_backward_prep_kernel(const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ stats,
                               float* __restrict__ dq_acc, int t, int dv, int ntq) {
  const int64_t slab = blockIdx.x;
  const int qt = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats + (slab * ntq + qt) * 2 * BQ;
  for (int r = warp; r < BQ; r += kSmallThreads / 32) {
    const int row = qt * BQ + r;
    float acc = 0.f;
    if (row < t) {
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + (slab * t + row) * dv);
      const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(dout + (slab * t + row) * dv);
      for (int c = lane; c < dv / 2; c += 32) {
        const float2 x = __bfloat1622float2(a[c]), y = __bfloat1622float2(g[c]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      st[r] = row < t ? lse[slab * t + row] : 0.f;
      st[BQ + r] = acc;
    }
  }
  if (dq_acc == nullptr) return;
  float4* z = reinterpret_cast<float4*>(dq_acc + (slab * ntq + qt) * BQ * DQ);
  for (int i = threadIdx.x; i < BQ * DQ / 4; i += kSmallThreads)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One block per (slab, query tile): dQ = scale * the accumulator, to
// bfloat16, undoing the staging order of the main launch (float4 f of a
// tile: lane f % 32 and warp (f / 32) % 4 of the warpgroup, 8-column group
// (f / 128) % 8 of column panel f / 1024; its four floats are rows g and
// g + 8, columns 2 tq and 2 tq + 1 of the accumulator layout).
template <int DQ>
__global__ void __launch_bounds__(kSmallThreads)
attention_backward_dq_cast_kernel(const float* __restrict__ dq_acc, uint16_t* __restrict__ dq,
                             int t, int d, int ntq, float scale) {
  const int64_t slab = blockIdx.x;
  const int qt = blockIdx.y;
  const float4* tile = reinterpret_cast<const float4*>(dq_acc + (slab * ntq + qt) * BQ * DQ);
  for (int f = threadIdx.x; f < BQ * DQ / 4; f += kSmallThreads) {
    const int lane = f & 31, wi = (f >> 5) & 3, j = (f >> 7) & 7, p = f >> 10;
    const int row = qt * BQ + 16 * wi + (lane >> 2);
    const int col = 64 * p + 8 * j + 2 * (lane & 3);
    if (col >= d || row >= t) continue;
    const float4 x = tile[f];
    *reinterpret_cast<uint32_t*>(dq + (slab * t + row) * d + col) =
        pack_rn(x.x * scale, x.y * scale);
    if (row + 8 < t)
      *reinterpret_cast<uint32_t*>(dq + (slab * t + row + 8) * d + col) =
          pack_rn(x.z * scale, x.w * scale);
  }
}

// ---- the main launch ------------------------------------------------------------

// What a block's consumers read: shared-memory regions, barriers, outputs
// and the block's place (batch-head b, key tile k0 of rank rk).
struct Block {
  uint32_t sK, sV, sQ, sdO, sPS, sStg, kv_full, full0, empty0;
  const uint8_t* stat;                 // the STAGES LSE and D tiles, generic address
  float* dq_acc;
  uint16_t *dk_out, *dv_out;
  int n, bh, t, d, dv, ntq, b, rk, k0, causal;
  float scale_log2, scale;

  // the query tiles that can see the keys: causal, from the key tile's own
  // rows on, rank by rank
  __device__ int first_rank() const { return causal ? rk : 0; }
  __device__ int first_row(int rq) const { return (causal && rq == rk) ? k0 : 0; }
  // the query block's offset from the key block's under the causal mask,
  // larger than any t without it
  __device__ int shift(int rq) const { return causal ? (rq - rk) * t : (1 << 30); }
  // only diagonal tiles and ragged ones take the mask
  __device__ bool masked(int rq, int q0, int keys) const {
    return (causal && rq == rk && q0 < k0 + keys) || q0 + BQ > t || k0 + keys > t;
  }
};

// Rows kr[0], kr[1] of a (slab, t, width) bfloat16 output from an m64nW
// accumulator, times mul; rows past t and columns past width are padding.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2], uint16_t* out,
                                           int64_t slab, int t, int width,
                                           const int (&kr)[2], int tq, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kr[h] >= t) continue;
    uint16_t* row = out + (slab * t + kr[h]) * width;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c < width)
        *reinterpret_cast<uint32_t*>(row + c) =
            pack_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// One 64-column panel p of a query tile's dQ from its accumulator into the
// staging tile, in the accumulator's own order (float4 (8 p + j) 128 + tid
// holds 8-column group j of thread tid of the warpgroup).
__device__ __forceinline__ void stage_dq(uint32_t stg, int p, int tid, const float (&acc)[32]) {
  const uint32_t dst = stg + ((p * 8) * 128 + tid) * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_shared_v4(dst + j * 128 * 16, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

__device__ __forceinline__ float* dq_tile_of(const Block& c, int rq, int q0, int dq) {
  return c.dq_acc + (((int64_t)rq * c.bh + c.b) * c.ntq + q0 / BQ) * BQ * dq;
}

// q/k 64: warpgroup wg owns keys k0 + 64 wg .. + 63 of the block's 128 and
// computes all of their work: S^T, P^T into its rows of the P^T/dS^T
// buffer, dV += P^T dO, dP^T, dS^T in place of P^T, dK += dS^T Q; then the
// two warpgroups split dQ's panels over the block's 128 keys.
template <int DQ, int DV, int STAGES>
__device__ __forceinline__ void consume_whole(const Block& c, int warp, int lane) {
  using P = Plan<DQ, DV, STAGES>;
  constexpr int QP = P::kQP, KEYS = P::kKeys;
  const int wg = warp / 4, wi = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int krow = 64 * wg + 16 * wi + g;       // this thread's key rows in the block
  const int kr[2] = {c.k0 + krow, c.k0 + krow + 8};

  float dk[DQ / 2], dvacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dvacc[i] = 0.f;

  mbar_wait(c.kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int rq = c.first_rank(); rq < c.n; ++rq) {
    const int shift = c.shift(rq);
    for (int q0 = c.first_row(rq); q0 < c.t; q0 += BQ) {
      mbar_wait(c.full0 + 8 * stage, phase);
      const uint32_t qs = c.sQ + stage * P::kStageQ, dos = c.sdO + stage * P::kStageDO;
      // the tile-invariant bases, opaque to the compiler, so that it forms
      // the descriptors beside their products instead of hoisting them
      uint32_t kb = c.sK, vb = c.sV, psb = c.sPS;
      asm volatile("" : "+r"(kb), "+r"(vb), "+r"(psb));
      const uint32_t mine = psb + wg * P::kTileP;   // this warpgroup's 64 rows
      const float* lse = reinterpret_cast<const float*>(c.stat + stage * P::kStat);
      const float* dsum = lse + BQ;

      // S^T = K Q^T over this warpgroup's 64 keys
      float s[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DQ / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;         // 16 columns = 32 bytes
        wgmma_ss_n64(s, desc(kb + (ks / 4) * P::kKPanel + wg * 64 * ROW + col, 16, 1024),
                     desc(qs + (ks / 4) * P::kQPanel + col, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait();
      pin(s);

      if (c.masked(rq, q0, KEYS))
        p_tile<true>(s, psb, krow, lse, tq, c.scale_log2, kr, q0, c.t, shift);
      else
        p_tile<false>(s, psb, krow, lse, tq, c.scale_log2, kr, q0, c.t, shift);
      fence_async_smem();
      named_bar(3 + wg, 128);

      // dV += P^T dO (P^T K-major, dO MN-major), then dP^T = V dO^T
      float dp[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        wgmma_ss<0, 1>(dvacc, desc(mine + ks * 32, 16, 1024),
                       desc(dos + ks * 16 * ROW, P::kQPanel, 1024), 1);
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(dp, desc(vb + (ks / 4) * P::kKPanel + wg * 64 * ROW + col, 16, 1024),
                     desc(dos + (ks / 4) * P::kQPanel + col, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait();
      pin(dp);
      pin(dvacc);

      // dS^T = P^T (dP^T - D), rounded to bfloat16 in place of this thread's P^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 D = *reinterpret_cast<const float2*>(dsum + 8 * j + 2 * tq);
        const uint32_t at_lo = ps_at(psb, krow, j, tq), at_hi = ps_at(psb, krow + 8, j, tq);
        const float2 p01 = unpack(ld_shared_u32(at_lo));
        const float2 p23 = unpack(ld_shared_u32(at_hi));
        st_shared_u32(at_lo, pack_rn(p01.x * (dp[4 * j] - D.x), p01.y * (dp[4 * j + 1] - D.y)));
        st_shared_u32(at_hi,
                      pack_rn(p23.x * (dp[4 * j + 2] - D.x), p23.y * (dp[4 * j + 3] - D.y)));
      }
      // dS^T of both warpgroups visible to wgmma; the staging tile free once
      // the last reduce-add has read it
      fence_async_smem();
      if (threadIdx.x == 0) bulk_wait_read();
      named_bar(1, 128 * NC);

      // dK += dS^T Q (dS^T K-major, Q MN-major)
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        wgmma_ss<0, 1>(dk, desc(mine + ks * 32, 16, 1024),
                       desc(qs + ks * 16 * ROW, P::kQPanel, 1024), 1);
      wg_commit();

      // dQ += dS K over the block's 128 keys (dS and K MN-major), its
      // 64-column panels split between the warpgroups
      for (int p = wg; p < QP; p += NC) {
        float acc[32];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KEYS / 16; ++ks)
          wgmma_ss_n64<1, 1>(acc, desc(psb + ks * 16 * ROW, P::kPS, 1024),
                             desc(kb + p * P::kKPanel + ks * 16 * ROW, P::kKPanel, 1024),
                             ks > 0);
        wg_commit();
        wg_wait();
        pin(acc);
        stage_dq(c.sStg, p, threadIdx.x & 127, acc);
      }
      wg_wait();
      pin(dk);

      // the stage's Q, dO, LSE and D are read
      __syncwarp();
      if (lane == 0) mbar_arrive(c.empty0 + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }

      fence_async_smem();
      named_bar(2, 128 * NC);
      if (threadIdx.x == 0) bulk_reduce_add(dq_tile_of(c, rq, q0, DQ), c.sStg, P::kStaging);
    }
  }
  const int64_t slab = (int64_t)c.rk * c.bh + c.b;
  store_rows<DQ>(dk, c.dk_out, slab, c.t, c.d, kr, tq, c.scale);
  store_rows<DV>(dvacc, c.dv_out, slab, c.t, c.dv, kr, tq, 1.f);
  if (threadIdx.x == 0) bulk_wait();     // the last reduce-add has finished
}

// q/k 128 and 192, warpgroup A (threads 0-127) of a block of 64 keys: S^T,
// P^T into one of two buffers taken in turn, and dK += dS^T Q once B has
// written dS^T.
template <int DQ, int DV, int STAGES>
__device__ __forceinline__ void consume_a(const Block& c, int wi, int lane) {
  using P = Plan<DQ, DV, STAGES>;
  const int g = lane >> 2, tq = lane & 3;
  const int krow = 16 * wi + g;
  const int kr[2] = {c.k0 + krow, c.k0 + krow + 8};
  float dk[DQ / 2];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dk[i] = 0.f;

  mbar_wait(c.kv_full, 0);
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int rq = c.first_rank(); rq < c.n; ++rq) {
    const int shift = c.shift(rq);
    for (int q0 = c.first_row(rq); q0 < c.t; q0 += BQ) {
      mbar_wait(c.full0 + 8 * stage, phase);
      const uint32_t qs = c.sQ + stage * P::kStageQ;
      uint32_t kb = c.sK, psb = c.sPS;
      asm volatile("" : "+r"(kb), "+r"(psb));
      const uint32_t pt = psb + buf * P::kTileP, dst = psb + 2 * P::kTileP;
      const float* lse = reinterpret_cast<const float*>(c.stat + stage * P::kStat);

      float s[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DQ / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(s, desc(kb + (ks / 4) * P::kKPanel + col, 16, 1024),
                     desc(qs + (ks / 4) * P::kQPanel + col, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait();
      pin(s);
      if (c.masked(rq, q0, P::kKeys))
        p_tile<true>(s, pt, krow, lse, tq, c.scale_log2, kr, q0, c.t, shift);
      else
        p_tile<false>(s, pt, krow, lse, tq, c.scale_log2, kr, q0, c.t, shift);
      fence_async_smem();
      named_bar(1, 128 * NC);            // P^T written
      named_bar(2, 128 * NC);            // dS^T written

      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        wgmma_ss<0, 1>(dk, desc(dst + ks * 32, 16, 1024),
                       desc(qs + ks * 16 * ROW, P::kQPanel, 1024), 1);
      wg_commit();
      wg_wait();
      pin(dk);

      __syncwarp();
      if (lane == 0) mbar_arrive(c.empty0 + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      buf ^= 1;
    }
  }
  store_rows<DQ>(dk, c.dk_out, (int64_t)c.rk * c.bh + c.b, c.t, c.d, kr, tq, c.scale);
}

// Warpgroup B (threads 128-255): dP^T = V dO^T, dS^T once A has written
// P^T, then dV += P^T dO.
template <int DQ, int DV, int STAGES>
__device__ __forceinline__ void consume_b(const Block& c, int wi, int lane) {
  using P = Plan<DQ, DV, STAGES>;
  const int g = lane >> 2, tq = lane & 3;
  const int krow = 16 * wi + g;
  const int kr[2] = {c.k0 + krow, c.k0 + krow + 8};
  float dvacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dvacc[i] = 0.f;

  mbar_wait(c.kv_full, 0);
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int rq = c.first_rank(); rq < c.n; ++rq) {
    for (int q0 = c.first_row(rq); q0 < c.t; q0 += BQ) {
      mbar_wait(c.full0 + 8 * stage, phase);
      const uint32_t dos = c.sdO + stage * P::kStageDO;
      uint32_t vb = c.sV, psb = c.sPS;
      asm volatile("" : "+r"(vb), "+r"(psb));
      const uint32_t pt = psb + buf * P::kTileP, dst = psb + 2 * P::kTileP;
      const float* dsum = reinterpret_cast<const float*>(c.stat + stage * P::kStat) + BQ;

      float dp[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss_n64(dp, desc(vb + (ks / 4) * P::kKPanel + col, 16, 1024),
                     desc(dos + (ks / 4) * P::kQPanel + col, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait();
      pin(dp);
      named_bar(1, 128 * NC);            // P^T written

#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 D = *reinterpret_cast<const float2*>(dsum + 8 * j + 2 * tq);
        const float2 p01 = unpack(ld_shared_u32(ps_at(pt, krow, j, tq)));
        const float2 p23 = unpack(ld_shared_u32(ps_at(pt, krow + 8, j, tq)));
        st_shared_u32(ps_at(dst, krow, j, tq),
                      pack_rn(p01.x * (dp[4 * j] - D.x), p01.y * (dp[4 * j + 1] - D.y)));
        st_shared_u32(ps_at(dst, krow + 8, j, tq),
                      pack_rn(p23.x * (dp[4 * j + 2] - D.x), p23.y * (dp[4 * j + 3] - D.y)));
      }
      fence_async_smem();
      named_bar(2, 128 * NC);            // dS^T written

      // dV += P^T dO (P^T K-major, dO MN-major)
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks)
        wgmma_ss<0, 1>(dvacc, desc(pt + ks * 32, 16, 1024),
                       desc(dos + ks * 16 * ROW, P::kQPanel, 1024), 1);
      wg_commit();
      wg_wait();
      pin(dvacc);

      __syncwarp();
      if (lane == 0) mbar_arrive(c.empty0 + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      buf ^= 1;
    }
  }
  store_rows<DV>(dvacc, c.dv_out, (int64_t)c.rk * c.bh + c.b, c.t, c.dv, kr, tq, 1.f);
}

template <int DQ, int DV, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
attention_backward_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ stats, float* __restrict__ dq_acc,
                               uint16_t* __restrict__ dk_out, uint16_t* __restrict__ dv_out,
                               int n, int bh, int t, int d, int dv, int ntq, float scale_log2,
                               float scale, int causal) {
  using P = Plan<DQ, DV, STAGES>;
  constexpr int QP = P::kQP, VP = P::kVP, KEYS = P::kKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Block c;
  c.sK = (raw + 1023) & ~1023u;
  c.sV = c.sK + P::kK;
  c.sQ = c.sV + P::kV;
  c.sdO = c.sQ + STAGES * P::kStageQ;
  c.sPS = c.sdO + STAGES * P::kStageDO;
  c.sStg = c.sPS + P::kPS;
  const uint32_t sStat = c.sStg + P::kStaging;
  c.kv_full = sStat + STAGES * P::kStat;
  c.full0 = c.kv_full + 8;
  c.empty0 = c.full0 + 8 * STAGES;
  c.stat = smem_raw + (sStat - raw);
  c.dq_acc = dq_acc;
  c.dk_out = dk_out;
  c.dv_out = dv_out;
  c.n = n; c.bh = bh; c.t = t; c.d = d; c.dv = dv; c.ntq = ntq; c.causal = causal;
  c.scale_log2 = scale_log2;
  c.scale = scale;
  // heaviest first: blocks launch in blockIdx order (x fastest, z slowest),
  // and under the causal mask the earlier key tiles see more queries
  c.b = blockIdx.x;
  c.k0 = blockIdx.y * KEYS;
  c.rk = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(c.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(c.full0 + 8 * s, 1);
      mbar_init(c.empty0 + 8 * s, 4 * NC);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // ---- producer: K and V once, then Q, dO, LSE and D tile by tile ----
    if (lane == 0) {
      const int slab = c.rk * bh + c.b;
      mbar_expect_tx(c.kv_full, P::kK + P::kV);
      for (int p = 0; p < QP; ++p)
        for (int h = 0; h < KEYS / 64; ++h)
          tma_load(c.sK + p * P::kKPanel + h * 64 * ROW, &kmap, c.kv_full, 64 * p,
                   c.k0 + 64 * h, slab);
      for (int p = 0; p < VP; ++p)
        for (int h = 0; h < KEYS / 64; ++h)
          tma_load(c.sV + p * P::kKPanel + h * 64 * ROW, &vmap, c.kv_full, 64 * p,
                   c.k0 + 64 * h, slab);
      int stage = 0;
      uint32_t phase = 0;
      for (int rq = c.first_rank(); rq < n; ++rq) {
        for (int q0 = c.first_row(rq); q0 < t; q0 += BQ) {
          mbar_wait(c.empty0 + 8 * stage, phase ^ 1);
          const uint32_t bar = c.full0 + 8 * stage;
          mbar_expect_tx(bar, P::kStageQ + P::kStageDO + P::kStat);
          for (int p = 0; p < QP; ++p)
            tma_load(c.sQ + stage * P::kStageQ + p * P::kQPanel, &qmap, bar, 64 * p, q0,
                     rq * bh + c.b);
          for (int p = 0; p < VP; ++p)
            tma_load(c.sdO + stage * P::kStageDO + p * P::kQPanel, &domap, bar, 64 * p, q0,
                     rq * bh + c.b);
          bulk_load(sStat + stage * P::kStat,
                    stats + (((int64_t)rq * bh + c.b) * ntq + q0 / BQ) * 2 * BQ, P::kStat,
                    bar);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else if constexpr (P::kSplit) {
    if (warp < 4)
      consume_a<DQ, DV, STAGES>(c, warp, lane);
    else
      consume_b<DQ, DV, STAGES>(c, warp - 4, lane);
  } else {
    consume_whole<DQ, DV, STAGES>(c, warp, lane);
  }
}

// ---- the dQ pass (q/k 128 and 192) ------------------------------------------------

// One block per (128-row query tile, batch-head, rank), the heaviest first
// (rank n-1's later tiles, which see the most keys under the causal mask);
// a producer warp streams K and V tiles of 64 keys in ring-step order and
// two consumer warpgroups of 64 query rows each recompute, per key tile,
// S = Q K^T and P = 2^(S scale log2(e) - LSE) (their rows' LSE and D are
// registers), dP = dO V^T and dS = P (dP - D) in the accumulator layout,
// and dQ += dS K with dS from registers (the A fragments) and K MN-major.
// dQ stays in registers and is written once, scaled, so its sum order is
// fixed. A key tile wholly past a warpgroup's last row is skipped.
template <int DQ, int DV, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
attention_backward_sm90_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const __grid_constant__ CUtensorMap domap,
                                  const float* __restrict__ stats, uint16_t* __restrict__ dq,
                                  int n, int bh, int t, int d, int ntq, float scale_log2,
                                  float scale, int causal) {
  using P = DqPlan<DQ, DV, STAGES>;
  constexpr int QP = P::kQP, VP = P::kVP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + P::kQ;
  const uint32_t sK = sdO + P::kDO;
  const uint32_t sV = sK + STAGES * P::kTileK;
  const uint32_t q_full = sV + STAGES * P::kTileV;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * BQ;
  const int b = blockIdx.y;
  const int r = n - 1 - blockIdx.z;
  const int slab = r * bh + b;
  const int qend = min(q0 + 2 * BQ, t);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    if (lane == 0) {
      mbar_expect_tx(q_full, P::kQ + P::kDO);
      for (int p = 0; p < QP; ++p)
        for (int h = 0; h < 2; ++h)
          tma_load(sQ + p * P::kRowPanel + h * BQ * ROW, &qmap, q_full, 64 * p, q0 + BQ * h,
                   slab);
      for (int p = 0; p < VP; ++p)
        for (int h = 0; h < 2; ++h)
          tma_load(sdO + p * P::kRowPanel + h * BQ * ROW, &domap, q_full, 64 * p,
                   q0 + BQ * h, slab);
      int stage = 0;
      uint32_t phase = 0;
      for (int src = 0; src < n; ++src) {
        if (causal && src > r) break;            // wholly in the future
        const int kend = (causal && src == r) ? qend : t;
        for (int k0 = 0; k0 < kend; k0 += 64) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, P::kTileK + P::kTileV);
          for (int p = 0; p < QP; ++p)
            tma_load(sK + stage * P::kTileK + p * P::kKPanel, &kmap, bar, 64 * p, k0,
                     src * bh + b);
          for (int p = 0; p < VP; ++p)
            tma_load(sV + stage * P::kTileV + p * P::kKPanel, &vmap, bar, 64 * p, k0,
                     src * bh + b);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = q0 + wg * BQ;
    const int row_last = min(row0 + BQ, t) - 1;   // < row0 when every row is padding
    const bool active = row0 < t;
    int rq[2];
    rq[0] = row0 + 16 * wi + g;
    rq[1] = rq[0] + 8;
    float L[2], D[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* st = stats + ((int64_t)slab * ntq + rq[h] / BQ) * 2 * BQ + rq[h] % BQ;
      L[h] = rq[h] < t ? st[0] : 0.f;
      D[h] = rq[h] < t ? st[BQ] : 0.f;
    }
    float acc[QP][32];
#pragma unroll
    for (int p = 0; p < QP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int src = 0; src < n; ++src) {
      if (causal && src > r) break;
      const bool own = causal && src == r;
      const int kend = own ? qend : t;
      for (int k0 = 0; k0 < kend; k0 += 64) {
        mbar_wait(full0 + 8 * stage, phase);
        if (active && !(own && k0 > row_last)) {
          uint32_t qa = sQ + wg * BQ * ROW, oa = sdO + wg * BQ * ROW;
          asm volatile("" : "+r"(qa), "+r"(oa));
          const uint32_t kb = sK + stage * P::kTileK, vb = sV + stage * P::kTileV;

          // S = Q K^T
          float s[32];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < DQ / 16; ++ks) {
            const uint32_t col = (ks % 4) * 32;
            wgmma_ss_n64(s, desc(qa + (ks / 4) * P::kRowPanel + col, 16, 1024),
                         desc(kb + (ks / 4) * P::kKPanel + col, 16, 1024), ks > 0);
          }
          wg_commit();
          wg_wait();
          pin(s);

          // P, rounded to bfloat16 as the A fragments (keys past t, and under
          // the causal mask keys past the row, are 0)
          const bool masked = (own && k0 + 63 > row0) || k0 + 64 > t;
          uint32_t pa[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = ex2(fmaf(s[4 * j + e], scale_log2, -L[e >> 1]));
              const int key = k0 + 8 * j + 2 * tq + (e & 1);
              if (masked && (key >= t || (own && key > rq[e >> 1]))) p[e] = 0.f;
            }
            pa[j / 2][2 * (j % 2)] = pack_rn(p[0], p[1]);
            pa[j / 2][2 * (j % 2) + 1] = pack_rn(p[2], p[3]);
          }

          // dP = dO V^T
          float dp[32];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < DV / 16; ++ks) {
            const uint32_t col = (ks % 4) * 32;
            wgmma_ss_n64(dp, desc(oa + (ks / 4) * P::kRowPanel + col, 16, 1024),
                         desc(vb + (ks / 4) * P::kKPanel + col, 16, 1024), ks > 0);
          }
          wg_commit();
          wg_wait();
          pin(dp);

          // dS = P (dP - D), to bfloat16 in place of P
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 p01 = unpack(pa[j / 2][2 * (j % 2)]);
            const float2 p23 = unpack(pa[j / 2][2 * (j % 2) + 1]);
            pa[j / 2][2 * (j % 2)] =
                pack_rn(p01.x * (dp[4 * j] - D[0]), p01.y * (dp[4 * j + 1] - D[0]));
            pa[j / 2][2 * (j % 2) + 1] =
                pack_rn(p23.x * (dp[4 * j + 2] - D[1]), p23.y * (dp[4 * j + 3] - D[1]));
          }

          // dQ += dS K (K MN-major, one 64-column panel a product)
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int p = 0; p < QP; ++p)
              wgmma_rs(acc[p], pa[ks], desc(kb + p * P::kKPanel + ks * 16 * ROW, P::kKPanel,
                                             1024));
          wg_commit();
          wg_wait();
#pragma unroll
          for (int p = 0; p < QP; ++p) pin(acc[p]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }

    // dQ = scale * acc, rounded to bfloat16; rows past t and columns past d
    // are padding
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rq[h] >= t) continue;
      uint16_t* row = dq + ((int64_t)slab * t + rq[h]) * d;
#pragma unroll
      for (int p = 0; p < QP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * p + 8 * j + 2 * tq;
          if (c < d)
            *reinterpret_cast<uint32_t*>(row + c) =
                pack_rn(acc[p][4 * j + 2 * h] * scale, acc[p][4 * j + 2 * h + 1] * scale);
        }
    }
  }
}

// ---- host side ----------------------------------------------------------------------

// Floats of float32 scratch: at q/k 64 the dQ accumulator (64 rows by 64
// columns per query tile), then at every width each query tile's LSE and D.
template <int DQ>
static int64_t scratch_floats(int n, int bh, int t) {
  const int64_t tiles = (int64_t)n * bh * ((t + BQ - 1) / BQ);
  return (DQ == 64 ? tiles * BQ * DQ : 0) + tiles * 2 * BQ;
}

template <int DQ, int DV, int STAGES, int DQ_STAGES>
static int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, void* dq, void* dk, void* dv, float* scratch, int n,
                  int bh, int t, int d, int dvd, float scale, int causal, cudaStream_t s) {
  using PL = Plan<DQ, DV, STAGES>;
  const int ntq = (t + BQ - 1) / BQ;
  float* dq_acc = PL::kSplit ? nullptr : scratch;
  float* stats = scratch + (PL::kSplit ? 0 : (int64_t)n * bh * ntq * BQ * DQ);
  const dim3 tiles(n * bh, ntq);
  attention_backward_prep_kernel<DQ><<<tiles, kSmallThreads, 0, s>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout), lse, stats, dq_acc,
      t, dvd, ntq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kernel = attention_backward_sm90_kernel<DQ, DV, STAGES>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::kBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, n * bh, t, d) || !make_map(&km, k, n * bh, t, d) ||
      !make_map(&vm, v, n * bh, t, dvd) || !make_map(&dom, dout, n * bh, t, dvd))
    return TMT_EBADARG;
  const dim3 grid(bh, (t + PL::kKeys - 1) / PL::kKeys, n);
  kernel<<<grid, kThreads, PL::kBytes, s>>>(qm, km, vm, dom, stats, dq_acc,
                                            static_cast<uint16_t*>(dk),
                                            static_cast<uint16_t*>(dv), n, bh, t, d, dvd, ntq,
                                            scale * kLog2e, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if constexpr (PL::kSplit) {
    auto pass = attention_backward_sm90_dq_kernel<DQ, DV, DQ_STAGES>;
    const int smem = DqPlan<DQ, DV, DQ_STAGES>::kBytes;
    e = cudaFuncSetAttribute(pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 rows((t + 2 * BQ - 1) / (2 * BQ), bh, n);
    pass<<<rows, kThreads, smem, s>>>(qm, km, vm, dom, stats, static_cast<uint16_t*>(dq), n,
                                      bh, t, d, ntq, scale * kLog2e, scale, causal);
  } else {
    attention_backward_dq_cast_kernel<DQ><<<tiles, kSmallThreads, 0, s>>>(
        dq_acc, static_cast<uint16_t*>(dq), t, d, ntq, scale);
  }
  return (int)cudaGetLastError();
}

static bool takes(int n, int bh, int t, int d, int dv) {
  const bool same = d == dv && d <= 128;
  const bool latent = d > 128 && d <= 192 && dv > 64 && dv <= 128;
  return n >= 1 && n <= 65535 && bh >= 1 && bh <= 65535 && t >= 1 && d >= 8 &&
         d % 8 == 0 && dv % 8 == 0 && (same || latent) && (int64_t)n * bh <= INT32_MAX &&
         (t + BQ - 1) / BQ <= 65535;
}

}  // namespace sm90

// ---- C interface -----------------------------------------------------------------

// Floats of float32 scratch the launches need (0: arguments they do not
// take): at q/k up to 64 the dQ accumulator, 64 rows by 64 columns per query
// tile, then at every width LSE and D per query tile.
extern "C" int64_t tmt_attention_backward_sm90_scratch(int n, int bh, int t, int d, int dv) {
  if (!sm90::takes(n, bh, t, d, dv)) return 0;
  if (d > 128) return sm90::scratch_floats<192>(n, bh, t);
  if (d <= 64) return sm90::scratch_floats<64>(n, bh, t);
  return sm90::scratch_floats<128>(n, bh, t);
}

// d: the head dim of q, k and dq; dv: that of v, o, dO and the dv output.
// lse: (n, bh, t) float32 from the forward, in log2 units. scratch: at
// least tmt_attention_backward_sm90_scratch(...) floats, 16-byte aligned.
extern "C" int tmt_attention_backward_sm90(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const float* lse,
                                           void* dq, void* dk, void* dv, float* scratch,
                                           int n, int bh, int t, int d, int dvd, float scale,
                                           int causal, void* stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
                          (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv |
                          (uintptr_t)scratch;
  if (!sm90::takes(n, bh, t, d, dvd) || bases % 16 != 0 || (uintptr_t)lse % 4 != 0 || !q ||
      !k || !v || !o || !dout || !lse || !dq || !dk || !dv || !scratch)
    return TMT_EBADARG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128)
    return sm90::launch<192, 128, 3, 3>(q, k, v, o, dout, lse, dq, dk, dv, scratch, n, bh, t,
                                        d, dvd, scale, causal, s);
  if (d <= 64)
    return sm90::launch<64, 64, 3, 0>(q, k, v, o, dout, lse, dq, dk, dv, scratch, n, bh, t, d,
                                      dvd, scale, causal, s);
  return sm90::launch<128, 128, 3, 3>(q, k, v, o, dout, lse, dq, dk, dv, scratch, n, bh, t, d,
                                      dvd, scale, causal, s);
}

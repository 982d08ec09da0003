// Ring attention over a sequence sharded across n ranks that share one card,
// bfloat16, designed for Hopper: TMA feeds a ring of K/V tiles in shared
// memory, wgmma computes both products, and one producer warp keeps the
// loads in flight while two consumer warpgroups compute.
//
// Replaces tpu_mpi/xla/pallas_kernels.py:ring_attention
// (_ring_attention_kernel), as ring_attention.cu does; this kernel takes the
// bfloat16 calls whose head dim is a multiple of 8 and whose bases are
// 16-byte aligned (what a TMA tensor map needs). ring_attention.cu keeps the
// other bfloat16 head dims (mma.sync) and float32 (FMA at the TPU kernel's
// HIGHEST precision; TF32 wgmma would miss the float32 tolerance).
//
// The function is the Pallas kernel's and ring_attention.cu's: block
// (r - s) % n at ring step s, float32 state with m starting at -1e30,
// scores = (Q K^T in float32) * scale with masked keys -inf, P rounded to
// bfloat16 before P.V, out = acc / l rounded to bfloat16, and the same exact
// no-op skips under the causal mask (steps with src > r, and key tiles of the
// own block past the last row of a query warpgroup: every score -inf, so m,
// l and acc stay unchanged bit for bit). Two roundings differ from the
// plain version: key tiles of BK keys each take their own running max (as in
// ring_attention.cu), and exp is 2^x (ex2.approx, relative error below
// 2^-22) of the score times scale * log2(e), folded into one FMA, with m
// kept in log2 units. The bfloat16 bound of kernels/attention.py
// (allowed_error) does not depend on the tiling, and it carries 2^-6 of
// itself as slack for float32 sums and exp; tests/test_torch_attention.py
// replays this tiling and exp2 on the CPU against it.
//
// Bound on the card: Q, K, V read and O written once against 4 d flops per
// unmasked (query, key) pair; at the flagship shape the two are close (bytes
// 0.020 ms, operations 0.017 ms). At d = 64 the softmax's instructions, not
// the tensor cores, set the pace of a straightforward design. What the
// design does:
//  * TMA with a 128-byte swizzle, from 3-D tensor maps over (n BH, t, d)
//    with 64 x 64 boxes that zero-fill past each slab's t and past d, so no
//    thread computes an address or a bound for a load;
//  * a ring of STAGES K/V tiles with full/empty mbarriers: the producer warp
//    issues block src's tiles in ring-step order while the consumers work on
//    earlier ones;
//  * S = Q K^T as wgmma m64n64k16 over key tiles of BK = 64 (faster than
//    128 at the flagship shape) with Q and K from shared memory (K-major),
//    O += P V as wgmma m64nDPk16 with P from registers (the S accumulators
//    rounded to bfloat16 are the A fragment) and V through the descriptor's
//    transpose bit (V is (keys, d): MN-major);
//  * two consumer warpgroups of 64 query rows share each K/V tile, and at
//    d = 64 the kernel fits two blocks an SM, so four warpgroups interleave
//    their softmax with each other's tensor-core work;
//  * a lean softmax: exp as one ex2.approx instruction with the scale folded
//    into an FMA; the mask is a separate instantiation taken only by the
//    diagonal tiles of the own block and the ragged tail (one compare per
//    score against a per-row limit); O is rescaled only when some row of
//    the warp raised its max (otherwise every factor is exactly 1);
//  * the heaviest blocks first: rank n-1's query tiles, which walk the most
//    ring steps under the causal mask, and within a rank the later query
//    tiles, launch first.
// A key tile wholly past a warpgroup's last row is skipped by that
// warpgroup (it still releases the stage).
//
// Layout: q, k, v, out are (n, BH, t, d) contiguous bfloat16, d % 8 == 0,
// d <= 128. One block per (128-row query tile, batch-head, rank).
//
// C interface (bound with ctypes): returns 0 on success, the cudaError_t of a
// refused launch, or TMT_EBADARG for arguments the kernel does not take. It
// launches on the given stream and never synchronises. cuTensorMapEncodeTiled
// (libcuda) is reached through cudaGetDriverEntryPoint, so the library links
// no libcuda.

#include "fold_ops.cuh"
#include "mbarrier.cuh"
#include <cuda.h>         // CUtensorMap and its enums (types only)
#include <math.h>

namespace sm90 {

const int BM = 64;                    // query rows per consumer warpgroup
const int NC = 2;                     // consumer warpgroups per block
const int BK = 64;                    // keys per K/V tile
const int BOX = 64;                   // rows of one TMA box: BM queries or BK keys
static_assert(BM == BOX && BK == BOX, "one box per Q panel of a warpgroup and per K/V panel");
const int ROW = 128;                  // bytes of a box row: 64 bfloat16, one swizzle span
const int kThreads = 128 * NC + 32;   // consumers, then the producer warp
const float kMInit = -1e30f;          // the TPU kernel's running-max start
const float kLog2e = 1.4426950408889634f;

// ---- TMA (shared-memory addresses and mbarriers: mbarrier.cuh) ---------------

// One box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64nNk16, float32) = A B + scale_d d: A and B from shared memory, both
// K-major (ss, N = 64); or d += A B with A from registers and B MN-major (rs).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);     // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x in one MUFU instruction (exp2f adds a range fix-up of three more);
// ex2(-inf) = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one thread's two rows over one key tile: s
// holds the raw scores Q K^T (accumulator layout: s[4j + e] is row h = e / 2,
// column 8j + 2 tq + e % 2); on return m, l and corr are updated and pa
// holds P rounded to bfloat16 as the A fragments of P V (the accumulators
// of two 8-key groups are one 16-key step). MASK: keys past lim[h] (a
// column index of the tile) are -inf.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2], float (&corr)[2],
                                             const int (&lim)[2], int tq, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && 8 * j + 2 * tq + (e & 1) > lim[e >> 1]) s[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    neg[h] = -m_new;
    l[h] *= corr[h];
  }
  // p = 2^(s scale log2(e) - m), summed unrounded, then rounded to bfloat16
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(s[4 * j + e], scale_log2, neg[e >> 1]));
      l[e >> 1] += p[e];
    }
    pa[j / 2][2 * (j % 2)] = pack_rn(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_rn(p[2], p[3]);
  }
}

// ---- the kernel -------------------------------------------------------------------

// Shared memory of one block: Q (DP/64 column panels of NC*BM rows), STAGES
// K tiles, STAGES V tiles (DP/64 panels of BK rows each), the mbarriers, and
// slack to align the start to the 1024 bytes the swizzle repeats over.
template <int DP, int STAGES>
struct Plan {
  static constexpr int kPanels = DP / 64;
  static constexpr int kQPanel = NC * BM * ROW;
  static constexpr int kKPanel = BK * ROW;
  static constexpr int kTile = kPanels * kKPanel;
  static constexpr int kBars = 8 * (1 + 2 * STAGES);
  static constexpr int kBytes = kPanels * kQPanel + 2 * STAGES * kTile + kBars + 1024;
};

template <int DP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
ring_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           uint16_t* __restrict__ out, int n, int bh, int t, int d,
                           float scale_log2, int causal) {
  using P = Plan<DP, STAGES>;
  constexpr int OJ = DP / 8;          // 8-column groups of O
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + P::kPanels * P::kQPanel;
  const uint32_t sV = sK + STAGES * P::kTile;
  const uint32_t q_full = sV + STAGES * P::kTile;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  // heaviest first: blocks launch in blockIdx order (x fastest, z slowest)
  const int tiles = gridDim.x;
  const int q0 = (tiles - 1 - blockIdx.x) * NC * BM;
  const int b = blockIdx.y;
  const int r = n - 1 - blockIdx.z;
  const int qend = min(q0 + NC * BM, t);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // ---- producer: Q once, then K/V tiles of block src in ring-step order ----
    if (lane == 0) {
      mbar_expect_tx(q_full, P::kPanels * P::kQPanel);
      for (int p = 0; p < P::kPanels; ++p)
        for (int w = 0; w < NC; ++w)
          tma_load(sQ + p * P::kQPanel + w * BM * ROW, &qmap, q_full, 64 * p,
                   q0 + BM * w, r * bh + b);
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < n; ++step) {
        const int src = (r - step + n) % n;
        if (causal && src > r) continue;        // wholly in the future: exact no-op
        const int kend = (causal && src == r) ? qend : t;
        for (int k0 = 0; k0 < kend; k0 += BK) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, 2 * P::kTile);
          for (int p = 0; p < P::kPanels; ++p) {
            const uint32_t off = stage * P::kTile + p * P::kKPanel;
            tma_load(sK + off, &kmap, bar, 64 * p, k0, src * bh + b);
            tma_load(sV + off, &vmap, bar, 64 * p, k0, src * bh + b);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows row0 .. row0 + 63 ----
    const int wg = warp / 4;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = q0 + wg * BM;
    const int row_last = min(row0 + BM, t) - 1;   // < row0 when every row is padding
    const bool active = row0 < t;
    int rq[2];                                    // this thread's rows: g and g + 8
    rq[0] = row0 + 16 * (warp % 4) + g;
    rq[1] = rq[0] + 8;
    const uint32_t qa = sQ + wg * BM * ROW;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // m in log2 units (scores times scale * log2(e)); l a per-thread partial
    // row sum over this thread's columns, summed over the quad at the end
    float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int step = 0; step < n; ++step) {
      const int src = (r - step + n) % n;
      if (causal && src > r) continue;
      const bool own = causal && src == r;
      const int kend = own ? qend : t;
      for (int k0 = 0; k0 < kend; k0 += BK) {
        mbar_wait(full0 + 8 * stage, phase);
        if (active && !(own && k0 > row_last)) {
          const uint32_t kb = sK + stage * P::kTile, vb = sV + stage * P::kTile;
          float s[BK / 2];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < DP / 16; ++ks) {
            const uint32_t col = (ks % 4) * 32;     // 16 columns = 32 bytes
            wgmma_ss_n64(s, desc(qa + (ks / 4) * P::kQPanel + col, 16, 1024),
                         desc(kb + (ks / 4) * P::kKPanel + col, 16, 1024), ks > 0);
          }
          wg_commit();
          wg_wait();
          pin(s);

          // mask only the diagonal tiles of the own block and the ragged
          // tail; lim[h]: the last key column row h sees in this tile
          uint32_t pa[BK / 16][4];
          float corr[2];
          if (k0 + BK > t || (own && k0 + BK - 1 > row0)) {
            int lim[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              lim[h] = own ? min(rq[h], t - 1) - k0 : t - 1 - k0;
            softmax_tile<true>(s, pa, m, l, corr, lim, tq, scale_log2);
          } else {
            const int lim[2] = {BK, BK};
            softmax_tile<false>(s, pa, m, l, corr, lim, tq, scale_log2);
          }
          // O *= corr; skipped where every row of the warp kept its max
          // (corr exactly 1: the product would change no bit)
          if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
            for (int j = 0; j < OJ; ++j) {
              o[4 * j] *= corr[0];
              o[4 * j + 1] *= corr[0];
              o[4 * j + 2] *= corr[1];
              o[4 * j + 3] *= corr[1];
            }
          }
          pin(o);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks)
            wgmma_rs(o, pa[ks], desc(vb + ks * 16 * ROW, P::kKPanel, 1024));
          wg_commit();
          wg_wait();
          pin(o);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }

    // out = acc / l, rounded to bfloat16; rows past t and columns past d are
    // padding
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    uint16_t* ob = out + ((int64_t)r * bh + b) * t * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rq[h] >= t) continue;
      uint16_t* orow = ob + (int64_t)rq[h] * d;
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < d)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_rn(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;     // set once; a race only repeats the lookup
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (slabs, t, d) bfloat16 as a 3-D tensor map, innermost first, with 64 x 64
// boxes and the 128-byte swizzle; TMA fills zeros past t and past d.
static bool make_map(CUtensorMap* map, const void* base, int slabs, int t, int d) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)slabs};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  cuuint32_t box[3] = {64, BOX, 1};
  cuuint32_t elems[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int STAGES>
static int launch(const void* q, const void* k, const void* v, void* out, int n, int bh,
                  int t, int d, float scale, int causal, cudaStream_t s) {
  auto kernel = ring_attention_sm90_kernel<DP, STAGES>;
  const int smem = Plan<DP, STAGES>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, n * bh, t, d) || !make_map(&km, k, n * bh, t, d) ||
      !make_map(&vm, v, n * bh, t, d))
    return TMT_EBADARG;
  dim3 grid((t + NC * BM - 1) / (NC * BM), bh, n);
  kernel<<<grid, kThreads, smem, s>>>(qm, km, vm, static_cast<uint16_t*>(out), n, bh, t,
                                      d, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// ---- C interface -----------------------------------------------------------------

extern "C" int tmt_ring_attention_sm90(const void* q, const void* k, const void* v,
                                       void* out, int n, int bh, int t, int d, float scale,
                                       int causal, void* stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  if (n < 1 || n > 65535 || bh < 1 || bh > 65535 || t < 1 || d < 8 || d > 128 ||
      d % 8 != 0 || (int64_t)n * bh > INT32_MAX || bases % 16 != 0 || !q || !k || !v || !out)
    return TMT_EBADARG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return sm90::launch<64, 4>(q, k, v, out, n, bh, t, d, scale, causal, s);
  return sm90::launch<128, 3>(q, k, v, out, n, bh, t, d, scale, causal, s);
}

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
// Layout: q and k are (n, BH, t, d), v and out (n, BH, t, dv), contiguous
// bfloat16, d and dv multiples of 8: d == dv <= 128, or the latent-attention
// shape d <= 192 beside dv <= 128 (query/key heads of 128 + 64 rotary
// columns, value heads of 128), where v is taken at its own width and not
// padded to d. One block per (128-row query tile, batch-head, rank).
//
// The launch may also write each row's log-sum-exp, m + log2(l) in the
// kernel's log2 units (scores times scale * log2(e)), once per row in the
// epilogue, for the backward; a null pointer writes nothing, so the other
// callers keep their cost.
//
// C interface (bound with ctypes): returns 0 on success, the cudaError_t of a
// refused launch, or TMT_EBADARG for arguments the kernel does not take. It
// launches on the given stream and never synchronises. cuTensorMapEncodeTiled
// (libcuda) is reached through cudaGetDriverEntryPoint, so the library links
// no libcuda.

#include "sm90.cuh"        // TMA, wgmma, packing, the tensor-map encoder
#include <math.h>

namespace sm90 {

const int BM = 64;                    // query rows per consumer warpgroup
const int NC = 2;                     // consumer warpgroups per block
const int BK = 64;                    // keys per K/V tile
static_assert(BM == BOX && BK == BOX, "one box per Q panel of a warpgroup and per K/V panel");
const int kThreads = 128 * NC + 32;   // consumers, then the producer warp
const float kMInit = -1e30f;          // the TPU kernel's running-max start
const float kLog2e = 1.4426950408889634f;

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

// Shared memory of one block: Q (DQ/64 column panels of NC*BM rows), STAGES
// K tiles (DQ/64 panels of BK rows each), STAGES V tiles (DV/64 panels), the
// mbarriers, and slack to align the start to the 1024 bytes the swizzle
// repeats over.
template <int DQ, int DV, int STAGES>
struct Plan {
  static constexpr int kQPanels = DQ / 64;
  static constexpr int kVPanels = DV / 64;
  static constexpr int kQPanel = NC * BM * ROW;
  static constexpr int kKPanel = BK * ROW;
  static constexpr int kTileK = kQPanels * kKPanel;
  static constexpr int kTileV = kVPanels * kKPanel;
  static constexpr int kBars = 8 * (1 + 2 * STAGES);
  static constexpr int kBytes =
      kQPanels * kQPanel + STAGES * (kTileK + kTileV) + kBars + 1024;
};

template <int DQ, int DV, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
ring_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           uint16_t* __restrict__ out, float* __restrict__ lse, int n,
                           int bh, int t, int dv, float scale_log2, int causal) {
  using P = Plan<DQ, DV, STAGES>;
  constexpr int OJ = DV / 8;          // 8-column groups of O
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + P::kQPanels * P::kQPanel;
  const uint32_t sV = sK + STAGES * P::kTileK;
  const uint32_t q_full = sV + STAGES * P::kTileV;
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
      mbar_expect_tx(q_full, P::kQPanels * P::kQPanel);
      for (int p = 0; p < P::kQPanels; ++p)
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
          mbar_expect_tx(bar, P::kTileK + P::kTileV);
          for (int p = 0; p < P::kQPanels; ++p)
            tma_load(sK + stage * P::kTileK + p * P::kKPanel, &kmap, bar, 64 * p, k0,
                     src * bh + b);
          for (int p = 0; p < P::kVPanels; ++p)
            tma_load(sV + stage * P::kTileV + p * P::kKPanel, &vmap, bar, 64 * p, k0,
                     src * bh + b);
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

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
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
          const uint32_t kb = sK + stage * P::kTileK, vb = sV + stage * P::kTileV;
          float s[BK / 2];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < DQ / 16; ++ks) {
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

    // out = acc / l, rounded to bfloat16; rows past t and columns past dv
    // are padding
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    // the rows' log-sum-exp in the kernel's log2 units, m + log2(l), for the
    // backward (attention_backward_sm90.cu); a null lse writes nothing
    if (lse != nullptr && tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rq[h] < t) lse[((int64_t)r * bh + b) * t + rq[h]] = m[h] + log2f(l[h]);
    }
    uint16_t* ob = out + ((int64_t)r * bh + b) * t * dv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rq[h] >= t) continue;
      uint16_t* orow = ob + (int64_t)rq[h] * dv;
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < dv)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_rn(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------------

template <int DQ, int DV, int STAGES>
static int launch(const void* q, const void* k, const void* v, void* out, float* lse, int n,
                  int bh, int t, int d, int dv, float scale, int causal, cudaStream_t s) {
  auto kernel = ring_attention_sm90_kernel<DQ, DV, STAGES>;
  const int smem = Plan<DQ, DV, STAGES>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, n * bh, t, d) || !make_map(&km, k, n * bh, t, d) ||
      !make_map(&vm, v, n * bh, t, dv))
    return TMT_EBADARG;
  dim3 grid((t + NC * BM - 1) / (NC * BM), bh, n);
  kernel<<<grid, kThreads, smem, s>>>(qm, km, vm, static_cast<uint16_t*>(out), lse, n, bh,
                                      t, dv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// ---- C interface -----------------------------------------------------------------

// d: the head dim of q and k; dv: that of v and out. d == dv <= 128, or
// 128 < d <= 192 beside 64 < dv <= 128 (latent attention). lse: null, or
// (n, bh, t) float32 that receives each row's log-sum-exp in log2 units.
extern "C" int tmt_ring_attention_sm90(const void* q, const void* k, const void* v,
                                       void* out, float* lse, int n, int bh, int t, int d,
                                       int dv, float scale, int causal, void* stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  const bool same = d == dv && d <= 128;
  const bool latent = d > 128 && d <= 192 && dv > 64 && dv <= 128;
  if (n < 1 || n > 65535 || bh < 1 || bh > 65535 || t < 1 || d < 8 || d % 8 != 0 ||
      dv % 8 != 0 || !(same || latent) || (int64_t)n * bh > INT32_MAX || bases % 16 != 0 ||
      !q || !k || !v || !out)
    return TMT_EBADARG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (latent)
    return sm90::launch<192, 128, 3>(q, k, v, out, lse, n, bh, t, d, dv, scale, causal, s);
  if (d <= 64)
    return sm90::launch<64, 64, 4>(q, k, v, out, lse, n, bh, t, d, dv, scale, causal, s);
  return sm90::launch<128, 128, 3>(q, k, v, out, lse, n, bh, t, d, dv, scale, causal, s);
}

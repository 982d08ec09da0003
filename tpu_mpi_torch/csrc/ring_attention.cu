// Ring attention over a sequence sharded across n ranks that share one card:
// every rank's queries attend to the keys and values of all n sequence
// blocks, with a causal mask by global position if asked.
//
// Replaces tpu_mpi/xla/pallas_kernels.py:ring_attention
// (_ring_attention_kernel).
//
// The TPU kernel keeps a rank's (t, d) blocks of Q, K, V in VMEM and passes
// the K/V block around the ring by remote DMA: at step s rank r holds the
// block of rank (r - s) % n and folds it into an online softmax over Q
// panels (state m, l, acc in float32, m starting at -1e30, scores scaled in
// float32, masked keys -inf, P rounded to the input dtype before P.V). On one
// card every rank's K/V block already lies in HBM, so there is no hop: the
// thread block that owns a query tile of rank r reads block (r - s) % n
// directly at step s, in the same ring order, and folds it the same way.
//
// Arithmetic, as in the TPU kernel:
//   scores = (Q K^T) * scale in float32 (bfloat16 inputs: exact products,
//   float32 accumulation on the tensor cores; float32 inputs: float32 FMA,
//   the TPU kernel's HIGHEST precision); masked or ragged keys = -inf;
//   m_new = max(m, rowmax); corr = exp(m - m_new); p = exp(s - m_new);
//   l = l * corr + rowsum(p); acc = acc * corr + round(p) V; out = acc / l.
// The TPU kernel folds a whole (bq, t) panel per ring step; this kernel folds
// key tiles of 32 (bfloat16) or 16 (float32) keys, each with its own running
// max: the same function, rounded at other places, so it is held to a stated
// tolerance against the plain version, not to bits.
//
// Causal skipping. A ring step whose block lies wholly after every query of
// the rank (src > r), and the key tiles of the own block that lie after the
// query tile's last row, are masked for every row. In the TPU schedule such
// a panel is an exact no-op: all its scores are -inf, so m_new = m (m is
// finite), corr = exp(0) = 1 and p = exp(-inf) = 0, which leaves m, l and
// acc unchanged bit for bit. Skipping them changes no bit of the result.
//
// Bound on the card: bytes or operations, whichever is larger: Q, K, V read
// and O written once (4 n BH t d elements), against 4 d flops per unmasked
// (query, key) pair at the tensor-core rate. At the flagship shapes the two
// are close; this first kernel is far from either (see PERF.md): it loads
// tiles with plain loads into shared memory and multiplies with mma.sync,
// where a later kernel would use TMA and wgmma and keep K/V tiles in flight.
//
// Layout: q, k, v, out are (n, BH, t, d) contiguous, d <= 128. One thread
// block per (query tile, batch-head, rank).
//
// C interface (bound with ctypes): returns 0 on success, the cudaError_t of a
// refused launch, or TMT_EBADARG for arguments the kernel does not take. It
// launches on the given stream and never synchronises.

#include "fold_ops.cuh"
#include <math.h>

#define TMT_MAX_HEAD_DIM 128

static const float kMInit = -1e30f;     // the TPU kernel's running-max start

// ---- bfloat16: mma.sync m16n8k16, float32 accumulation --------------------------

namespace bf16k {

const int BQ = 64;          // query rows per block: 4 warps x 16 rows
const int BK = 32;          // keys per tile
const int kThreads = 128;

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);     // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a * b for one 16x8x16 tile (a: 16x16 row-major, b: 16x8 col-major).
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows x DP tile of a (t, d) slab into shared memory (row stride LD), zeros
// past row t and column d. VEC: d % 8 == 0 and 16-byte aligned rows, moved
// as 8 bfloat16 at a time.
template <int DP, int LD, bool VEC>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int rows, int t, int d) {
  if (VEC) {
    const int chunks = DP / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * 8;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (row0 + r < t && c < d)
        w = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * d + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = w;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (row0 + r < t && c < d)
                            ? src[(int64_t)(row0 + r) * d + c] : (uint16_t)0;
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
ring_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                      int n, int bh, int t, int d, float scale, int causal) {
  constexpr int LD = DP + 8;            // padded row stride (bank spread)
  constexpr int KS = DP / 16;           // k-steps of Q K^T
  constexpr int NT = BK / 8;            // 8-key tiles of S per key tile
  constexpr int DT = DP / 8;            // 8-column tiles of O
  __shared__ __align__(16) uint16_t Qs[BQ * LD];
  __shared__ __align__(16) uint16_t Ks[BK * LD];
  __shared__ __align__(16) uint16_t Vs[BK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;     // mma group and thread in group
  const int r = blockIdx.z, b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int64_t slab = (int64_t)t * d;
  const int64_t mine = ((int64_t)r * bh + b) * slab;

  load_tile<DP, LD, VEC>(Qs, q + mine, q0, BQ, t, d);
  __syncthreads();
  // this warp's 16 query rows as mma A fragments, for the whole run
  uint32_t qa[KS][4];
  const uint16_t* qw = Qs + (warp * 16) * LD;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    qa[s][0] = ld32(qw + g * LD + s * 16 + 2 * tq);
    qa[s][1] = ld32(qw + (g + 8) * LD + s * 16 + 2 * tq);
    qa[s][2] = ld32(qw + g * LD + s * 16 + 8 + 2 * tq);
    qa[s][3] = ld32(qw + (g + 8) * LD + s * 16 + 8 + 2 * tq);
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // the two query rows this thread holds: h = 0 row g, h = 1 row g + 8
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};
  int64_t qg[2];
  qg[0] = (int64_t)r * t + q0 + warp * 16 + g;
  qg[1] = qg[0] + 8;
  const int q_last = min(q0 + BQ, t) - 1;

  for (int step = 0; step < n; ++step) {
    const int src = (r - step + n) % n;       // the block rank r holds at this step
    if (causal && src > r) continue;          // wholly in the future: exact no-op
    const int kend = (causal && src == r) ? q_last + 1 : t;
    const uint16_t* kb = k + ((int64_t)src * bh + b) * slab;
    const uint16_t* vb = v + ((int64_t)src * bh + b) * slab;
    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();                        // the last tile's readers are done
      load_tile<DP, LD, VEC>(Ks, kb, k0, BK, t, d);
      load_tile<DP, LD, VEC>(Vs, vb, k0, BK, t, d);
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x BK keys
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        const uint16_t* kr = Ks + (j * 8 + g) * LD;
#pragma unroll
        for (int s = 0; s < KS; ++s)
          mma(sc[j], qa[s], ld32(kr + s * 16 + 2 * tq), ld32(kr + s * 16 + 8 + 2 * tq));
      }
      // scale, mask, row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          const int64_t kg = (int64_t)src * t + key;
          float s = sc[j][e] * scale;
          if (key >= t || (causal && kg > qg[h])) s = -INFINITY;
          sc[j][e] = s;
          mx[h] = fmaxf(mx[h], s);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
      // p = exp(s - m_new), row sums of the unrounded p
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * corr[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= corr[0]; o[j][1] *= corr[0];
        o[j][2] *= corr[1]; o[j][3] *= corr[1];
      }
      // O += round_bf16(P) V: the S accumulators of two 8-key tiles are the
      // A fragment of one 16-key step
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        uint32_t pa[4];
        pa[0] = pack_rn(sc[2 * s][0], sc[2 * s][1]);
        pa[1] = pack_rn(sc[2 * s][2], sc[2 * s][3]);
        pa[2] = pack_rn(sc[2 * s + 1][0], sc[2 * s + 1][1]);
        pa[3] = pack_rn(sc[2 * s + 1][2], sc[2 * s + 1][3]);
        const uint16_t* v0 = Vs + (s * 16 + 2 * tq) * LD;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int c = j * 8 + g;
          mma(o[j], pa, pack(v0[c], v0[LD + c]), pack(v0[8 * LD + c], v0[9 * LD + c]));
        }
      }
    }
  }

  // out = acc / l, rounded to bfloat16; rows past t and columns past d are
  // padding
  uint16_t* ob = out + mine;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * tq + e;
        if (c < d) {
          __nv_bfloat16 y = __float2bfloat16_rn(o[j][2 * h + e] / l[h]);
          ob[(int64_t)row * d + c] = *reinterpret_cast<uint16_t*>(&y);
        }
      }
    }
  }
}

template <int DP>
static int launch(const void* q, const void* k, const void* v, void* out, int n,
                  int bh, int t, int d, float scale, int causal, cudaStream_t s) {
  dim3 grid((t + BQ - 1) / BQ, bh, n);
  const bool vec = d % 8 == 0 &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16) == 0;
  const uint16_t *qq = static_cast<const uint16_t*>(q), *kk = static_cast<const uint16_t*>(k),
                 *vv = static_cast<const uint16_t*>(v);
  uint16_t* oo = static_cast<uint16_t*>(out);
  if (vec)
    ring_attention_kernel<DP, true><<<grid, kThreads, 0, s>>>(qq, kk, vv, oo, n, bh, t, d,
                                                              scale, causal);
  else
    ring_attention_kernel<DP, false><<<grid, kThreads, 0, s>>>(qq, kk, vv, oo, n, bh, t, d,
                                                               scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace bf16k

// ---- float32: FMA ----------------------------------------------------------------

namespace f32k {

const int BQ = 32;          // query rows per block: 4 threads per row
const int BK = 16;          // keys per tile
const int kThreads = 128;

template <int DP>
__global__ void __launch_bounds__(kThreads)
ring_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int n, int bh, int t, int d, float scale, int causal) {
  constexpr int KPT = BK / 4;           // scores per thread and tile
  constexpr int CPT = DP / 4;           // output columns per thread
  __shared__ float Qs[BQ][DP + 1];
  __shared__ float Ks[BK][DP + 1];
  __shared__ float Vs[BK][DP];
  __shared__ float Ps[BQ][BK + 1];

  const int row = threadIdx.x >> 2;     // the tile row this thread works on
  const int quad = threadIdx.x & 3;     // its key and column phase
  const int r = blockIdx.z, b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int64_t slab = (int64_t)t * d;
  const int64_t mine = ((int64_t)r * bh + b) * slab;

  for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
    const int rr = i / DP, c = i % DP;
    Qs[rr][c] = (q0 + rr < t && c < d) ? q[mine + (int64_t)(q0 + rr) * d + c] : 0.f;
  }
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = kMInit, l = 0.f;
  const int64_t qg = (int64_t)r * t + q0 + row;
  const int q_last = min(q0 + BQ, t) - 1;

  for (int step = 0; step < n; ++step) {
    const int src = (r - step + n) % n;
    if (causal && src > r) continue;          // wholly in the future: exact no-op
    const int kend = (causal && src == r) ? q_last + 1 : t;
    const float* kb = k + ((int64_t)src * bh + b) * slab;
    const float* vb = v + ((int64_t)src * bh + b) * slab;
    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();
      for (int i = threadIdx.x; i < BK * DP; i += kThreads) {
        const int rr = i / DP, c = i % DP;
        const bool ok = k0 + rr < t && c < d;
        Ks[rr][c] = ok ? kb[(int64_t)(k0 + rr) * d + c] : 0.f;
        Vs[rr][c] = ok ? vb[(int64_t)(k0 + rr) * d + c] : 0.f;
      }
      __syncthreads();
      float s[KPT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = quad + 4 * j;
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < DP; ++c) dot = fmaf(Qs[row][c], Ks[kk][c], dot);
        float sc = dot * scale;
        const int key = k0 + kk;
        if (key >= t || (causal && (int64_t)src * t + key > qg)) sc = -INFINITY;
        s[j] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Ps[row][quad + 4 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l = l * corr + sum;
      m = m_new;
      __syncwarp();                           // the row's four threads wrote Ps
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = quad + 4 * j;
        float pv = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) pv = fmaf(Ps[row][kk], Vs[kk][c], pv);
        acc[j] = acc[j] * corr + pv;
      }
    }
  }

  const int qi = q0 + row;
  if (qi < t) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = quad + 4 * j;
      if (c < d) out[mine + (int64_t)qi * d + c] = acc[j] / l;
    }
  }
}

template <int DP>
static int launch(const void* q, const void* k, const void* v, void* out, int n,
                  int bh, int t, int d, float scale, int causal, cudaStream_t s) {
  dim3 grid((t + BQ - 1) / BQ, bh, n);
  ring_attention_kernel<DP><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, bh, t, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace f32k

// ---- C interface -----------------------------------------------------------------

extern "C" int tmt_ring_attention(const void* q, const void* k, const void* v,
                                  void* out, int n, int bh, int t, int d,
                                  float scale, int causal, int dtype, void* stream) {
  if (n < 1 || n > 65535 || bh < 1 || bh > 65535 || t < 1 || d < 1 ||
      d > TMT_MAX_HEAD_DIM || !q || !k || !v || !out)
    return TMT_EBADARG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (dtype == DT_BF16) {
    switch (dp) {
      case 16: return bf16k::launch<16>(q, k, v, out, n, bh, t, d, scale, causal, s);
      case 32: return bf16k::launch<32>(q, k, v, out, n, bh, t, d, scale, causal, s);
      case 64: return bf16k::launch<64>(q, k, v, out, n, bh, t, d, scale, causal, s);
      default: return bf16k::launch<128>(q, k, v, out, n, bh, t, d, scale, causal, s);
    }
  }
  if (dtype == DT_F32) {
    switch (dp) {
      case 16: return f32k::launch<16>(q, k, v, out, n, bh, t, d, scale, causal, s);
      case 32: return f32k::launch<32>(q, k, v, out, n, bh, t, d, scale, causal, s);
      case 64: return f32k::launch<64>(q, k, v, out, n, bh, t, d, scale, causal, s);
      default: return f32k::launch<128>(q, k, v, out, n, bh, t, d, scale, causal, s);
    }
  }
  return TMT_EBADARG;
}

// Ring collectives of n ranks that share one card: allreduce, reduce-scatter
// and allgather over the stacked per-rank tensor (rank axis first).
//
// Replaces, in tpu_mpi/xla/pallas_kernels.py:
//   ring_allreduce      (_ring_allreduce_kernel)
//   ring_reduce_scatter (_ring_reduce_scatter_kernel)
//   ring_allgather      (_ring_allgather_kernel)
//
// The TPU kernels move each ring chunk between chips by remote DMA, n-1
// hops per phase, with barrier semaphores between hops. On one card every
// rank's buffer already lies in the same HBM, so a hop would only copy a
// chunk through that HBM once more. These kernels therefore compute, in one
// pass, the value each TPU kernel leaves on each rank, with the same bits:
// the same operands combined in the same order, each step one Step<T, OP> of
// fold_ops.cuh (rounded as PyTorch's CUDA op rounds).
//
//   allreduce: element e lies in ring chunk c = e / chunk (chunk from the
//     TPU kernel's padded (rows, 128) layout, computed by the wrapper). Its
//     fold starts at rank c and walks the ring: acc = x[c][e], then
//     acc = op(x[(c+k) % n][e], acc) for k = 1..n-1 (the own value first, as
//     the TPU kernel's combine(own, incoming)); every rank gets acc.
//   reduce-scatter: rank c's block of `per` elements is the fold that starts
//     at rank c+1: acc = x[(c+1) % n][i], then acc = op(x[(c+k) % n][i], acc)
//     for k = 2..n.
//   allgather: out[r][s] = x[s] for every r and s, a broadcast copy.
//
// Bound on the card: bytes. Allreduce reads n*S and writes n*S bytes
// (S = one rank's tensor); reduce-scatter reads n*S and writes S; allgather
// reads n*s and writes n*n*s (s = one rank's shard). Each does at most n-1
// cheap operations per element. The design keeps HBM busy: allreduce and
// allgather are grid-stride loops, neighbouring threads on neighbouring
// addresses, 16-byte accesses wherever the pointers and the row lengths
// allow (the scalar form otherwise), and operands addressed from one base
// pointer and a rank stride, so no pointer table is read from memory;
// reduce-scatter stages its tiles in shared memory with bulk asynchronous
// copies where it can (see its section).
//
// C interface (bound with ctypes): each function returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.
// The output never overlaps the input (the wrapper allocates it).

#include "fold_ops.cuh"
#include "mbarrier.cuh"

static const int kThreads = 256;

// ---- allreduce -----------------------------------------------------------------

// V divides count and chunk, so a group of V never straddles a ring chunk.
template <typename T, int OP, int V>
__global__ void ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      int n, int64_t count, int64_t chunk) {
  typedef Vec<T, V> W;
  const int64_t groups = count / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const int64_t e = g * V;
    int r = (int)(e / chunk);            // the chunk, and the rank its fold starts at
    W acc = *reinterpret_cast<const W*>(x + r * count + e);
    for (int k = 1; k < n; ++k) {
      r = (r + 1 == n) ? 0 : r + 1;
      const W own = *reinterpret_cast<const W*>(x + r * count + e);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(own.v[j], acc.v[j]);
    }
    for (int q = 0; q < n; ++q) *reinterpret_cast<W*>(out + q * count + e) = acc;
  }
}

template <typename T, int OP>
struct AllreduceLaunch {
  static int run(const void* x, void* out, int n, int64_t count, int64_t chunk,
                 cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (aligned(x, 16) && aligned(out, 16) && count % V == 0 && chunk % V == 0)
      ring_allreduce_kernel<T, OP, V><<<grid_for(count / V, kThreads), kThreads, 0, s>>>(
          xt, ot, n, count, chunk);
    else
      ring_allreduce_kernel<T, OP, 1><<<grid_for(count, kThreads), kThreads, 0, s>>>(
          xt, ot, n, count, chunk);
    return (int)cudaGetLastError();
  }
};

// ---- reduce-scatter ------------------------------------------------------------
//
// One rank's input row holds n blocks of `per`; the output (n blocks of
// `per`) takes block c from the fold of block c of every row, in ring order
// from rank c+1. The work is cut into tiles, each a contiguous span of one
// block, so the rank a fold starts at is found once per tile, never per
// element.
//
// Staged route (16-byte-aligned bases, blocks of whole 16-byte words, and n
// small enough to stage): one CTA per tile. Its first thread issues the n
// slices of the tile as 1-D bulk asynchronous copies (the TMA) into shared
// memory, rank (c+1+k) % n into slot k, all completed on one mbarrier by
// the bytes they carry; every thread then folds the slots in order, 16
// bytes at a time, and writes the result with streaming 16-byte stores
// (the output is written once and never read here). No thread spends
// registers or instructions on the loads, so a CTA is small (kSliceBudget
// bytes of shared memory for all n slices) and several are resident on
// each SM: their copies overlap each other's folds, and the hardware hands
// each free SM the next tile. (A persistent grid of one CTA per SM walking
// the tiles with a static stride through a ring of four stages measured no
// faster than 16-byte loads; the fewer tiles a CTA took, the faster the
// kernel ran. PERF.md, section 6.)
//
// Direct route (blocks that are not whole 16-byte words, an unaligned base,
// or an n whose slices would fall under kMinSlice bytes): the same tiles,
// each thread loading its V-element groups of the tile straight from HBM,
// 16-byte groups where the words allow.

namespace rs {

const int kDirectGroups = 4;           // V-groups a thread takes per direct tile

// Tile t: output block c, its first element e0, and its length.
struct Tile {
  int c;
  int64_t e0, len;
  __device__ __forceinline__ Tile(int64_t t, int64_t tiles_per_block, int64_t tile,
                                  int64_t per) {
    c = (int)(t / tiles_per_block);
    e0 = (t - (int64_t)c * tiles_per_block) * tile;
    len = per - e0 < tile ? per - e0 : tile;
  }
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int64_t per,
              int64_t tile, int64_t tiles_per_block) {
  constexpr int V = 16 / sizeof(T);
  typedef Vec<T, V> W;
  extern __shared__ __align__(16) uint8_t slots[];  // n slices, then the mbarrier
  const Tile tl(blockIdx.x, tiles_per_block, tile, per);
  const uint32_t bar = smem_u32(slots) + (uint32_t)(n * tile * sizeof(T));
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(tl.len * sizeof(T));
    const uint32_t slice = (uint32_t)(tile * sizeof(T));
    const int64_t total = (int64_t)n * per;
    const T* src = x + (int64_t)tl.c * per + tl.e0;
    mbar_expect_tx(bar, (uint32_t)n * bytes);
    int r = tl.c + 1 == n ? 0 : tl.c + 1;
    for (int k = 0; k < n; ++k) {
      bulk_load(smem_u32(slots) + k * slice, src + r * total, bytes, bar);
      r = r + 1 == n ? 0 : r + 1;
    }
  }
  const int groups = (int)(tl.len / V);
  const int stride = (int)(tile / V);                // words between slots
  const W* slot = reinterpret_cast<const W*>(slots);
  W* o = reinterpret_cast<W*>(out + (int64_t)tl.c * per + tl.e0);
  mbar_wait(bar, 0);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    W acc = slot[g];
    for (int k = 1; k < n; ++k) {
      const W own = slot[k * stride + g];
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(own.v[j], acc.v[j]);
    }
    store_streaming(o + g, acc);
  }
}

// One CTA per tile. V divides per and tile, so a group never straddles a
// block or a tile.
template <typename T, int OP, int V>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int64_t per,
              int64_t tile, int64_t tiles_per_block) {
  typedef Vec<T, V> W;
  const Tile tl(blockIdx.x, tiles_per_block, tile, per);
  const int64_t total = (int64_t)n * per;
  const T* src = x + (int64_t)tl.c * per + tl.e0;
  T* o = out + (int64_t)tl.c * per + tl.e0;
  const int r0 = tl.c + 1 == n ? 0 : tl.c + 1;
  for (int64_t e = (int64_t)threadIdx.x * V; e < tl.len; e += kThreads * V) {
    int r = r0;
    W acc = *reinterpret_cast<const W*>(src + r * total + e);
    for (int k = 1; k < n; ++k) {
      r = r + 1 == n ? 0 : r + 1;
      const W own = *reinterpret_cast<const W*>(src + r * total + e);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(own.v[j], acc.v[j]);
    }
    *reinterpret_cast<W*>(o + e) = acc;
  }
}

template <typename T, int OP>
static int launch_staged(const T* x, T* out, int n, int64_t per, cudaStream_t s) {
  const int64_t slice = staged_slice(n);
  if (slice == 0) return TMT_EBADARG;
  const int64_t tile = slice / (int64_t)sizeof(T);
  const int64_t tiles_per_block = (per + tile - 1) / tile;
  const int smem = (int)(n * slice) + 8;         // the slices and the mbarrier
  staged_kernel<T, OP><<<(unsigned)(n * tiles_per_block), kThreads, smem, s>>>(
      x, out, n, per, tile, tiles_per_block);
  return (int)cudaGetLastError();
}

template <typename T, int OP, int V>
static int launch_direct(const T* x, T* out, int n, int64_t per, cudaStream_t s) {
  const int64_t tile = (int64_t)kThreads * V * kDirectGroups;
  const int64_t tiles_per_block = (per + tile - 1) / tile;
  direct_kernel<T, OP, V><<<(unsigned)(n * tiles_per_block), kThreads, 0, s>>>(
      x, out, n, per, tile, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace rs

// route: 0 staged (refused where it does not apply), 1 direct.
template <typename T, int OP>
struct ReduceScatterLaunch {
  static int run(const void* x, void* out, int n, int64_t per, int route,
                 cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    const bool words = aligned(x, 16) && aligned(out, 16) && per % V == 0;
    if (route == 0)
      return words ? rs::launch_staged<T, OP>(xt, ot, n, per, s) : TMT_EBADARG;
    if (route != 1) return TMT_EBADARG;
    return words ? rs::launch_direct<T, OP, V>(xt, ot, n, per, s)
                 : rs::launch_direct<T, OP, 1>(xt, ot, n, per, s);
  }
};

// ---- allgather -----------------------------------------------------------------

// The stacked input is `words` words; every one of the n output rows is a
// copy of it. The word is the widest of 16, 8, 4, 2 and 1 bytes that
// divides both pointers and the input's length in bytes.
template <typename W>
__global__ void ring_allgather_kernel(const W* __restrict__ x, W* __restrict__ out,
                                      int n, int64_t words) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < words;
       i += stride) {
    const W v = x[i];
    for (int q = 0; q < n; ++q) out[q * words + i] = v;
  }
}

template <typename W>
static int launch_allgather(const void* x, void* out, int n, int64_t nbytes,
                            cudaStream_t s) {
  const int64_t words = nbytes / (int64_t)sizeof(W);
  ring_allgather_kernel<W><<<grid_for(words, kThreads), kThreads, 0, s>>>(
      static_cast<const W*>(x), static_cast<W*>(out), n, words);
  return (int)cudaGetLastError();
}

// ---- C interface ---------------------------------------------------------------

extern "C" int tmt_ring_allreduce(const void* x, void* out, int n, int64_t count,
                                  int64_t chunk, int dtype, int op, void* stream) {
  if (n < 1 || count < 0 || chunk < 1 || (int64_t)n * chunk < count || !x || !out)
    return TMT_EBADARG;
  if (count == 0) return 0;
  return dispatch<AllreduceLaunch>(dtype, op, x, out, n, count, chunk,
                                   static_cast<cudaStream_t>(stream));
}

// route 0 is the staged route, which takes 16-byte-aligned bases, blocks of
// whole 16-byte words and an n that tmt_ring_reduce_scatter_tile stages;
// route 1 the direct route, which takes any.
extern "C" int tmt_ring_reduce_scatter(const void* x, void* out, int n, int64_t per,
                                       int dtype, int op, int route, void* stream) {
  if (n < 1 || per < 0 || !x || !out) return TMT_EBADARG;
  if (per == 0) return 0;
  return dispatch<ReduceScatterLaunch>(dtype, op, x, out, n, per, route,
                                       static_cast<cudaStream_t>(stream));
}

// Elements of one rank's slice of a staged reduce-scatter tile for n ranks
// and elements of `itemsize` bytes, or 0 when the staged route does not take
// n (the route also needs 16-byte-aligned bases and blocks of whole 16-byte
// words).
extern "C" int64_t tmt_ring_reduce_scatter_tile(int n, int itemsize) {
  if (n < 1 || itemsize < 1 || 16 % itemsize) return 0;
  return staged_slice(n) / itemsize;
}

extern "C" int tmt_ring_allgather(const void* x, void* out, int n, int64_t nbytes,
                                  void* stream) {
  if (n < 1 || nbytes < 0 || !x || !out) return TMT_EBADARG;
  if (nbytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_word((uintptr_t)x | (uintptr_t)out | (uintptr_t)nbytes, [&](auto w) {
    return launch_allgather<decltype(w)>(x, out, n, nbytes, s);
  });
}

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
// cheap operations per element. The design keeps HBM busy: grid-stride
// loops, neighbouring threads on neighbouring addresses, 16-byte accesses
// wherever the pointers and the row lengths allow (the scalar form
// otherwise), and operands addressed from one base pointer and a rank
// stride, so no pointer table is read from memory.
//
// C interface (bound with ctypes): each function returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.
// The output never overlaps the input (the wrapper allocates it).

#include "fold_ops.cuh"

// V consecutive elements moved as one access of sizeof(T) * V bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec { T v[V]; };

static bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

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

// One rank's input holds n blocks of `per`; element i of it belongs to block
// i / per, and the output (n blocks of `per`, rank c's block c) has the same
// index. V divides per, so a group never straddles a block.
template <typename T, int OP, int V>
__global__ void ring_reduce_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           int n, int64_t per) {
  typedef Vec<T, V> W;
  const int64_t total = (int64_t)n * per;
  const int64_t groups = total / V;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const int64_t i = g * V;
    int r = (int)(i / per) + 1;          // block c's fold starts at rank c+1
    if (r == n) r = 0;
    W acc = *reinterpret_cast<const W*>(x + r * total + i);
    for (int k = 2; k <= n; ++k) {
      r = (r + 1 == n) ? 0 : r + 1;
      const W own = *reinterpret_cast<const W*>(x + r * total + i);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(own.v[j], acc.v[j]);
    }
    *reinterpret_cast<W*>(out + i) = acc;
  }
}

template <typename T, int OP>
struct ReduceScatterLaunch {
  static int run(const void* x, void* out, int n, int64_t per, cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    const int64_t total = (int64_t)n * per;
    if (aligned(x, 16) && aligned(out, 16) && per % V == 0)
      ring_reduce_scatter_kernel<T, OP, V><<<grid_for(total / V, kThreads), kThreads, 0, s>>>(
          xt, ot, n, per);
    else
      ring_reduce_scatter_kernel<T, OP, 1><<<grid_for(total, kThreads), kThreads, 0, s>>>(
          xt, ot, n, per);
    return (int)cudaGetLastError();
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

extern "C" int tmt_ring_reduce_scatter(const void* x, void* out, int n, int64_t per,
                                       int dtype, int op, void* stream) {
  if (n < 1 || per < 0 || !x || !out) return TMT_EBADARG;
  if (per == 0) return 0;
  return dispatch<ReduceScatterLaunch>(dtype, op, x, out, n, per,
                                       static_cast<cudaStream_t>(stream));
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

// Data movement between the n ranks that share one card: collective permute
// and pairwise all-to-all over the stacked per-rank tensor (rank axis first).
//
// Replaces, in tpu_mpi/xla/pallas_kernels.py:
//   collective_permute (_permute_kernel)
//   pairwise_alltoall  (_alltoall_kernel)
//
// The TPU kernels put each rank's block into a peer's buffer by remote DMA,
// after a handshake (an all-pairs barrier for the alltoall, a signal to the
// inverse-permutation source for the permute) that keeps a fast sender from
// landing a DMA in a peer that has not entered the kernel. On one card every
// rank's buffer is a row of the same stacked tensor in the same HBM, so there
// is no remote DMA to guard and no handshake carries over: each kernel is one
// copy from the input rows to the output rows, with the same result.
//
//   permute: out[d] = x[src[d]] for every destination row d, or zeros where
//     src[d] < 0. A full permutation (the TPU kernel's case: rank r's block
//     goes to rank perm[r]) has src = perm^-1; a partial table serves the
//     static neighbour exchange, whose unmatched ranks receive zeros.
//   alltoall: x holds, per source rank s, n blocks of `block` bytes in
//     destination order; out holds, per destination d, n blocks in source
//     order: out[d][s] = x[s][d].
//
// Bound on the card: bytes. Each kernel reads every byte it copies once and
// writes every output byte once: 2 x the stacked tensor (the permute reads
// less when rows receive zeros). The design keeps HBM busy with grid-stride
// loops over the widest word (16, 8, 4, 2 or 1 bytes) that divides both
// pointers and the row (or block) length, neighbouring threads on
// neighbouring words, and one grid row (blockIdx.y/z) per destination row or
// (destination, source) block, so no thread divides an index.
//
// C interface (bound with ctypes): each function returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.
// The output never overlaps the input (the wrapper allocates it).

#include "fold_ops.cuh"

#define TMT_MAX_RANKS 512

// The source row of every destination row, passed by value as a kernel
// parameter (2 KiB), so the kernel reads no table from device memory.
struct SrcTable { int src[TMT_MAX_RANKS]; };

static const int kThreads = 256;

// Blocks along x for `words` words per grid row when `rows` grid rows share
// the card: together about as many blocks as grid_for gives one loop.
static int blocks_per_row(int64_t words, int64_t rows) {
  int64_t cap = grid_for(INT64_MAX / 2, kThreads) / rows;
  int64_t need = (words + kThreads - 1) / kThreads;
  int64_t b = need < cap ? need : cap;
  return (int)(b < 1 ? 1 : b);
}

// ---- permute -------------------------------------------------------------------

template <typename W>
__global__ void permute_kernel(const W* __restrict__ x, W* __restrict__ out,
                               int64_t words, SrcTable table) {
  const int d = blockIdx.y;
  const int s = table.src[d];
  W* o = out + (int64_t)d * words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < 0) {
    const W zero = {};
    for (; i < words; i += stride) o[i] = zero;
  } else {
    const W* in = x + (int64_t)s * words;
    for (; i < words; i += stride) o[i] = in[i];
  }
}

template <typename W>
static int launch_permute(const void* x, void* out, int n, int64_t row_bytes,
                          const SrcTable& table, cudaStream_t s) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  dim3 grid(blocks_per_row(words, n), n);
  permute_kernel<W><<<grid, kThreads, 0, s>>>(
      static_cast<const W*>(x), static_cast<W*>(out), words, table);
  return (int)cudaGetLastError();
}

// ---- alltoall ------------------------------------------------------------------

template <typename W>
__global__ void alltoall_kernel(const W* __restrict__ x, W* __restrict__ out,
                                int n, int64_t words) {
  const int d = blockIdx.y, s = blockIdx.z;
  const W* in = x + ((int64_t)s * n + d) * words;
  W* o = out + ((int64_t)d * n + s) * words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < words;
       i += stride)
    o[i] = in[i];
}

template <typename W>
static int launch_alltoall(const void* x, void* out, int n, int64_t block_bytes,
                           cudaStream_t s) {
  const int64_t words = block_bytes / (int64_t)sizeof(W);
  dim3 grid(blocks_per_row(words, (int64_t)n * n), n, n);
  alltoall_kernel<W><<<grid, kThreads, 0, s>>>(
      static_cast<const W*>(x), static_cast<W*>(out), n, words);
  return (int)cudaGetLastError();
}

// ---- C interface ---------------------------------------------------------------

extern "C" int tmt_permute(const void* x, void* out, int n, int64_t row_bytes,
                           const int* src, void* stream) {
  if (n < 1 || n > TMT_MAX_RANKS || row_bytes < 0 || !x || !out || !src)
    return TMT_EBADARG;
  SrcTable table;
  for (int d = 0; d < n; ++d) {
    if (src[d] < -1 || src[d] >= n) return TMT_EBADARG;
    table.src[d] = src[d];
  }
  if (row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_word((uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes, [&](auto w) {
    return launch_permute<decltype(w)>(x, out, n, row_bytes, table, s);
  });
}

extern "C" int tmt_alltoall(const void* x, void* out, int n, int64_t block_bytes,
                            void* stream) {
  if (n < 1 || n > TMT_MAX_RANKS || block_bytes < 0 || !x || !out)
    return TMT_EBADARG;
  if (block_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_word((uintptr_t)x | (uintptr_t)out | (uintptr_t)block_bytes, [&](auto w) {
    return launch_alltoall<decltype(w)>(x, out, n, block_bytes, s);
  });
}

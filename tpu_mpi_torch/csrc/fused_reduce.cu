// Fused rank-ordered fold of n same-shape operand streams into one output.
//
// Replaces tpu_mpi/xla/pallas_kernels.py::fused_multi_reduce (:655, the
// Pallas kernel _fused_reduce_kernel): out[i] = op(...op(op(x0[i], x1[i]),
// x2[i])..., x{n-1}[i]), a LEFT fold in rank order, so every element rounds
// exactly as the chained elementwise PyTorch fold does, step by step.
//
// Bound on the card: bytes. The fold reads each of the n streams once and
// writes the output once, (n+1)*count*sizeof(T) bytes, and does n-1
// arithmetic operations per element, far below any compute roof. The
// design therefore only has to keep HBM busy with as many bytes in flight
// as it can. The TPU kernel stages a 512x128 block of every operand in
// VMEM, double-buffered by its BlockSpec pipeline, and folds it there; this
// is the Hopper form of that, the one the ring reduce-scatter's staged
// route (ring.cu) measured at 0.92 of the bound on the same traffic:
//
// Staged route (every operand and the output 16-byte aligned, and the fold
// a whole number of 16-byte words): one CTA per tile. Its first thread
// issues the n slices of the tile as 1-D bulk asynchronous copies (the TMA)
// from each operand's own pointer into shared memory, operand k into slot
// k, so the slot order is the rank order; all complete on one mbarrier by
// the bytes they carry. Every thread then folds the slots 16 bytes at a
// time and writes with streaming stores (the output is written once and
// never read here). No thread spends registers or instructions on the
// loads, so a CTA is small (staged_slice, mbarrier.cuh: 24 KiB of slices
// over the n, in whole KiB) and eight stay resident on each SM, their
// copies overlapping each other's folds. The operand pointers reach the
// kernel as a __grid_constant__ struct that only the issuing thread walks,
// so no thread copies the pointer table into local memory.
//
// Direct route (any other pointers or count: views at an offset, a count
// whose last group is not a whole 16-byte word): one CTA per tile of
// kDirectGroups groups a thread, each thread loading its groups straight
// from HBM, 16-byte groups where every pointer is 16-byte aligned and the
// scalar form otherwise; the ragged tail (fewer than 16 bytes, in the last
// tile only) is folded by that tile's first threads in the same launch.
//
// Tiny folds (the serve tier's float32[8], RMA's 8-byte Fetch_and_op) cost
// a launch, not bytes: the wrapper (kernels/fused_reduce.py, route) takes
// the route these rules give, the staged one for float32[8] (its device
// span measured equal to the direct route's there, the time a call being
// the host's; PERF.md, section 6) and the direct one for 8 bytes (not a
// whole 16-byte word).
//
// Aliasing: `out` may be operand 0 itself (a chained launch; the RMA
// accumulate folding in place). On the staged route a CTA holds its whole
// tile of every operand in shared memory before it writes that tile; on the
// direct route each thread reads its word of every operand before it
// writes it. The wrapper refuses an `out` that overlaps an operand only in
// part.
//
// Exactness: every step is one Step<T, OP>::f(acc, x_k) of fold_ops.cuh,
// the accumulator FIRST (the numpy-rule steps pick which NaN payload
// survives by argument order), rounded exactly as PyTorch's own CUDA
// elementwise op rounds; the OP_NUMPY_* ops (the serve tier's) give numpy's
// bits instead. More than N_MAX operands run as chained launches that feed
// the accumulator back in as operand 0: still the same left fold, bitwise.
//
// C interface (bound with ctypes): tmt_fused_reduce returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.

#include "fold_ops.cuh"
#include "mbarrier.cuh"

#define N_MAX 16

struct Operands {
  const void* p[N_MAX];
};

static const int kThreads = 256;
static const int kDirectGroups = 4;    // V-groups a thread takes per direct tile

// ---- staged route ----------------------------------------------------------------

// Tile b is elements [b*tile, min((b+1)*tile, count)); V divides count and
// tile, so every slice is whole 16-byte words.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fused_fold_kernel_staged(const __grid_constant__ Operands ops, int n, T* out,
                         int64_t count, int64_t tile) {
  constexpr int V = 16 / sizeof(T);
  typedef Vec<T, V> W;
  extern __shared__ __align__(16) uint8_t slots[];  // n slices, then the mbarrier
  const int64_t e0 = (int64_t)blockIdx.x * tile;
  const int64_t len = count - e0 < tile ? count - e0 : tile;
  const uint32_t bar = smem_u32(slots) + (uint32_t)(n * tile * sizeof(T));
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(len * sizeof(T));
    const uint32_t slice = (uint32_t)(tile * sizeof(T));
    mbar_expect_tx(bar, (uint32_t)n * bytes);
    for (int k = 0; k < n; ++k)
      bulk_load(smem_u32(slots) + k * slice, static_cast<const T*>(ops.p[k]) + e0,
                bytes, bar);
  }
  const int groups = (int)(len / V);
  const int stride = (int)(tile / V);                // words between slots
  const W* slot = reinterpret_cast<const W*>(slots);
  W* o = reinterpret_cast<W*>(out + e0);
  mbar_wait(bar, 0);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    W acc = slot[g];
    for (int k = 1; k < n; ++k) {
      const W x = slot[k * stride + g];
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(acc.v[j], x.v[j]);
    }
    store_streaming(o + g, acc);
  }
}

template <typename T, int OP>
static int launch_staged(const Operands& ops, int n, T* out, int64_t count,
                         cudaStream_t s) {
  const int64_t slice = staged_slice(n);
  const int64_t tile = slice / (int64_t)sizeof(T);
  const int smem = (int)(n * slice) + 8;         // the slices and the mbarrier
  fused_fold_kernel_staged<T, OP><<<(unsigned)((count + tile - 1) / tile), kThreads,
                                    smem, s>>>(ops, n, out, count, tile);
  return (int)cudaGetLastError();
}

// ---- direct route ----------------------------------------------------------------

// One CTA per tile of kThreads * V * kDirectGroups elements: whole V-groups
// first, then the tail of fewer than V elements (the last tile's only).
template <typename T, int OP, int V>
__global__ void __launch_bounds__(kThreads)
fused_fold_kernel_direct(const __grid_constant__ Operands ops, int n, T* out,
                         int64_t count) {
  typedef Vec<T, V> W;
  const int64_t tile = (int64_t)kThreads * V * kDirectGroups;
  const int64_t e0 = (int64_t)blockIdx.x * tile;
  const int64_t len = count - e0 < tile ? count - e0 : tile;
  const int64_t whole = e0 + len / V * V;        // end of the whole groups
  for (int64_t e = e0 + (int64_t)threadIdx.x * V; e < whole; e += kThreads * V) {
    W acc = *reinterpret_cast<const W*>(static_cast<const T*>(ops.p[0]) + e);
    for (int k = 1; k < n; ++k) {
      const W x = *reinterpret_cast<const W*>(static_cast<const T*>(ops.p[k]) + e);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] = Step<T, OP>::f(acc.v[j], x.v[j]);
    }
    *reinterpret_cast<W*>(out + e) = acc;
  }
  const int64_t e = whole + threadIdx.x;
  if (V > 1 && e < e0 + len) {
    T acc = static_cast<const T*>(ops.p[0])[e];
    for (int k = 1; k < n; ++k) acc = Step<T, OP>::f(acc, static_cast<const T*>(ops.p[k])[e]);
    out[e] = acc;
  }
}

template <typename T, int OP, int V>
static int launch_direct(const Operands& ops, int n, T* out, int64_t count,
                         cudaStream_t s) {
  const int64_t tile = (int64_t)kThreads * V * kDirectGroups;
  fused_fold_kernel_direct<T, OP, V><<<(unsigned)((count + tile - 1) / tile), kThreads,
                                       0, s>>>(ops, n, out, count);
  return (int)cudaGetLastError();
}

// ---- launches --------------------------------------------------------------------

// route: 0 staged (refused where it does not apply), 1 direct. Up to N_MAX
// operands a launch; beyond that, chained launches on the same route, each
// leading with the accumulator in `out`.
// So `out` may alias an operand of the first launch only: the wrapper
// (kernels/fused_reduce.py) folds into a fresh tensor when `out` is an
// operand past the first N_MAX.
template <typename T, int OP>
struct FoldLaunch {
  static int run(const void* const* ptrs, int n, void* out, int64_t count, int route,
                 cudaStream_t s) {
    constexpr int V = 16 / sizeof(T);
    bool words = aligned(out, 16);
    for (int k = 0; k < n; ++k) words = words && aligned(ptrs[k], 16);
    if (route == 0 ? !(words && count % V == 0) : route != 1) return TMT_EBADARG;
    T* o = static_cast<T*>(out);
    int done = 0;                        // operands folded so far
    while (done < n) {
      Operands ops;
      int m = 0;
      if (done > 0) ops.p[m++] = out;    // the accumulator leads the chain
      while (m < N_MAX && done < n) ops.p[m++] = ptrs[done++];
      const int rc = route == 0 ? launch_staged<T, OP>(ops, m, o, count, s)
                     : words    ? launch_direct<T, OP, V>(ops, m, o, count, s)
                                : launch_direct<T, OP, 1>(ops, m, o, count, s);
      if (rc != 0) return rc;
    }
    return 0;
  }
};

// route 0 is the staged route, which takes 16-byte-aligned operands and out
// and a count of whole 16-byte words; route 1 the direct route, which takes
// any.
extern "C" int tmt_fused_reduce(const void* const* ptrs, int n, void* out,
                                int64_t count, int dtype, int op, int route,
                                void* stream) {
  if (n < 1 || count < 0 || ptrs == 0 || out == 0) return TMT_EBADARG;
  if (count == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op >= OP_NUMPY_SUM)
    return dispatch_numpy<FoldLaunch>(dtype, op, ptrs, n, out, count, route, s);
  return dispatch<FoldLaunch>(dtype, op, ptrs, n, out, count, route, s);
}

// Elements of one operand's slice of a staged tile for n operands in one
// launch (at most N_MAX) of `itemsize`-byte elements.
extern "C" int64_t tmt_fused_reduce_tile(int n, int itemsize) {
  if (n < 1 || n > N_MAX || itemsize < 1 || 16 % itemsize) return 0;
  return staged_slice(n) / itemsize;
}

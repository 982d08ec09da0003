// Fused rank-ordered fold of n same-shape operand streams into one output.
//
// Replaces tpu_mpi/xla/pallas_kernels.py::fused_multi_reduce (the Pallas
// kernel _fused_reduce_kernel): out[i] = op(...op(op(x0[i], x1[i]), x2[i])...,
// x{n-1}[i]), a LEFT fold in rank order, so every element rounds exactly as
// the chained elementwise PyTorch fold does, step by step.
//
// Bound on the card: bytes. The fold reads each of the n streams once and
// writes the output once, (n+1)*count*sizeof(T) bytes, and does n-1
// arithmetic operations per element, far below any compute roof. The
// design therefore only has to keep HBM busy: a grid-stride elementwise
// loop (neighbouring threads on neighbouring addresses, so every warp load
// coalesces), enough blocks to fill every SM, and all n operand pointers
// passed by value in one struct so no pointer table is read from memory.
// More than N_MAX operands run as chained launches that feed the
// accumulator back in as operand 0: still the same left fold, still bitwise.
//
// Exactness: every step is one Step<T, OP> of fold_ops.cuh, which rounds
// exactly as PyTorch's own CUDA elementwise op does; the OP_NUMPY_* ops
// (the serve tier's) give numpy's bits instead.
//
// C interface (bound with ctypes): tmt_fused_reduce returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.

#include "fold_ops.cuh"

#define N_MAX 16

struct Operands {
  const void* p[N_MAX];
};

// ---- the fold ------------------------------------------------------------------

// `out` may be operand 0 itself (a chained launch): each element is read by
// the same thread before it is written, so that aliasing is safe.
template <typename T, int OP>
__global__ void fused_fold_kernel(Operands ops, int n, T* out, int64_t count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    T acc = static_cast<const T*>(ops.p[0])[i];
#pragma unroll 4
    for (int k = 1; k < n; ++k)
      acc = Step<T, OP>::f(acc, static_cast<const T*>(ops.p[k])[i]);
    out[i] = acc;
  }
}

template <typename T, int OP>
static int launch_chain(const void* const* ptrs, int n, void* out, int64_t count,
                        cudaStream_t stream) {
  const int threads = 256;
  const int grid = grid_for(count, threads);
  int done = 0;                          // operands folded so far
  while (done < n) {
    Operands ops;
    int m = 0;
    if (done > 0) ops.p[m++] = out;      // the accumulator leads the chain
    while (m < N_MAX && done < n) ops.p[m++] = ptrs[done++];
    fused_fold_kernel<T, OP><<<grid, threads, 0, stream>>>(ops, m, static_cast<T*>(out), count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int OP>
struct FoldLaunch {
  static int run(const void* const* ptrs, int n, void* out, int64_t count,
                 cudaStream_t s) {
    return launch_chain<T, OP>(ptrs, n, out, count, s);
  }
};

extern "C" int tmt_fused_reduce(const void* const* ptrs, int n, void* out,
                                int64_t count, int dtype, int op, void* stream) {
  if (n < 1 || count < 0 || ptrs == 0 || out == 0) return TMT_EBADARG;
  if (count == 0) return 0;
  if (op >= OP_NUMPY_SUM)
    return dispatch_numpy<FoldLaunch>(dtype, op, ptrs, n, out, count,
                                      static_cast<cudaStream_t>(stream));
  return dispatch<FoldLaunch>(dtype, op, ptrs, n, out, count,
                              static_cast<cudaStream_t>(stream));
}

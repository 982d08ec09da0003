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
// Exactness rules, each matching PyTorch's own CUDA elementwise kernels:
//   * float/double add and multiply use the _rn intrinsics, so nvcc cannot
//     contract a step into an FMA;
//   * half and bfloat16 widen to float with the conversion intrinsics, apply
//     one float operation, and round back to the storage type at every step
//     (PyTorch's opmath rule);
//   * MAX/MIN propagate NaN exactly as torch.maximum/torch.minimum do on the
//     card (a NaN in a wins, then a NaN in b, else fmax/fmin), so the fmax
//     semantics that drop NaN never decide;
//   * integer SUM/PROD wrap modulo 2^bits (computed in unsigned arithmetic);
//   * bool SUM/MAX/BOR are OR, PROD/MIN/BAND are AND, BXOR is XOR.
//
// C interface (bound with ctypes): tmt_fused_reduce returns 0 on success, the
// cudaError_t of a refused launch, or TMT_EBADARG for arguments the kernel
// does not take. It launches on the given stream and never synchronises.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define N_MAX 16
#define TMT_EBADARG 100000

enum Dtype {
  DT_F32 = 0, DT_F64 = 1, DT_F16 = 2, DT_BF16 = 3, DT_I8 = 4,
  DT_I16 = 5, DT_I32 = 6, DT_I64 = 7, DT_U8 = 8, DT_BOOL = 9,
};

enum Op {
  OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3,
  OP_BAND = 4, OP_BOR = 5, OP_BXOR = 6,
};

struct Operands {
  const void* p[N_MAX];
};

// ---- one fold step per (type, op) -------------------------------------------

template <typename T, int OP>
struct Step;

// float / double ---------------------------------------------------------------
template <> struct Step<float, OP_SUM> {
  static __device__ __forceinline__ float f(float a, float b) { return __fadd_rn(a, b); }
};
template <> struct Step<float, OP_PROD> {
  static __device__ __forceinline__ float f(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Step<float, OP_MAX> {
  static __device__ __forceinline__ float f(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
  }
};
template <> struct Step<float, OP_MIN> {
  static __device__ __forceinline__ float f(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fminf(a, b);
  }
};
template <> struct Step<double, OP_SUM> {
  static __device__ __forceinline__ double f(double a, double b) { return __dadd_rn(a, b); }
};
template <> struct Step<double, OP_PROD> {
  static __device__ __forceinline__ double f(double a, double b) { return __dmul_rn(a, b); }
};
template <> struct Step<double, OP_MAX> {
  static __device__ __forceinline__ double f(double a, double b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmax(a, b);
  }
};
template <> struct Step<double, OP_MIN> {
  static __device__ __forceinline__ double f(double a, double b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmin(a, b);
  }
};

// half / bfloat16: widen, one float step, round back ---------------------------
template <int OP> struct Step<__half, OP> {
  static __device__ __forceinline__ __half f(__half a, __half b) {
    return __float2half_rn(Step<float, OP>::f(__half2float(a), __half2float(b)));
  }
};
template <int OP> struct Step<__nv_bfloat16, OP> {
  static __device__ __forceinline__ __nv_bfloat16 f(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(Step<float, OP>::f(__bfloat162float(a), __bfloat162float(b)));
  }
};

// integers: wrap modulo 2^bits --------------------------------------------------
template <typename T> struct Wide { typedef uint32_t type; };
template <> struct Wide<int64_t> { typedef uint64_t type; };

template <typename T> struct IntStep {
  typedef typename Wide<T>::type U;
  static __device__ __forceinline__ T sum(T a, T b) { return (T)((U)a + (U)b); }
  static __device__ __forceinline__ T prod(T a, T b) { return (T)((U)a * (U)b); }
};

#define INT_STEPS(T)                                                              \
  template <> struct Step<T, OP_SUM> {                                            \
    static __device__ __forceinline__ T f(T a, T b) { return IntStep<T>::sum(a, b); } \
  };                                                                              \
  template <> struct Step<T, OP_PROD> {                                           \
    static __device__ __forceinline__ T f(T a, T b) { return IntStep<T>::prod(a, b); } \
  };                                                                              \
  template <> struct Step<T, OP_MAX> {                                            \
    static __device__ __forceinline__ T f(T a, T b) { return a < b ? b : a; }     \
  };                                                                              \
  template <> struct Step<T, OP_MIN> {                                            \
    static __device__ __forceinline__ T f(T a, T b) { return b < a ? b : a; }     \
  };                                                                              \
  template <> struct Step<T, OP_BAND> {                                           \
    static __device__ __forceinline__ T f(T a, T b) { return (T)(a & b); }        \
  };                                                                              \
  template <> struct Step<T, OP_BOR> {                                            \
    static __device__ __forceinline__ T f(T a, T b) { return (T)(a | b); }        \
  };                                                                              \
  template <> struct Step<T, OP_BXOR> {                                           \
    static __device__ __forceinline__ T f(T a, T b) { return (T)(a ^ b); }        \
  };

INT_STEPS(int8_t)
INT_STEPS(int16_t)
INT_STEPS(int32_t)
INT_STEPS(int64_t)
INT_STEPS(uint8_t)

// bool, stored as one byte holding 0 or 1 ---------------------------------------
struct Bool { uint8_t v; };

template <int OP> struct Step<Bool, OP> {
  static __device__ __forceinline__ Bool f(Bool a, Bool b) {
    uint8_t x = a.v != 0, y = b.v != 0, r;
    if (OP == OP_SUM || OP == OP_MAX || OP == OP_BOR) r = x | y;
    else if (OP == OP_BXOR) r = x ^ y;
    else r = x & y;                       // PROD, MIN, BAND
    Bool out = {r};
    return out;
  }
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

static int grid_for(int64_t count, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0)
      sms = 132;
  }
  int64_t blocks = (count + threads - 1) / threads;
  int64_t cap = (int64_t)sms * 16;       // 16 blocks of 256 threads per SM
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
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

template <typename T>
static int dispatch_float_op(int op, const void* const* ptrs, int n, void* out,
                             int64_t count, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch_chain<T, OP_SUM>(ptrs, n, out, count, s);
    case OP_PROD: return launch_chain<T, OP_PROD>(ptrs, n, out, count, s);
    case OP_MAX: return launch_chain<T, OP_MAX>(ptrs, n, out, count, s);
    case OP_MIN: return launch_chain<T, OP_MIN>(ptrs, n, out, count, s);
  }
  return TMT_EBADARG;
}

template <typename T>
static int dispatch_int_op(int op, const void* const* ptrs, int n, void* out,
                           int64_t count, cudaStream_t s) {
  switch (op) {
    case OP_SUM: return launch_chain<T, OP_SUM>(ptrs, n, out, count, s);
    case OP_PROD: return launch_chain<T, OP_PROD>(ptrs, n, out, count, s);
    case OP_MAX: return launch_chain<T, OP_MAX>(ptrs, n, out, count, s);
    case OP_MIN: return launch_chain<T, OP_MIN>(ptrs, n, out, count, s);
    case OP_BAND: return launch_chain<T, OP_BAND>(ptrs, n, out, count, s);
    case OP_BOR: return launch_chain<T, OP_BOR>(ptrs, n, out, count, s);
    case OP_BXOR: return launch_chain<T, OP_BXOR>(ptrs, n, out, count, s);
  }
  return TMT_EBADARG;
}

extern "C" int tmt_fused_reduce(const void* const* ptrs, int n, void* out,
                                int64_t count, int dtype, int op, void* stream) {
  if (n < 1 || count < 0 || ptrs == 0 || out == 0) return TMT_EBADARG;
  if (count == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return dispatch_float_op<float>(op, ptrs, n, out, count, s);
    case DT_F64: return dispatch_float_op<double>(op, ptrs, n, out, count, s);
    case DT_F16: return dispatch_float_op<__half>(op, ptrs, n, out, count, s);
    case DT_BF16: return dispatch_float_op<__nv_bfloat16>(op, ptrs, n, out, count, s);
    case DT_I8: return dispatch_int_op<int8_t>(op, ptrs, n, out, count, s);
    case DT_I16: return dispatch_int_op<int16_t>(op, ptrs, n, out, count, s);
    case DT_I32: return dispatch_int_op<int32_t>(op, ptrs, n, out, count, s);
    case DT_I64: return dispatch_int_op<int64_t>(op, ptrs, n, out, count, s);
    case DT_U8: return dispatch_int_op<uint8_t>(op, ptrs, n, out, count, s);
    case DT_BOOL: return dispatch_int_op<Bool>(op, ptrs, n, out, count, s);
  }
  return TMT_EBADARG;
}

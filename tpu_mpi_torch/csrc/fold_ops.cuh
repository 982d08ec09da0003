// One fold step per (storage type, reduction op), shared by every kernel of
// the port that combines operands: the fused rank-ordered fold
// (fused_reduce.cu) and the ring collectives (ring.cu).
//
// Exactness rules, each matching PyTorch's own CUDA elementwise kernels, so
// a kernel's fold is bitwise equal to the same fold written in PyTorch:
//   * float/double add and multiply use the _rn intrinsics, so nvcc cannot
//     contract a step into an FMA;
//   * half and bfloat16 widen to float with the conversion intrinsics, apply
//     one float operation, and round back to the storage type at every step
//     (PyTorch's opmath rule);
//   * MAX/MIN propagate NaN exactly as torch.maximum/torch.minimum do on the
//     card (a NaN in a wins, then a NaN in b, else fmax/fmin), so the fmax
//     semantics that drop NaN never decide;
//   * integer SUM/PROD wrap modulo 2^bits (computed in unsigned arithmetic),
//     signed and unsigned alike; MAX/MIN compare in the type's own order;
//   * bool SUM/MAX/BOR are OR, PROD/MIN/BAND are AND, BXOR is XOR.
// The NUMPY_* steps are the exception: they follow numpy's bits instead,
// for the serve tier only (below).
//
// Also here: the dtype/op codes of the C interfaces, the launch-size rule,
// the word types of 16-byte accesses, and dispatch<L>(dtype, op, ...),
// which calls L<T, OP>::run(...) for the (type, op) pair the codes name, or
// returns TMT_EBADARG.

#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define TMT_EBADARG 100000

enum Dtype {
  DT_F32 = 0, DT_F64 = 1, DT_F16 = 2, DT_BF16 = 3, DT_I8 = 4,
  DT_I16 = 5, DT_I32 = 6, DT_I64 = 7, DT_U8 = 8, DT_BOOL = 9,
  DT_U16 = 10, DT_U32 = 11, DT_U64 = 12,
};

enum Op {
  OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3,
  OP_BAND = 4, OP_BOR = 5, OP_BXOR = 6,
  // numpy's rules on the float dtypes (the serve tier's folds; below)
  OP_NUMPY_SUM = 7, OP_NUMPY_PROD = 8, OP_NUMPY_MAX = 9, OP_NUMPY_MIN = 10,
};

// bool, stored as one byte holding 0 or 1
struct Bool { uint8_t v; };

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

// numpy's rules: float / double / half ------------------------------------------
//
// The serve tier replies with numpy's bits (operators.py, NUMPY_RULES, has
// the plain version and the rules as measured on x86): SUM/PROD take a NaN
// operand, quieted — of two, the first's (float, double) or the second's
// (half) — and give x86's default NaN (sign set) for an invalid operation;
// MAX/MIN take the first operand's NaN, else the second's, bits unchanged,
// and of two equal values the second (float, double) or the first (half).
// NaNs are told apart on the bits, so no conversion or arithmetic ever
// touches a NaN's payload.
template <typename T> struct NpBits;
template <> struct NpBits<float> {
  typedef uint32_t U; typedef float W;
  static constexpr U ABS = 0x7fffffffu, INF = 0x7f800000u, QUIET = 0x00400000u,
                 DNAN = 0xffc00000u;
  static constexpr bool TIES_FIRST = false, NAN_SECOND = false;
  static __device__ __forceinline__ W widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(W x) { return x; }
};
template <> struct NpBits<double> {
  typedef uint64_t U; typedef double W;
  static constexpr U ABS = 0x7fffffffffffffffull, INF = 0x7ff0000000000000ull,
                 QUIET = 0x0008000000000000ull, DNAN = 0xfff8000000000000ull;
  static constexpr bool TIES_FIRST = false, NAN_SECOND = false;
  static __device__ __forceinline__ W widen(double x) { return x; }
  static __device__ __forceinline__ double narrow(W x) { return x; }
};
template <> struct NpBits<__half> {
  typedef uint16_t U; typedef float W;
  static constexpr U ABS = 0x7fff, INF = 0x7c00, QUIET = 0x0200, DNAN = 0xfe00;
  static constexpr bool TIES_FIRST = true, NAN_SECOND = true;
  static __device__ __forceinline__ W widen(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half narrow(W x) { return __float2half_rn(x); }
};

template <typename T> struct NpStep {
  typedef NpBits<T> B;
  typedef typename B::U U;
  typedef typename B::W W;
  static __device__ __forceinline__ U bits(T x) { U u; memcpy(&u, &x, sizeof u); return u; }
  static __device__ __forceinline__ T of(U u) { T x; memcpy(&x, &u, sizeof x); return x; }
  static __device__ __forceinline__ bool nan(U u) { return (U)(u & B::ABS) > B::INF; }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

  template <bool PROD>
  static __device__ __forceinline__ T arith(T a, T b) {
    const U ua = bits(a), ub = bits(b);
    const U u1 = B::NAN_SECOND ? ub : ua, u2 = B::NAN_SECOND ? ua : ub;
    if (nan(u1)) return of((U)(u1 | B::QUIET));
    if (nan(u2)) return of((U)(u2 | B::QUIET));
    const W r = PROD ? mul(B::widen(a), B::widen(b)) : add(B::widen(a), B::widen(b));
    if (r != r) return of(B::DNAN);
    return B::narrow(r);
  }

  template <bool MAX>
  static __device__ __forceinline__ T pick(T a, T b) {
    if (nan(bits(a))) return a;
    const W x = B::widen(a), y = B::widen(b);      // a NaN b loses every compare
    const bool take_a = B::TIES_FIRST ? (MAX ? x >= y : x <= y)
                                      : (MAX ? x > y : x < y);
    return take_a ? a : b;
  }
};

#define NUMPY_STEPS(T)                                                            \
  template <> struct Step<T, OP_NUMPY_SUM> {                                      \
    static __device__ __forceinline__ T f(T a, T b) { return NpStep<T>::template arith<false>(a, b); } \
  };                                                                              \
  template <> struct Step<T, OP_NUMPY_PROD> {                                     \
    static __device__ __forceinline__ T f(T a, T b) { return NpStep<T>::template arith<true>(a, b); } \
  };                                                                              \
  template <> struct Step<T, OP_NUMPY_MAX> {                                      \
    static __device__ __forceinline__ T f(T a, T b) { return NpStep<T>::template pick<true>(a, b); } \
  };                                                                              \
  template <> struct Step<T, OP_NUMPY_MIN> {                                      \
    static __device__ __forceinline__ T f(T a, T b) { return NpStep<T>::template pick<false>(a, b); } \
  };

NUMPY_STEPS(float)
NUMPY_STEPS(double)
NUMPY_STEPS(__half)

#undef NUMPY_STEPS

// integers: wrap modulo 2^bits --------------------------------------------------
template <typename T> struct Wide { typedef uint32_t type; };
template <> struct Wide<int64_t> { typedef uint64_t type; };
template <> struct Wide<uint64_t> { typedef uint64_t type; };

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
INT_STEPS(uint16_t)
INT_STEPS(uint32_t)
INT_STEPS(uint64_t)

#undef INT_STEPS

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

// ---- launch size ---------------------------------------------------------------

// Blocks for a grid-stride loop over `items`: enough to fill every SM
// (16 blocks of `threads` each), never more than the items need.
static int grid_for(int64_t items, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0)
      sms = 132;
  }
  int64_t blocks = (items + threads - 1) / threads;
  int64_t cap = (int64_t)sms * 16;
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

// ---- words -----------------------------------------------------------------------

// V consecutive elements moved as one access of sizeof(T) * V bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec { T v[V]; };

static bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

// ---- word width of a byte copy -------------------------------------------------

// launch(W{}) with W the widest of the 16, 8, 4, 2 and 1-byte words that
// divides every pointer and byte length OR-ed into `bits`.
template <class F>
static int by_word(uintptr_t bits, F launch) {
  if (bits % 16 == 0) return launch(uint4{});
  if (bits % 8 == 0) return launch(uint2{});
  if (bits % 4 == 0) return launch(uint32_t{});
  if (bits % 2 == 0) return launch(uint16_t{});
  return launch(uint8_t{});
}

// ---- (dtype, op) codes -> L<T, OP>::run ----------------------------------------

template <typename T> struct IsFloat { static const bool value = false; };
template <> struct IsFloat<float> { static const bool value = true; };
template <> struct IsFloat<double> { static const bool value = true; };
template <> struct IsFloat<__half> { static const bool value = true; };
template <> struct IsFloat<__nv_bfloat16> { static const bool value = true; };

template <template <typename, int> class L, typename T, typename... A>
static int dispatch_op(int op, A... a) {
  switch (op) {
    case OP_SUM: return L<T, OP_SUM>::run(a...);
    case OP_PROD: return L<T, OP_PROD>::run(a...);
    case OP_MAX: return L<T, OP_MAX>::run(a...);
    case OP_MIN: return L<T, OP_MIN>::run(a...);
  }
  if constexpr (!IsFloat<T>::value) {     // bitwise ops: integers and bool only
    switch (op) {
      case OP_BAND: return L<T, OP_BAND>::run(a...);
      case OP_BOR: return L<T, OP_BOR>::run(a...);
      case OP_BXOR: return L<T, OP_BXOR>::run(a...);
    }
  }
  return TMT_EBADARG;
}

// numpy's rules: the float dtypes numpy has, OP_NUMPY_* only (the fused
// fold's; the ring kernels never instantiate them)
template <template <typename, int> class L, typename T, typename... A>
static int dispatch_numpy_op(int op, A... a) {
  switch (op) {
    case OP_NUMPY_SUM: return L<T, OP_NUMPY_SUM>::run(a...);
    case OP_NUMPY_PROD: return L<T, OP_NUMPY_PROD>::run(a...);
    case OP_NUMPY_MAX: return L<T, OP_NUMPY_MAX>::run(a...);
    case OP_NUMPY_MIN: return L<T, OP_NUMPY_MIN>::run(a...);
  }
  return TMT_EBADARG;
}

template <template <typename, int> class L, typename... A>
static int dispatch_numpy(int dtype, int op, A... a) {
  switch (dtype) {
    case DT_F32: return dispatch_numpy_op<L, float>(op, a...);
    case DT_F64: return dispatch_numpy_op<L, double>(op, a...);
    case DT_F16: return dispatch_numpy_op<L, __half>(op, a...);
  }
  return TMT_EBADARG;
}

template <template <typename, int> class L, typename... A>
static int dispatch(int dtype, int op, A... a) {
  switch (dtype) {
    case DT_F32: return dispatch_op<L, float>(op, a...);
    case DT_F64: return dispatch_op<L, double>(op, a...);
    case DT_F16: return dispatch_op<L, __half>(op, a...);
    case DT_BF16: return dispatch_op<L, __nv_bfloat16>(op, a...);
    case DT_I8: return dispatch_op<L, int8_t>(op, a...);
    case DT_I16: return dispatch_op<L, int16_t>(op, a...);
    case DT_I32: return dispatch_op<L, int32_t>(op, a...);
    case DT_I64: return dispatch_op<L, int64_t>(op, a...);
    case DT_U8: return dispatch_op<L, uint8_t>(op, a...);
    case DT_U16: return dispatch_op<L, uint16_t>(op, a...);
    case DT_U32: return dispatch_op<L, uint32_t>(op, a...);
    case DT_U64: return dispatch_op<L, uint64_t>(op, a...);
    case DT_BOOL: return dispatch_op<L, Bool>(op, a...);
  }
  return TMT_EBADARG;
}

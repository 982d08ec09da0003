// The data-parallel trainer's two per-step passes over its float64 state
// (tpu_mpi_torch/train/ddp.py, bucketer.py), one launch per gradient bucket
// for the pack and one per SEG_MAX buckets for the update.
//
// Replaces no TPU kernel: the JAX package packs and folds with numpy on the
// host (tpu_mpi/train/bucketer.py, tpu_mpi/train/ddp.py:150-160). On the card
// the same work written in PyTorch is four calls a gradient to pack and
// seven a parameter to fold, each a launch that releases the interpreter
// lock and has to win it back from the other rank threads; the launches,
// not the bytes, bound it. These kernels take a whole bucket's gradients,
// or up to SEG_MAX buckets, in one launch.
//
// Bound on the card: bytes. The pack reads each gradient once and writes
// its float64 image once; the update reads the reduced gradient, the
// momentum and the master once and writes the momentum and the master once,
// 40 bytes an element, with five float64 operations. Each CTA takes one
// tile of kItems elements a thread from one segment, loads them all before
// computing (kItems loads of each stream in flight a thread), and a
// segment's tiles follow each other in the grid, so the loads coalesce.
//
// Segments reach the kernels as a __grid_constant__ table of at most
// SEG_MAX entries: each segment's pointer, offset, count and first tile.
// A CTA finds its segment by walking the table's tile starts. More segments
// run as chained launches on the same stream.
//
// Exactness:
//   * pack: the element's float64 value, converted exactly as PyTorch's
//     copy_ converts it (bfloat16 and half widen to float by the
//     intrinsics, then float to double), so the send flat holds copy_'s
//     bits, NaN payloads included;
//   * update: the SGD-momentum step in PyTorch's order, one rounding a step,
//     g = r * inv, m = m * mu, m = m + g, t = m * lr, p = p - t, with the
//     _rn intrinsics, so nvcc cannot contract m * mu + g into an FMA.
//
// C interface (bound with ctypes): each function returns 0, the
// cudaError_t of a refused launch (cudaGetLastError after every launch), or
// TMT_EBADARG for arguments it does not take, and writes the number of
// kernels it launched to *launches (0 when every segment is empty). It
// launches on the given stream and never synchronises.

#include "fold_ops.cuh"

#define SEG_MAX 32

constexpr int kThreads = 256;
constexpr int kItems = 8;                        // elements a thread
constexpr int64_t kTile = (int64_t)kThreads * kItems;

struct PackSegs {
  const void* src[SEG_MAX];
  int64_t off[SEG_MAX];            // into dst
  int64_t count[SEG_MAX];
  int64_t first[SEG_MAX + 1];      // first tile of each segment; first[m] = tiles
  int dtype[SEG_MAX];
};

struct UpdateSegs {
  const double* recv[SEG_MAX];
  int64_t off[SEG_MAX];            // into the master and momentum flats
  int64_t count[SEG_MAX];
  int64_t first[SEG_MAX + 1];
};

// The segment whose tiles hold tile b.
static __device__ __forceinline__ int segment_of(const int64_t* first, int m, int64_t b) {
  int s = 0;
  while (s + 1 < m && b >= first[s + 1]) ++s;
  return s;
}

static __device__ __forceinline__ double widen(float x) { return (double)x; }
static __device__ __forceinline__ double widen(double x) { return x; }
static __device__ __forceinline__ double widen(__half x) { return (double)__half2float(x); }
static __device__ __forceinline__ double widen(__nv_bfloat16 x) {
  return (double)__bfloat162float(x);
}

template <typename T>
static __device__ __forceinline__ void pack_tile(const T* __restrict__ src,
                                                 double* __restrict__ dst, int64_t i0,
                                                 int64_t count) {
  T v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + (int64_t)k * kThreads;
    if (i < count) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + (int64_t)k * kThreads;
    if (i < count) dst[i] = widen(v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
ddp_pack_kernel(const __grid_constant__ PackSegs segs, int m, double* __restrict__ dst) {
  const int64_t b = blockIdx.x;
  const int s = segment_of(segs.first, m, b);
  const int64_t i0 = (b - segs.first[s]) * kTile + threadIdx.x;
  const int64_t count = segs.count[s];
  double* d = dst + segs.off[s];
  switch (segs.dtype[s]) {    // uniform across the CTA
    case DT_F32: pack_tile(static_cast<const float*>(segs.src[s]), d, i0, count); break;
    case DT_F64: pack_tile(static_cast<const double*>(segs.src[s]), d, i0, count); break;
    case DT_F16: pack_tile(static_cast<const __half*>(segs.src[s]), d, i0, count); break;
    case DT_BF16:
      pack_tile(static_cast<const __nv_bfloat16*>(segs.src[s]), d, i0, count);
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
ddp_update_kernel(const __grid_constant__ UpdateSegs segs, int m, double* __restrict__ p,
                  double* __restrict__ mom, double inv, double mu, double lr) {
  const int64_t b = blockIdx.x;
  const int s = segment_of(segs.first, m, b);
  const int64_t i0 = (b - segs.first[s]) * kTile + threadIdx.x;
  const int64_t count = segs.count[s];
  const double* __restrict__ r = segs.recv[s];
  double* ps = p + segs.off[s];
  double* ms = mom + segs.off[s];
  double rv[kItems], mv[kItems], pv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + (int64_t)k * kThreads;
    if (i < count) {
      rv[k] = r[i];
      mv[k] = ms[i];
      pv[k] = ps[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = i0 + (int64_t)k * kThreads;
    if (i < count) {
      const double g = __dmul_rn(rv[k], inv);
      const double mm = __dadd_rn(__dmul_rn(mv[k], mu), g);
      ms[i] = mm;
      ps[i] = __dsub_rn(pv[k], __dmul_rn(mm, lr));
    }
  }
}

static int itemsize_of(int dtype) {
  switch (dtype) {
    case DT_F32: return 4;
    case DT_F64: return 8;
    case DT_F16: return 2;
    case DT_BF16: return 2;
  }
  return 0;
}

// Fill first[0..m] from the counts; false when the grid would not fit.
static bool tile_starts(const int64_t* count, int m, int64_t* first) {
  first[0] = 0;
  for (int s = 0; s < m; ++s) first[s + 1] = first[s] + (count[s] + kTile - 1) / kTile;
  return first[m] <= 0x7fffffff;
}

// Cast n gradients into the float64 flat dst: segment s is src[s], count[s]
// elements of dtype[s] (DT_F32, DT_F64, DT_F16 or DT_BF16, contiguous),
// written to dst[off[s] : off[s] + count[s]].
extern "C" int tmt_ddp_pack(const void* const* src, const int* dtype, const int64_t* off,
                            const int64_t* count, int n, void* dst, int* launches,
                            void* stream) {
  if (launches == 0) return TMT_EBADARG;
  *launches = 0;
  if (n < 1 || src == 0 || dtype == 0 || off == 0 || count == 0 || dst == 0)
    return TMT_EBADARG;
  if (!aligned(dst, 8)) return TMT_EBADARG;
  for (int s = 0; s < n; ++s) {
    const int size = itemsize_of(dtype[s]);
    if (size == 0 || count[s] < 0 || off[s] < 0 || (count[s] > 0 && src[s] == 0) ||
        !aligned(src[s], size))
      return TMT_EBADARG;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int done = 0; done < n; done += SEG_MAX) {
    PackSegs segs;
    const int m = n - done < SEG_MAX ? n - done : SEG_MAX;
    for (int s = 0; s < m; ++s) {
      segs.src[s] = src[done + s];
      segs.off[s] = off[done + s];
      segs.count[s] = count[done + s];
      segs.dtype[s] = dtype[done + s];
    }
    if (!tile_starts(segs.count, m, segs.first)) return TMT_EBADARG;
    if (segs.first[m] == 0) continue;
    ddp_pack_kernel<<<(unsigned)segs.first[m], kThreads, 0, st>>>(segs, m,
                                                                  static_cast<double*>(dst));
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

// The SGD-momentum step over n buckets: bucket s's reduced sum recv[s]
// (count[s] contiguous float64) updates master[off[s] : off[s] + count[s]]
// and momentum[...] in place.
extern "C" int tmt_ddp_update(const void* const* recv, const int64_t* off,
                              const int64_t* count, int n, void* master, void* momentum,
                              double inv, double mu, double lr, int* launches,
                              void* stream) {
  if (launches == 0) return TMT_EBADARG;
  *launches = 0;
  if (n < 1 || recv == 0 || off == 0 || count == 0 || master == 0 || momentum == 0)
    return TMT_EBADARG;
  if (!aligned(master, 8) || !aligned(momentum, 8)) return TMT_EBADARG;
  for (int s = 0; s < n; ++s)
    if (count[s] < 0 || off[s] < 0 || (count[s] > 0 && recv[s] == 0) || !aligned(recv[s], 8))
      return TMT_EBADARG;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int done = 0; done < n; done += SEG_MAX) {
    UpdateSegs segs;
    const int m = n - done < SEG_MAX ? n - done : SEG_MAX;
    for (int s = 0; s < m; ++s) {
      segs.recv[s] = static_cast<const double*>(recv[done + s]);
      segs.off[s] = off[done + s];
      segs.count[s] = count[done + s];
    }
    if (!tile_starts(segs.count, m, segs.first)) return TMT_EBADARG;
    if (segs.first[m] == 0) continue;
    ddp_update_kernel<<<(unsigned)segs.first[m], kThreads, 0, st>>>(
        segs, m, static_cast<double*>(master), static_cast<double*>(momentum), inv, mu, lr);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    ++*launches;
  }
  return 0;
}

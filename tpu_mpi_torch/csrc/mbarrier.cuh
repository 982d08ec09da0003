// Shared-memory addresses and mbarriers for the kernels that feed shared
// memory with Hopper's bulk asynchronous copies (TMA): the sm90 ring
// attention (ring_attention_sm90.cu), the ring reduce-scatter (ring.cu) and
// the fused fold (fused_reduce.cu). The last two stage n streams a tile
// with the 1-D bulk copies, the streaming stores and the slice size below.
// sm_90 and later only.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed. A wait that has
// not completed after about 2^35 cycles (some 20 s) traps, so a protocol
// fault fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 35)) __trap();
}

// ---- staging n streams a tile ----------------------------------------------------

// One 1-D bulk asynchronous copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory, completed on the mbarrier
// `bar` by its byte count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A 16-byte store that streams past the caches (st.global.cs).
template <typename W>
__device__ __forceinline__ void store_streaming(W* p, const W& w) {
  static_assert(sizeof(W) == 16, "one 16-byte word");
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&w));
}

const int kSliceBudget = 24 * 1024;    // shared bytes of one tile's n slices
const int kMinSlice = 1024;

// Bytes of one stream's slice of a staged tile of n streams (a multiple of 1
// KiB), or 0 when even kMinSlice bytes cannot be staged. A CTA then holds
// at most kSliceBudget bytes of slices, so several stay resident on an SM.
inline int64_t staged_slice(int n) {
  const int64_t b = ((int64_t)kSliceBudget / n) & ~(int64_t)1023;
  return b >= kMinSlice ? b : 0;
}

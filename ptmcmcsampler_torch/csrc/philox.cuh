// Philox4x32-10, the counter-based generator of Salmon, Moraes, Dror and
// Shaw, "Parallel random numbers: as easy as 1, 2, 3" (SC'11), as Random123
// defines it: ten rounds of two 32 x 32 -> 64-bit multiplies, the key bumped
// by the Weyl constants between rounds. A pure function of (counter, key), so
// a thread draws any element of a stream in any order with no state in
// memory. ops/common.py (philox4x32) computes the same words in PyTorch; the
// CPU tests hold it to Random123's known-answer vectors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptmc {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      key.x += kW0;
      key.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// The top 24 bits of a word as a float in [0, 1): exact in f32.
__device__ __forceinline__ float uniform24(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-08f;  // 2**-24
}

}  // namespace ptmc

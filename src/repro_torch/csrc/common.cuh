// Shared helpers for the hand-written Hopper kernels of repro_torch.
// Every C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Element types the wrappers pass as an int code.
enum ReproDtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16-byte global -> shared copy that bypasses L1 (cp.async.cg); with ok false the
// 16 destination bytes are zero-filled and nothing is read (src must still be a
// valid address). Completion is tracked in commit groups.
__device__ __forceinline__ void async_copy16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// int8 tensor-core product D += A * B, mma.sync m16n8k32 (A 16x32 row-major, B
// 32x8 column-major, s32 accumulators); fragment layouts as in the PTX ISA.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4x4 byte transpose: w[r] holds bytes (k = r, n = 0..3) of four k-rows; t[j]
// gets bytes (n = j, k = 0..3), k-contiguous as the int8 mma operands want them.
__device__ __forceinline__ void transpose4x4(const unsigned (&w)[4], unsigned (&t)[4]) {
  const unsigned lo01 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned hi01 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned lo23 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// int4 codes packed two to a byte: the low / high nibble of each of four bytes,
// sign-extended to a byte: where the nibble's bit 3 is set, 8 * 30 = 0xF0 fills the
// byte's high half (no carry leaves a byte)
__device__ __forceinline__ unsigned nibbles_lo(unsigned p) {
  return (p & 0x0F0F0F0Fu) | ((p & 0x08080808u) * 30u);
}
__device__ __forceinline__ unsigned nibbles_hi(unsigned p) {
  return ((p >> 4) & 0x0F0F0F0Fu) | (((p >> 4) & 0x08080808u) * 30u);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

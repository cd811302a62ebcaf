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

// K7's tile skip (qgemm_decode.cu, qgemm_wgmma.cu): the ascending list of the
// 64-row k-tiles kt < KT in which either of a block's two 64-column occupancy
// columns nt0 and nt0 + 1 (the second may lie past the table's NT columns) is
// nonzero, compacted into shared memory; returns its length. Every thread of the
// block calls it (it synchronises the block); counts holds blockDim.x / 32 ints of
// shared scratch. A pass gives each thread kPer consecutive k-tiles, whose table
// entries it loads at once (one 8-byte load per row where both columns exist, NT
// is even and the table 8-byte aligned); a warp scan of the per-thread counts and
// one prefix over the warps place them, two block barriers per pass (one pass
// covers kPer * blockDim.x rows).
__device__ __forceinline__ int occupied_k_tiles(const int* __restrict__ occ, int KT, int NT,
                                                int nt0, int* list, int* counts) {
  constexpr int kPer = 4;
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool two = nt0 + 1 < NT;
  const bool pair = two && (NT & 1) == 0 && (reinterpret_cast<uintptr_t>(occ) & 7) == 0;
  int total = 0;
  for (int base = 0; base < KT; base += kPer * nthr) {
    const int kt0 = base + kPer * tid;
    int v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int* row = occ + (size_t)(kt0 + i) * NT + nt0;
      v[i] = 0;
      if (kt0 + i < KT) {
        if (pair) {
          const int2 p = *reinterpret_cast<const int2*>(row);
          v[i] = p.x | p.y;
        } else {
          v[i] = row[0] | (two ? row[1] : 0);
        }
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) bits |= (v[i] != 0 ? 1u : 0u) << i;
    const int cnt = __popc(bits);
    int incl = cnt;                                  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) counts[warp] = incl;
    __syncthreads();
    int off = total + incl - cnt;
    for (int w = 0; w < (nthr >> 5); ++w) {
      if (w < warp) off += counts[w];
      total += counts[w];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if ((bits >> i) & 1u) list[off++] = kt0 + i;
    __syncthreads();                                 // the list is complete; counts free
  }
  return total;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

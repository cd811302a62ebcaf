// K4/K5 paged_attention: single-token decode (q_win = 1) and draft-window verify
// (q_win > 1) attention through a page table, with an online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_paged_decode_kernel
// (launcher paged_decode_attention_pallas, pallas_call at flash_attention.py:329),
// which serves both ops.paged_decode_attention (K4) and, with a draft window,
// ops.paged_verify_attention (K5).
//
// q (B, Hkv, R, D) with R = q_win * G rows ordered (window, group); o like q, in
// q's dtype (f32 or bf16). Pools (P, ps, Hkv, D) in f32, bf16 or int8, not
// necessarily q's dtype; with int8 pools the per-token scale pools (P, ps, Hkv, 1)
// f32 are read in that layout directly (row stride Hkv). page_table (B, maxP)
// int32, entries >= P are sentinels and clamp to page P - 1; kv_len (B,) int32;
// q_len (B,) int32 for q_win > 1. Logical position t of slot b lives at pool row
// (page_table[b, t / ps], t % ps). Only positions t < min(kv_len, maxP * ps) are
// visited: a slot walks its ceil(kv_len / ps) live pages and never a dead one.
//
// Numerics, in the reference's order: s = (q . k) * D^-1/2; s *= k_scale; softcap;
// m_new = max(m, max(where(mask, s, -1e30))); p = where(mask, exp(s - m_new), 0);
// l = l * corr + sum(p); acc = acc * corr + (p * v_scale) . V; out = acc / max(l,
// 1e-30). Masks: decode t < kv_len (and kv_len - 1 - t < window); verify row r
// (window token w = r / G, at q_pos = kv_len - q_len + min(w, q_len - 1)) attends
// t <= q_pos (and q_pos - t < window). A slot with kv_len = 0 writes zeros; an
// all-sentinel table row reads page P - 1 and writes finite values.
//
// What bounds it on an H100: each live K/V row is read once per kv head and meets
// R query rows. At the serving shape (Hkv = 4, G = 9, D = 128) the decode does 9
// f32 flops per byte of a bf16 pool, below the 20 per byte where the f32 CUDA
// cores (67 TFLOP/s) overtake the memory (3.35 TB/s): bytes bound. The q_win = 4
// verify does 36 per byte: operation bound. The design keeps the reference's
// memory behaviour: the dense (B, T, Hkv, D) view is never formed, the scale
// pools are not transposed, and sentinel pages past kv_len are never read.
//
// Design: one block of 256 threads per (kv head, slot). The block walks its slot's
// logical positions 32 at a time. A chunk's K and V rows are gathered through the
// page table straight into shared memory with cp.async, in the pool's own type
// (16-byte copies; the int8 scales 4 bytes each), double-buffered: chunk c + 1
// is in flight while chunk c computes, the counterpart of the TPU kernel's two
// DMA slots. Warp w owns query rows w, w + 8, ...; for each, lane t scores key t
// against the row (a D-long dot product, 16-byte reads of the K row, whose padded
// stride keeps a quarter-warp's reads on distinct banks, four partial sums to
// break the latency chain), the warp reduces the chunk's max and sum with
// shuffles, and each lane then updates D / 32 columns of that row's f32
// accumulator (one register each over the chunk's keys), which lives in shared
// memory with the row's running max and denominator.
//
// Later work: split each slot's pages across blocks (flash-decoding) to fill the
// card at small B, and tensor-core products for the q_win > 1 verify.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, KC = 32;
constexpr int kMaxCols = 8;     // accumulator columns per lane: D <= 256
constexpr float kNegInf = -1e30f;

// Shared memory, in bytes: sQ and sAcc (f32 [R][D]); two buffers of K rows (stride
// D * sizeof(TKV) + 16) and V rows (stride D * sizeof(TKV)); two buffers of K and
// V scales [KC]; sP [warps][KC]; sM and sL [R].
template <typename TKV>
size_t smem_bytes(int R, int D) {
  const size_t row = (size_t)D * sizeof(TKV);
  return sizeof(float) * (2 * (size_t)R * D + 4 * KC + kWarps * KC + 2 * R) +
         2 * KC * (2 * row + 16);
}

template <typename TKV> __device__ __forceinline__ float kv_f32(TKV v);
template <> __device__ __forceinline__ float kv_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float kv_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float kv_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                  const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ page_table,
                  const int* __restrict__ kv_len, const int* __restrict__ q_len,
                  TQ* __restrict__ o, int P, int ps, int Hkv, int D, int R, int q_win,
                  int maxP, float scale, int window, float softcap) {
  constexpr int VEC = 16 / sizeof(TKV);          // K elements per 16-byte read
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_bytes = D * sizeof(TKV);
  const int k_stride = row_bytes + 16;           // padded: conflict-free 16-byte reads
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sAcc = sQ + R * D;
  unsigned char* sK = reinterpret_cast<unsigned char*>(sAcc + R * D);   // [2][KC][k_stride]
  unsigned char* sV = sK + 2 * KC * k_stride;                           // [2][KC][row_bytes]
  float* sKs = reinterpret_cast<float*>(sV + 2 * KC * row_bytes);       // [2][KC]
  float* sVs = sKs + 2 * KC;                                            // [2][KC]
  float* sP = sVs + 2 * KC;                                             // [warps][KC]
  float* sM = sP + kWarps * KC;
  float* sL = sM + R;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = R / q_win;
  const int kvl = max(kv_len[b], 0);
  const int qln = q_win > 1 ? q_len[b] : 1;
  const int walk = min(kvl, maxP * ps);       // logical positions that exist
  const int n_chunks = (walk + KC - 1) / KC;
  const bool int8_kv = k_scale != nullptr;
  const int* tab = page_table + (size_t)b * maxP;
  const int pieces = row_bytes / 16;

  // gather chunk c's K/V rows (and scales) into buffer c & 1, asynchronously
  auto stage = [&](int c) {
    const int t0 = c * KC, n = min(KC, walk - t0), buf = c & 1;
    for (int i = tid; i < n * pieces; i += kThreads) {
      const int t = i / pieces, j = i - t * pieces, pos = t0 + t;
      const int page = min(tab[pos / ps], P - 1);
      const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(k_pages) + row * row_bytes;
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(v_pages) + row * row_bytes;
      cp_async16(sK + ((size_t)buf * KC + t) * k_stride + j * 16, kg + j * 16);
      cp_async16(sV + ((size_t)buf * KC + t) * row_bytes + j * 16, vg + j * 16);
    }
    if (int8_kv) {
      for (int t = tid; t < n; t += kThreads) {
        const int pos = t0 + t;
        const int page = min(tab[pos / ps], P - 1);
        const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
        cp_async4(sKs + buf * KC + t, k_scale + row);
        cp_async4(sVs + buf * KC + t, v_scale + row);
      }
    }
  };

  if (n_chunks > 0) stage(0);
  cp_async_commit();
  const TQ* qp = q + ((size_t)b * Hkv + h) * R * D;
  for (int i = tid; i < R * D; i += kThreads) {
    sQ[i] = to_f32(qp[i]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * KC, n = min(KC, walk - t0), buf = c & 1;
    if (c + 1 < n_chunks) stage(c + 1);   // its buffer's last reader finished below
    cp_async_commit();
    cp_async_wait_all_but_one();          // chunk c has landed (this thread's copies)
    __syncthreads();                      // ... and every thread's

    const TKV* kr = reinterpret_cast<const TKV*>(sK + ((size_t)buf * KC + lane) * k_stride);
    const unsigned char* vbuf = sV + (size_t)buf * KC * row_bytes;
    const int k_pos = t0 + lane;
    for (int r = warp; r < R; r += kWarps) {
      float s = 0.f;
      if (lane < n) {
        // four independent partial sums: the dot product is a latency chain
        const float* qr = sQ + r * D;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int d = 0; d < D; d += VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
          const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
          for (int u = 0; u < VEC; u += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + d + u);
            s4[0] = fmaf(q4.x, kv_f32(e[u]), s4[0]);
            s4[1] = fmaf(q4.y, kv_f32(e[u + 1]), s4[1]);
            s4[2] = fmaf(q4.z, kv_f32(e[u + 2]), s4[2]);
            s4[3] = fmaf(q4.w, kv_f32(e[u + 3]), s4[3]);
          }
        }
        s = ((s4[0] + s4[1]) + (s4[2] + s4[3])) * scale;
        if (int8_kv) s *= sKs[buf * KC + lane];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      bool ok = lane < n;
      if (q_win > 1) {
        const int q_pos = kvl - qln + min(r / G, qln - 1);
        ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && (q_pos - k_pos) < window;
      } else {
        ok = ok && k_pos < kvl;
        if (window > 0) ok = ok && (kvl - 1 - k_pos) < window;
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(ok ? s : kNegInf));
      const float p = ok ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_prev - m_new);
      sP[warp * KC + lane] = int8_kv && lane < n ? p * sVs[buf * KC + lane] : p;
      __syncwarp();
      // lane owns columns lane + 32 j: one independent accumulator each
      float pv[kMaxCols];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) pv[j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float pt = sP[warp * KC + t];
        const TKV* vr = reinterpret_cast<const TKV*>(vbuf + t * row_bytes);
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (lane + 32 * j < D) pv[j] = fmaf(pt, kv_f32(vr[lane + 32 * j]), pv[j]);
      }
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int d = lane + 32 * j;
        if (d < D) sAcc[r * D + d] = sAcc[r * D + d] * corr + pv[j];
      }
      __syncwarp();    // every lane has read sM[r] and sP before they change
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + psum;
      }
      __syncwarp();
    }
    __syncthreads();   // chunk c's buffer is free for chunk c + 2
  }
  __syncthreads();     // a slot with no live position still zeroes its output

  TQ* op = o + ((size_t)b * Hkv + h) * R * D;
  for (int i = tid; i < R * D; i += kThreads)
    op[i] = from_f32<TQ>(__fdiv_rn(sAcc[i], fmaxf(sL[i / D], 1e-30f)));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scale,
           const float* v_scale, const int* page_table, const int* kv_len, const int* q_len,
           void* o, int B, int Hkv, int R, int D, int P, int ps, int maxP, int q_win,
           float scale, int window, float softcap, cudaStream_t s) {
  const size_t smem = smem_bytes<TKV>(R, D);
  cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_kernel<TQ, TKV><<<dim3(Hkv, B), kThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scale, v_scale, page_table, kv_len, q_len,
      static_cast<TQ*>(o), P, ps, Hkv, D, R, q_win, maxP, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int dispatch_kv(int kv_dtype, const void* q, const void* k_pages, const void* v_pages,
                const float* k_scale, const float* v_scale, const int* page_table,
                const int* kv_len, const int* q_len, void* o, int B, int Hkv, int R, int D,
                int P, int ps, int maxP, int q_win, float scale, int window, float softcap,
                cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, k_pages, v_pages, k_scale, v_scale, page_table, kv_len,
                               q_len, o, B, Hkv, R, D, P, ps, maxP, q_win, scale, window,
                               softcap, s);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                       kv_len, q_len, o, B, Hkv, R, D, P, ps, maxP, q_win,
                                       scale, window, softcap, s);
    case kI8:
      if (k_scale == nullptr || v_scale == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<TQ, int8_t>(q, k_pages, v_pages, k_scale, v_scale, page_table, kv_len,
                                q_len, o, B, Hkv, R, D, P, ps, maxP, q_win, scale, window,
                                softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_win = 1: decode (q_len may be null); q_win > 1: verify, q_len (B,) required.
// k_scale/v_scale: (P, ps, Hkv, 1) f32 pools for int8 K/V, else null. window <= 0:
// no sliding window; softcap <= 0: no softcap; scale is D^-0.5 rounded to f32.
REPRO_API int repro_paged_attention(const void* q, int q_dtype, const void* k_pages,
                                    const void* v_pages, int kv_dtype, const float* k_scale,
                                    const float* v_scale, const int* page_table,
                                    const int* kv_len, const int* q_len, void* o, int B,
                                    int Hkv, int R, int D, int P, int ps, int maxP,
                                    int q_win, int window, float softcap, float scale,
                                    void* stream) {
  if (B == 0 || Hkv == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  if (q_win < 1 || R % q_win != 0 || (q_win > 1 && q_len == nullptr) || P < 1 || ps < 1 ||
      maxP < 1 || D < 16 || D % 16 != 0 || D > 32 * kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scale, v_scale, page_table,
                              kv_len, q_len, o, B, Hkv, R, D, P, ps, maxP, q_win, scale,
                              window, softcap, s);
  if (q_dtype == kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scale, v_scale,
                                      page_table, kv_len, q_len, o, B, Hkv, R, D, P, ps,
                                      maxP, q_win, scale, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

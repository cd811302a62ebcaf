// K3 flash_attention: causal prefill attention, forward, with an online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fa_kernel (launcher
// flash_attention_pallas, pallas_call at flash_attention.py:606).
//
// q (B, H, Sq, D), k/v (B, Hkv, Sk, D), f32 or bf16, row-major; o like q. Query
// head h reads kv head h / (H / Hkv) (GQA, no broadcast copy). Optional per-batch
// kv_len (B,) int32, already clipped to [0, Sk], masks keys >= kv_len[b] (right-
// padded serving prefill); optional sliding window and logit softcap. Masked
// scores are -1e30 and the denominator is floored at 1e-30, as in the reference.
//
// What bounds it on an H100: at these shapes (S <= 1024, D = 128) the causal
// score and PV products are ~2*S*D operations per query row per head against
// ~4*D bytes of q/o and a shared k/v stream: operation-bound. This first version
// does the arithmetic in f32 on the CUDA cores, exactly as the reference kernel
// does in f32 (it casts bf16 tiles up), so it is bound far below the bf16 tensor-
// core rate; what the design does keep is the reference's memory behaviour: no
// S x S score matrix ever reaches device memory.
//
// Design: one block of 256 threads per (batch*head, 64-query tile). K/V tiles of
// 64 keys are staged in shared memory as f32; each thread owns a 4 x 4 patch of
// the 64 x 64 score tile (rows ty + 16i, keys tx + 16c), reduces row max and row
// sum with shuffles across the 16 threads that share a row, and keeps the same 4
// rows of the f32 accumulator (D/16 columns each), so the running max, the
// denominator and the rescale factor never leave registers. Tiles strictly above
// the causal diagonal, and tiles wholly at or past kv_len, are skipped.
//
// Later work: mma/wgmma in bf16 with f32 accumulation, K/V double buffering with
// cp.async or TMA, and a 128-row query tile per warpgroup.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK: [64][D+1] (padded rows: conflict-free column reads), sV: [64][D],
  // sP: [64][65]
  return sizeof(float) * (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ kv_len, int H, int Hkv, int Sq,
              int Sk, float scale, int causal, int window, float softcap) {
  constexpr int LD = D + 1, LP = BKV + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sP = sV + BKV * D;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * Sk * D;
  const int kvl = kv_len != nullptr ? kv_len[b] : Sk;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[r * LD + d] = (q0 + r < Sq) ? to_f32(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // live tiles: below the causal diagonal of this query tile and before kv_len
  int n_tiles = (kvl + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the previous tile's PV pass is done with sK/sV/sP
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < Sk;
      sK[r * LD + d] = in ? to_f32(kp[(size_t)(k0 + r) * D + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vp[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < Sk && kj < kvl;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && (qi - kj) < window;
        s[i][c] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sP[(ty + 16 * i) * LP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float pj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pj[i] = sP[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pj[i], vv, acc[i][c]);
      }
    }
  }

  T* op = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      op[(size_t)qi * D + tx + 16 * c] = from_f32<T>(__fdiv_rn(acc[i][c], denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* kv_len, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, H, Hkv, Sq, Sk, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, const int* kv_len,
               int B, int H, int Hkv, int Sq, int Sk, int D, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no logit softcap; kv_len may be null;
// scale is D^-0.5 rounded to f32 by the caller, as the reference computes it.
REPRO_API int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    const int* kv_len, int dtype, int B, int H, int Hkv,
                                    int Sq, int Sk, int D, int causal, int window,
                                    float softcap, float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, D, causal, window, softcap, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, D, causal, window,
                                     softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

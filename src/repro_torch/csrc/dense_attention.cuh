// Dense decode / verify attention: the W query rows of each slot (W = 1 at decode,
// the draft window at verify) against that slot's rows of a dense (B, T, Hkv, D)
// KV cache, with per-slot valid lengths, an optional sliding window and logit
// softcap.
//
// Replaces no TPU kernel: the reference computes this attention with XLA einsums
// outside any Pallas kernel (src/repro/models/layers.py:292 decode_attention and
// :332 verify_attention), and the port's plain version keeps that form
// (src/repro_torch/models/layers.py decode_attention / verify_attention). It was
// added so that every output element is summed in one order that depends only on
// the slot's key walk, D and the launch constants, and never on B, Hkv, the GQA
// group size G or the rows a block holds. On the card the einsum form runs as
// cuBLAS batched GEMMs over (slot, kv head), whose algorithm cuBLAS picks by the
// batch count: a tensor-parallel rank holding 2 of 4 kv heads, or a GQA group of 1
// (uneven tp_kv_rep), rounded otherwise than one device. With this kernel a rank's
// heads give one device's bits.
//
//   q (B, W, H, D) f32 | bf16; k, v (B, T, Hkv, D) f32 | bf16 | int8 codes with
//   k_scale, v_scale (B, T, Hkv, 1) f32; cur_len (B,) int32; q_len (B,) int32 or
//   null (decode: W = 1, q_len 1); o (B, W, H, D) in q's type. Window row w of slot
//   b sits at q_pos = cur_len - q_len + min(w, q_len - 1) and sees the keys t <= q_pos
//   with q_pos - t < window (window 0: none cut); a row that sees no key attends to
//   all T keys uniformly, as the einsum form's softmax over -1e30 scores does.
//
// Rounding follows the einsum form's points: q.k summed in f32 and rounded to the
// promoted type of q and the cache (bf16 only for a bf16 q on a bf16 cache; f32 for
// an int8 cache, whose codes the plain version widens to f32), times D^-0.5 in that
// type; then in f32 the K scale (int8), the softcap, the mask (-1e30) and a
// two-pass softmax; p rounded to the cache's type before p.v (bf16), or p times the
// V scale in f32 (int8); p.v summed in f32 and rounded to the cache's type (bf16)
// and to q's.
//
// The fixed order. A block of 256 threads holds up to 8 query rows of one (slot, kv
// head). Scores: one thread per key, the dot product over d = 0 .. D-1 in sequence.
// Softmax: one warp per row; lane l sums the keys t = l (mod 32) in increasing t, a
// butterfly over the 32 lanes merges them. p.v: thread (c, j) sums for output
// columns 4c .. 4c + 3 the groups of 4 keys g = j (mod 1024 / D), g = t / 4, in
// increasing t; then stripe 0 + 1 + ... in sequence. Every index is the key's absolute position,
// so keys outside the slot's walk, whose p is exactly 0, change no sum. Nothing
// in it reads B, Hkv, G or which rows share a block, and no atomics.
//
// Where the scores live. A block keeps its rows' scores (then p) and the walk's V
// scales, (rows + 1) x T floats, in shared memory; where not even one row's fit in
// the plan's shared memory (T past ~24k, e.g. a 32k context), in a global scratch
// of that size a block (kSpill, its instantiations built from
// dense_attention_spill.cu). The arithmetic and its order are the same either way,
// so the two give the same bits.
//
// What bounds it on an H100: at decode it reads each visible K and V row once per
// (slot, kv head), D bytes a row (int8), for 4 D operations per visible key and
// query row: bound by bytes. Its design is for a fixed order, not for speed: a
// block holds few rows (kernels/dense_attention.py::dense_plan gives each block
// one row where that fills the card's 132 SMs, so a slot's K and V rows are read
// once per block, mostly from L2), the products run on the CUDA cores from
// shared-memory broadcasts of q and p, and one warp a row does the softmax. What
// it does about latency: a thread loads 4 keys' rows (the scores) and 8 groups of
// 4 keys' V rows (p.v) before it uses any of them, every load unconditional (a key
// past the walk reads the walk's last row and is discarded or weighted by p = 0).
#pragma once

// The kernel, its launches and its dispatch by type and D, for dense_attention.cu
// (the C entry, scores in shared memory) and dense_attention_spill.cu (scores in
// the global scratch).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kMaxRows = 8, kGroup = 4, kKeys = 4, kBatch = 8;
constexpr float kNegInf = -1e30f;

template <typename T> struct Chunk;      // 16 bytes of a cache or q row, widened to f32
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float (&x)[16]) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
};

template <typename T> struct Quad;       // 4 consecutive elements of a V row, widened to f32
template <> struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xFFFF0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
};
template <> struct Quad<int8_t> {
  static __device__ __forceinline__ void load(const int8_t* p, float (&x)[4]) {
    const int v = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = static_cast<float>(static_cast<int8_t>(v >> (8 * i)));
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// window row w's position
__device__ __forceinline__ int row_pos(int w, int cl, int ql) { return cl - ql + min(w, ql - 1); }

// kSpill: the rows' scores and the walk's V scales live in a global scratch, (rows +
// 1) x tpad floats a block, where shared memory cannot hold them (long caches)
template <typename QT, typename CT, int D, bool kSpill>
__global__ void __launch_bounds__(kThreads)
dense_attention_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
                       const CT* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ cur_len,
                       const int* __restrict__ q_len, QT* __restrict__ o, float* scratch,
                       int W, int H, int Hkv, int T, int rows, float scale, int window,
                       float softcap) {
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  // the einsum form's promoted score type: bf16 only for a bf16 q on a bf16 cache
  constexpr bool kBf16Scores = std::is_same<QT, __nv_bfloat16>::value &&
                               std::is_same<CT, __nv_bfloat16>::value;
  constexpr bool kBf16Cache = std::is_same<CT, __nv_bfloat16>::value;
  constexpr int KC = Chunk<CT>::N, KS = kThreads * 4 / D;
  const int tpad = (T + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [rows][D]
  float* sP = sQ + rows * D;              // [KS][rows][D]: p.v stripe partials
  float* sS = kSpill ? scratch + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                                  blockIdx.x) * (rows + 1) * tpad
                     : sP + KS * rows * D;  // [rows][tpad]: scores, then p
  float* sVs = sS + rows * tpad;          // [tpad]: the walk's V scales (int8)

  const int G = H / Hkv, R = W * G;
  const int b = blockIdx.z, hk = blockIdx.y, r0 = blockIdx.x * rows;
  const int nr = min(rows, R - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = cur_len[b], ql = q_len != nullptr ? q_len[b] : 1;

  // the slot's key walk [lo, hi): the union of its W rows' visible keys, every key
  // where a row sees none; lo rounded down to a multiple of 4 (p.v's groups)
  int lo = T, hi = 0;
  bool empty_row = false;
  for (int w = 0; w < W; ++w) {
    const int qp = row_pos(w, cl, ql);
    const int a = window > 0 ? max(0, qp - window + 1) : 0, e = min(T, qp + 1);
    if (e <= a) {
      empty_row = true;
    } else {
      lo = min(lo, a);
      hi = max(hi, e);
    }
  }
  if (empty_row) {
    lo = 0;
    hi = T;
  }
  lo &= ~3;
  const int n = hi - lo, n4 = (n + 3) & ~3;

  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    const int w = row / G, g = row % G;
    sQ[i] = to_f32(q[((size_t)(b * W + w) * H + hk * G + g) * D + d]);
  }
  __syncthreads();

  // scores: one key a thread, every row of the block; the dot product in d order. A
  // thread takes kKeys keys kThreads apart at once, so their row loads are in flight
  // together
  for (int t0 = lo + tid; t0 < hi; t0 += kKeys * kThreads) {
    float acc[kKeys][kMaxRows];
#pragma unroll
    for (int u = 0; u < kKeys; ++u)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[u][r] = 0.f;
    // a key past the walk reads the walk's last row (its score is not stored), so
    // every load is unconditional and the compiler can put them all in flight
    const CT* kr[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u)
      kr[u] = k + ((size_t)(b * T + min(t0 + u * kThreads, hi - 1)) * Hkv + hk) * D;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += KC) {
      float kx[kKeys][KC];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) Chunk<CT>::load(kr[u] + d0, kx[u]);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
#pragma unroll
          for (int c = 0; c < KC; c += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(sQ + r * D + d0 + c);
#pragma unroll
            for (int u = 0; u < kKeys; ++u) {
              acc[u][r] = fmaf(qv.x, kx[u][c], acc[u][r]);
              acc[u][r] = fmaf(qv.y, kx[u][c + 1], acc[u][r]);
              acc[u][r] = fmaf(qv.z, kx[u][c + 2], acc[u][r]);
              acc[u][r] = fmaf(qv.w, kx[u][c + 3], acc[u][r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int t = t0 + u * kThreads;
      if (t >= hi) break;
      float ks = 1.f;
      if constexpr (kInt8) {
        ks = k_scale[(size_t)(b * T + t) * Hkv + hk];
        sVs[t - lo] = v_scale[(size_t)(b * T + t) * Hkv + hk];   // for the softmax's p
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          const int qp = row_pos((r0 + r) / G, cl, ql);
          float s;
          if constexpr (kBf16Scores) {
            s = round_bf16(round_bf16(acc[u][r]) * scale);
          } else {
            s = acc[u][r] * scale;
          }
          if constexpr (kInt8) s *= ks;
          if (softcap > 0.f) s = softcap * tanhf(__fdiv_rn(s, softcap));
          const bool ok = t <= qp && (window <= 0 || qp - t < window);
          sS[r * tpad + (t - lo)] = ok ? s : kNegInf;
        }
      }
    }
  }
  __syncthreads();

  // softmax: warp r owns row r; lane l the keys t = l (mod 32)
  if (warp < nr) {
    float* srow = sS + warp * tpad;
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, srow[i]);
    mx = warp_max(mx);                   // a max: exact in any order
    const int first = lo + ((lane - lo) & 31);
    float sum = 0.f;
    for (int t = first; t < hi; t += 32) {
      const float e = expf(srow[t - lo] - mx);
      srow[t - lo] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int t = first; t < hi; t += 32) {
      float p = __fdiv_rn(srow[t - lo], sum);
      if constexpr (kInt8) {
        p *= sVs[t - lo];
      } else if constexpr (kBf16Cache) {
        p = round_bf16(p);
      }
      srow[t - lo] = p;
    }
    if (lane < n4 - n) srow[n + lane] = 0.f;
  }
  __syncthreads();

  // p.v: thread (c, j) sums columns 4c .. 4c + 3 over the key groups g = j (mod KS),
  // g = t / 4, in increasing t; then the KS stripe partials in order
  {
    const int dv = (tid % (D / 4)) * 4, j = tid / (D / 4);
    float acc[kMaxRows][4];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    const int g0 = lo / kGroup, g_end = (hi + kGroup - 1) / kGroup;
    const CT* vc = v + ((size_t)b * T * Hkv + hk) * D + dv;
    // kBatch of the stripe's groups at a time: their V rows loaded first (a key past
    // the walk reads the walk's last row, against p = 0), then summed in key order
    for (int gb = g0 + ((j - g0) % KS + KS) % KS; gb < g_end; gb += kBatch * KS) {
      float vx[kBatch][kGroup][4];
#pragma unroll
      for (int n = 0; n < kBatch; ++n)
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          Quad<CT>::load(vc + (size_t)min((gb + n * KS) * kGroup + i, hi - 1) * Hkv * D,
                         vx[n][i]);
#pragma unroll
      for (int n = 0; n < kBatch; ++n) {
        const int t = (gb + n * KS) * kGroup;
        if (t >= hi) break;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            const float4 p = *reinterpret_cast<const float4*>(sS + r * tpad + (t - lo));
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(p.x, vx[n][0][c], acc[r][c]);
              acc[r][c] = fmaf(p.y, vx[n][1][c], acc[r][c]);
              acc[r][c] = fmaf(p.z, vx[n][2][c], acc[r][c]);
              acc[r][c] = fmaf(p.w, vx[n][3][c], acc[r][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < nr)
        *reinterpret_cast<float4*>(sP + (j * rows + r) * D + dv) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    float sum = sP[r * D + d];
#pragma unroll
    for (int j = 1; j < KS; ++j) sum += sP[(j * rows + r) * D + d];
    if constexpr (kBf16Cache) sum = round_bf16(sum);
    const int w = row / G, g = row % G;
    o[((size_t)(b * W + w) * H + hk * G + g) * D + d] = from_f32<QT>(sum);
  }
}

template <typename QT, typename CT, int D, bool kSpill>
int launch_body(const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* cur_len, const int* q_len, void* o,
                float* scratch, int B, int W, int H, int Hkv, int T, int rows, float scale,
                int window, float softcap, cudaStream_t s) {
  const size_t tpad = (T + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)rows * (D + 4 * kThreads) +
                                       (kSpill ? 0 : (rows + 1) * tpad));
  cudaError_t err = cudaFuncSetAttribute(dense_attention_kernel<QT, CT, D, kSpill>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = W * (H / Hkv);
  dim3 grid((R + rows - 1) / rows, Hkv, B);
  dense_attention_kernel<QT, CT, D, kSpill><<<grid, kThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), k_scale,
      v_scale, cur_len, q_len, static_cast<QT*>(o), scratch, W, H, Hkv, T, rows, scale, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// the launches of one layout (kSpill: the scores in the global scratch), by q's and
// the cache's type and D
template <bool kSpill>
int dense_dispatch(int q_dtype, int kv_dtype, int D, const void* q, const void* k,
                   const void* v, const float* k_scale, const float* v_scale,
                   const int* cur_len, const int* q_len, void* o, float* scratch, int B, int W,
                   int H, int Hkv, int T, int rows, float scale, int window, float softcap,
                   cudaStream_t s) {
#define REPRO_DA_CASE(QC, QT, KC, CT, DD)                                                     \
  if (q_dtype == QC && kv_dtype == KC && D == DD)                                             \
    return launch_body<QT, CT, DD, kSpill>(q, k, v, k_scale, v_scale, cur_len, q_len, o,      \
                                           scratch, B, W, H, Hkv, T, rows, scale, window,     \
                                           softcap, s);
#define REPRO_DA_CASES(QC, QT, KC, CT)                                                        \
  REPRO_DA_CASE(QC, QT, KC, CT, 16)                                                           \
  REPRO_DA_CASE(QC, QT, KC, CT, 32)                                                           \
  REPRO_DA_CASE(QC, QT, KC, CT, 64)                                                           \
  REPRO_DA_CASE(QC, QT, KC, CT, 128)                                                          \
  REPRO_DA_CASE(QC, QT, KC, CT, 256)
  REPRO_DA_CASES(kBF16, __nv_bfloat16, kF32, float)
  REPRO_DA_CASES(kBF16, __nv_bfloat16, kBF16, __nv_bfloat16)
  REPRO_DA_CASES(kBF16, __nv_bfloat16, kI8, int8_t)
  REPRO_DA_CASES(kF32, float, kF32, float)
  REPRO_DA_CASES(kF32, float, kBF16, __nv_bfloat16)
  REPRO_DA_CASES(kF32, float, kI8, int8_t)
#undef REPRO_DA_CASES
#undef REPRO_DA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dense_attention_spill.cu: the launches with the scores in the global scratch, the
// arguments as dense_dispatch's
int dense_attention_spill(int q_dtype, int kv_dtype, int D, const void* q, const void* k,
                          const void* v, const float* k_scale, const float* v_scale,
                          const int* cur_len, const int* q_len, void* o, float* scratch, int B,
                          int W, int H, int Hkv, int T, int rows, float scale, int window,
                          float softcap, cudaStream_t s);

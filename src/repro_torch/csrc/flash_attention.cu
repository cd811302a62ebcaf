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
// Both bodies visit the same key tiles of 64: those before kv_len and, when
// causal, at or below the 64-row query tile's diagonal. So a row with no valid
// key (past kv_len) averages the v rows of the tiles its block visits, as the
// reference kernel's row does (it gives 0 where no tile is visited, kv_len 0).
//
// Head sizes: D = 16, 32, 64, 80, 128 and 256, each its own instantiation. D = 80
// (hubert-xlarge) is not a power of two but a multiple of 16: the bf16 body runs 5
// k16 steps of Q K^T and 10 n8 tiles of P V, and its 88-element (176-byte) shared
// rows keep cp.async and ldmatrix 16-byte aligned and map ldmatrix's 8 rows to 8
// distinct 4-bank groups; the f32 body gives each thread 5 columns of 16.
//
// What bounds it on an H100: at these shapes (S <= 1024, D = 128) the causal
// score and PV products are ~2*S*D operations per query row per head against
// ~4*D bytes of q/o and a shared k/v stream: operation-bound. Three bodies, chosen
// by dtype and head size (not a fallback: a body that cannot launch raises):
//
// bf16 at D = 256 (gemma2-9b's prefill, every layer): the wgmma body, below the
// mma.sync body.
//
// bf16 at the other head sizes (the serving path): FlashAttention-2 on the bf16
// tensor cores. A block of
// 4 warps owns 64 query rows of one (batch, head), 16 rows per warp. QK^T and PV
// run on mma.sync.m16n8k16.bf16 with f32 accumulators. The Q fragments load once
// with ldmatrix into registers, K fragments come from shared memory with ldmatrix
// and V fragments with ldmatrix.trans. The S accumulator fragment is repacked in registers as PV's A
// operand, so P never goes to shared memory; the online softmax stays in
// registers, row max through quad shuffles, row sums per thread until the end.
// K/V tiles of 64 keys stream through a ring of cp.async stages (16 B per thread,
// rows past Sk zero-filled; 3 stages), so the next
// tiles' copies overlap this tile's MMAs, one barrier per tile; rows
// are padded to D + 8 elements so ldmatrix reads are conflict-free. A warp skips
// the MMAs of a tile wholly above its 16 rows' diagonal; query tiles run last
// to first, so the longest causal rows start first. What still holds it above
// its bound: each of the 4 warps reads the whole K and V tile from shared memory
// (one ldmatrix.x4 per two MMAs), about as many shared-memory cycles as the
// mma.sync pipe needs, and a block walks only ~4 tiles at S = 512, so its
// prologue is exposed. At D = 256 it kept Q in shared memory and 2 stages, one
// block of 4 warps an SM, and reached 10 % of its bound: the wgmma body replaced it
// there.
// Numerics: bf16 products are exact in the f32 accumulator, so QK^T differs
// from the reference (f32 tiles, flash_attention.py:67-68,88) only in summation
// order. The one new rounding is P -> bf16 before PV; the denominator sums the
// same rounded P, so each row stays a convex combination of v rows.
//
// f32 (the card-vs-CPU parity runs): the arithmetic in f32 on the CUDA cores, as
// the reference does. One block of 256 threads per (batch*head, 64-query tile).
// K/V tiles of 64 keys are staged in shared memory as f32; each thread owns a 4 x
// 4 patch of the 64 x 64 score tile (rows ty + 16i, keys tx + 16c), reduces row
// max and row sum with shuffles across the 16 threads that share a row, and keeps
// the same 4 rows of the f32 accumulator (D/16 columns each), so the running max,
// the denominator and the rescale factor never leave registers. Tiles strictly
// above the causal diagonal, and tiles wholly at or past kv_len, are skipped.
#include <climits>

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- f32 body

template <int D>
constexpr size_t smem_bytes_f32() {
  // sQ, sK: [64][D+1] (padded rows: conflict-free column reads), sV: [64][D],
  // sP: [64][65]
  return sizeof(float) * (2 * BQ * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
int launch_f32(const void* q, const void* k, const void* v, void* o, const int* kv_len, int B,
           int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_f32_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_f32_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, H, Hkv, Sq, Sk, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 body

constexpr int kTcThreads = 128;          // 4 warps x 16 query rows

template <int D>
__host__ __device__ constexpr int tc_ld() { return D + 8; }  // bf16 elements per shared row (16-byte pad)

// Q's fragments stay in registers (Q is staged in the last ring buffer's V tile
// and read once) and K/V ring through 3 stages: 104 KB at D = 128, two blocks per SM
constexpr int kTcStages = 3;

template <int D>
constexpr size_t smem_bytes_tc() {       // sK/sV [stages][64][D+8]
  return sizeof(__nv_bfloat16) * 2 * kTcStages * BKV * tc_ld<D>();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two f32 -> one register of two bf16 (lo, hi), and the rounded values back
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi, float& rlo, float& rhi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  rlo = __low2float(v);
  rhi = __high2float(v);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 64 rows of D bf16 from row r0 of src (rows >= n_rows zero-filled) into dst
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int n_rows, int tid) {
  constexpr int CH = D / 8;              // 16-byte chunks per row
#pragma unroll 4
  for (int c = tid; c < 64 * CH; c += kTcThreads) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n_rows;
    async_copy16(dst + r * tc_ld<D>() + ch * 8, ok ? src + (size_t)(r0 + r) * D + ch * 8 : src,
                 ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ kv_len, int H, int Hkv, int Sq, int Sk, float scale,
               int causal, int window, float softcap) {
  constexpr int LD = tc_ld<D>(), KD = D / 16, DT = D / 8, NT = BKV / 8;
  static_assert(D <= 128, "bf16 at D = 256 runs the wgmma body");
  constexpr int NS = kTcStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [NS][BKV][LD]
  __nv_bfloat16* sV = sK + NS * BKV * LD;
  __nv_bfloat16* sQ = sV + (NS - 1) * BKV * LD;                     // the last V tile

  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wq0 = q0 + 16 * warp;        // this warp's first query row
  const __nv_bfloat16* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const __nv_bfloat16* vp = v + (size_t)(b * Hkv + hk) * Sk * D;
  const int kvl = kv_len != nullptr ? kv_len[b] : Sk;

  int n_tiles = (kvl + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  // the ring: tile t in buffer t % NS, NS - 1 tiles in flight; Q with tile 0
  stage_rows<D>(sQ, q + (size_t)bh * Sq * D, q0, Sq, tid);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_tiles) {
      stage_rows<D>(sK + t * BKV * LD, kp, t * BKV, Sk, tid);
      stage_rows<D>(sV + t * BKV * LD, vp, t * BKV, Sk, tid);
    }
    async_commit();
  }

  // ldmatrix lane addressing: Q (A, x4) rows lane % 16, d half lane / 16; K (B,
  // x4: two key tiles x two d halves) key (lane % 8) + 8 (lane / 16), d half
  // (lane / 8) % 2; V (B, x4.trans: two d tiles x two key halves) key (lane % 8)
  // + 8 ((lane / 8) % 2), d tile lane / 16
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  unsigned qf[KD][4];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % NS, k0 = t * BKV;
    async_wait<NS - 2>();                // tile t (and Q) landed for this thread ...
    __syncthreads();                     // ... and every thread's, and tile t - 1 is done
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], sQ + (16 * warp + a_row) * LD + kd * 16 + a_col);
      __syncthreads();                   // Q read: its buffer takes tile NS - 1 now
    }
    if (t + NS - 1 < n_tiles) {          // the copy overlaps this tile's MMAs
      const int nb = (t + NS - 1) % NS;
      stage_rows<D>(sK + nb * BKV * LD, kp, k0 + (NS - 1) * BKV, Sk, tid);
      stage_rows<D>(sV + nb * BKV * LD, vp, k0 + (NS - 1) * BKV, Sk, tid);
    }
    async_commit();
    const __nv_bfloat16* cK = sK + buf * BKV * LD;
    const __nv_bfloat16* cV = sV + buf * BKV * LD;
    // a tile wholly above this warp's 16 rows adds exp(-1e30 - m) = 0 to rows
    // that all have a valid key earlier: skip its MMAs
    if (!(causal && k0 > wq0 + 15)) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned af[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[kd][i];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned kb[4];
          ldmatrix_x4(kb, cK + (j * 8 + k_row) * LD + kd * 16 + k_col);
          mma_bf16(s[j], af, kb[0], kb[1]);
          mma_bf16(s[j + 1], af, kb[2], kb[3]);
        }
      }
      // scale, softcap, then the masks where the tile needs them, branch-free; s[j][e]
      // is row g + 8(e/2), key 8j + 2tg + e%2
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = softcap * tanhf(s[j][e] * scale / softcap);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      }
      if ((causal && k0 + BKV - 1 > wq0) || k0 + BKV > kvl || window > 0) {
        const int qi0 = wq0 + g, kj0 = k0 + 2 * tg;
        const int win = window > 0 ? window : INT_MAX;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qi0 + 8 * (e >> 1), kj = kj0 + 8 * j + (e & 1);
            const bool ok = (kj < kvl) & (!causal | (qi >= kj)) & (qi - kj < win);
            s[j][e] = ok ? s[j][e] : kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = __expf(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // P = exp(s - m) rounded to bf16, repacked as PV's A operand: key chunk kc
      // (16 keys) = score tiles 2kc (a0, a1) and 2kc + 1 (a2, a3)
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        unsigned pa[4];
        float r0, r1;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float(&c)[4] = s[2 * kc + hh];
          pa[2 * hh] = pack_bf16(__expf(c[0] - m_r[0]), __expf(c[1] - m_r[0]), r0, r1);
          l_r[0] += r0 + r1;
          pa[2 * hh + 1] = pack_bf16(__expf(c[2] - m_r[1]), __expf(c[3] - m_r[1]), r0, r1);
          l_r[1] += r0 + r1;
        }
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, cV + (kc * 16 + v_row) * LD + dt * 8 + v_col);
          mma_bf16(acc[dt], pa, vb[0], vb[1]);
          mma_bf16(acc[dt + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  async_wait<0>();                       // no copy outlives the block (kv_len 0: Q's)

  __nv_bfloat16* op = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qi = wq0 + g + 8 * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(__fdiv_rn(acc[dt][2 * r], denom),
                                                       __fdiv_rn(acc[dt][2 * r + 1], denom));
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)qi * D + dt * 8 + 2 * tg) = val;
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const int* kv_len, int B,
                int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_tc<D>();
  cudaError_t err = cudaFuncSetAttribute(fa_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_bf16_kernel<D><<<grid, kTcThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), kv_len, H, Hkv, Sq,
      Sk, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 wgmma body, D = 256
//
// A block owns 128 query rows of one (batch, head): two consumer warpgroups of 64
// rows each and a producer warpgroup, one thread of which issues every copy.
// - Loads: Q (128 x 256 bf16, 64 KB) once by TMA, as four 64-column boxes under the
//   128-byte swizzle; K and V tiles of 64 keys (32 KB each, four boxes) through a
//   ring of 2 stages, each tile's K and V on "full" mbarriers of their own (the
//   scores start before V lands), a stage released on its "empty" mbarrier by the
//   8 consumer warps. 3-D tensor maps (D, S, batch x head) zero-fill rows past Sq
//   and keys past Sk, as the mma.sync body's cp.async does. 192 KB of shared memory,
//   one block an SM.
// - S = Q K^T: 16 wgmma.m64n64k16 a tile, A (Q) and B (K) both from shared memory
//   through K-major descriptors.
// - Scale, softcap, masks, the online softmax and the P -> bf16 rounding run in
//   registers, as the mma.sync body's do: the S accumulator's layout is the m16n8
//   fragment's, so P repacks in registers into PV's A operand. The softcap's tanh
//   is an exp and a reciprocal (within ~1e-7 of tanhf's): with tanhf the softcap
//   took more than half the body's time at gemma2's shape.
// - O += P V: 4 wgmma.m64n256k16 a tile, P from registers, V from shared memory as
//   an MN-major (transposed) operand: no transpose copy of V.
// - O is 64 x 256 f32 a warpgroup, 128 registers a thread: setmaxnreg gives the
//   consumers 240 and the producer 24.
// Numerics and visit rule as the mma.sync body's: each warpgroup walks the 64-key
// tiles its 64-row tile would (up to kv_len and its causal diagonal; a row past
// kv_len visits ceil(kv_len / 64) of them either way), masked scores -1e30, the
// denominator the sum of the rounded P floored at 1e-30. Tiles behind the window
// are not skipped (that would change the rows that see none of their keys). What
// still holds it above its bound: each warpgroup waits for its S product before
// the softmax and for its PV product before the next tile (no ping-pong between
// the warpgroups, no overlap of one tile's softmax with the next tile's S).

namespace wg {
constexpr int D = 256, BQW = 128, BK = 64, kStages = 2;
// two consumer warpgroups and a producer warpgroup, of which one thread issues the
// copies: setmaxnreg moves the producer's registers to the consumers (168 a thread at
// launch; 24 and 240 after), so the registers the producer frees are the ones the
// consumers take
constexpr int kConsumers = 256, kWgThreads = kConsumers + 128;
constexpr int COL_Q = BQW * 128, COL_KV = BK * 128;  // one 64-column (128-byte) block of a tile
constexpr int Q_BYTES = 4 * COL_Q, KV_BYTES = 4 * COL_KV;
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 3 * kStages);
}  // namespace wg

__global__ void __launch_bounds__(wg::kWgThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                const int* __restrict__ kv_len, int H, int Hkv, int Sq, int Sk, float scale,
                int causal, int window, float softcap) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + Q_BYTES;                  // [stage][column block][key][128 B]
  unsigned char* sV = sK + kStages * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.y, b = bh / H, hk = bh % H / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQW;
  const int kvl = kv_len != nullptr ? kv_len[b] : Sk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the 64-key tiles the 64-row query tile at r0 visits: up to kv_len and its causal
  // diagonal, as the mma.sync body's 64-row blocks do
  const auto tiles_of = [&](int r0) {
    const int n = (kvl + BK - 1) / BK;
    return causal ? min(n, r0 / BK + 1) : n;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // producer: Q once, then K and V tiles through the ring (the second warpgroup's
    // walk, which is the longer)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumers / 32 && lane == 0) {
      const int n_load = tiles_of(q0 + 64), kvh = b * Hkv + hk;
      mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < 4; ++c) tma_load_3d(sQ + c * COL_Q, &tm_q, q_full, 64 * c, q0, bh);
      for (int t = 0; t < n_load; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], KV_BYTES);
        for (int c = 0; c < 4; ++c)
          tma_load_3d(sK + s * KV_BYTES + c * COL_KV, &tm_k, &k_full[s], 64 * c, t * BK, kvh);
        mbar_arrive_expect_tx(&v_full[s], KV_BYTES);
        for (int c = 0; c < 4; ++c)
          tma_load_3d(sV + s * KV_BYTES + c * COL_KV, &tm_v, &v_full[s], 64 * c, t * BK, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = warp >> 2, wq = warp & 3, g = lane >> 2, tg = lane & 3;
    const int r0 = q0 + 64 * cw;                     // the warpgroup's first query row
    const int qi0 = r0 + 16 * wq + g;                // this thread's rows qi0, qi0 + 8
    const int n_tiles = tiles_of(r0);
    const int win = window > 0 ? window : INT_MAX;
    const float cap2 = softcap > 0.f ? 2.f * scale / softcap : 0.f;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);                            // also when no tile is visited
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, k0 = t * BK;
      const unsigned ph = (t / kStages) & 1;
      mbar_wait(&k_full[s], ph);
      // S = Q K^T: 16 k16 steps over D; step kd reads 32 bytes into column block kd / 4
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = 0.f;                                 // the first step overwrites it
        fence_reg(sc[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t da = desc_k_sw128(sQ + (kd >> 2) * COL_Q + 64 * cw * 128 + (kd & 3) * 32);
        const uint64_t db = desc_k_sw128(sK + s * KV_BYTES + (kd >> 2) * COL_KV + (kd & 3) * 32);
        wgmma_bf16_m64n64k16(sc, da, db, kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(sc[i]);
      // scale, softcap, then the masks where the tile needs them; sc[4j + 2h + e] is
      // row qi0 + 8h, key k0 + 8j + 2tg + e
      if (softcap > 0.f) {
        // softcap * tanh(s * scale / softcap) as softcap * (1 - 2 / (exp(2u) + 1)): an
        // exp and a reciprocal where tanhf takes ~20 instructions, within ~1e-7 of
        // tanh (absolute; 1 at u = +inf, -1 at -inf)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = softcap * (1.f - __fdividef(2.f, __expf(sc[i] * cap2) + 1.f));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale;
      }
      if ((causal && k0 + BK - 1 > r0) || k0 + BK > kvl || (window > 0 && r0 + 63 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = qi0 + 8 * ((i >> 1) & 1), kj = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
          const bool ok = (kj < kvl) & (!causal | (qi >= kj)) & (qi - kj < win);
          sc[i] = ok ? sc[i] : kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        corr[h] = __expf(m_r[h] - m_new);
        m_r[h] = m_new;
        l_r[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= corr[(i >> 1) & 1];
      // P = exp(s - m) rounded to bf16, repacked as PV's A operand: key chunk kc (16
      // keys) = score groups 2kc (a0, a1) and 2kc + 1 (a2, a3)
      unsigned pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * kc + hh;
          float r0f, r1f;
          pa[kc][2 * hh] = pack_bf16(__expf(sc[4 * j] - m_r[0]), __expf(sc[4 * j + 1] - m_r[0]),
                                     r0f, r1f);
          l_r[0] += r0f + r1f;
          pa[kc][2 * hh + 1] = pack_bf16(__expf(sc[4 * j + 2] - m_r[1]),
                                         __expf(sc[4 * j + 3] - m_r[1]), r0f, r1f);
          l_r[1] += r0f + r1f;
        }
      }
      // O += P V: V's tile as the MN-major B operand, 16 keys (2048 bytes) a step
      mbar_wait(&v_full[s], ph);
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_reg(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_bf16_m64n256k16_rs_tb(acc, pa[kc],
                                    desc_mn_sw128(sV + s * KV_BYTES + kc * 2048, COL_KV));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_reg(acc[i]);
      if (lane == 0) mbar_arrive(&empty[s]);         // this warp is done with stage s
    }

    __nv_bfloat16* op = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float denom = fmaxf(l, 1e-30f);
      const int qi = qi0 + 8 * h;
      if (qi >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * h], denom),
                                                         __fdiv_rn(acc[4 * j + 2 * h + 1], denom));
        *reinterpret_cast<__nv_bfloat162*>(op + (size_t)qi * D + 8 * j + 2 * tg) = val;
      }
    }
  }
}

// a (n, S, D = 256) bf16 tensor (row-major, contiguous) as a 3-D tensor map with
// boxes of 64 columns (128 bytes, 128-byte swizzle) x rows x 1; rows past S zero-fill
bool encode_bf16_rows(CUtensorMap* map, const void* base, int S, int n, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)wg::D, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)wg::D * 2, (cuuint64_t)S * wg::D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, const int* kv_len, int B,
                 int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                 float scale, cudaStream_t s) {
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bf16_rows(&tm_q, q, Sq, B * H, wg::BQW) ||
      !encode_bf16_rows(&tm_k, k, Sk, B * Hkv, wg::BK) ||
      !encode_bf16_rows(&tm_v, v, Sk, B * Hkv, wg::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fa_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(wg::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + wg::BQW - 1) / wg::BQW, B * H);
  fa_wgmma_kernel<<<grid, wg::kWgThreads, wg::SMEM, s>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), kv_len, H, Hkv, Sq, Sk, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- dispatch

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* kv_len, int dtype,
           int B, int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
           float scale, cudaStream_t s) {
  if (dtype == kF32)
    return launch_f32<float, D>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap,
                                scale, s);
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D == wg::D) {
    return launch_wgmma(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap, scale,
                        s);
  } else {
    return launch_bf16<D>(q, k, v, o, kv_len, B, H, Hkv, Sq, Sk, causal, window, softcap,
                          scale, s);
  }
}

}  // namespace

// window <= 0: no sliding window; softcap <= 0: no logit softcap; kv_len may be null;
// scale is D^-0.5 rounded to f32 by the caller, as the reference computes it. bf16
// runs a tensor-core body (q, k, v, o 16-byte aligned; wgmma at D = 256, mma.sync
// below), f32 the CUDA-core body.
REPRO_API int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    const int* kv_len, int dtype, int B, int H, int Hkv,
                                    int Sq, int Sk, int D, int causal, int window,
                                    float softcap, float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FA_ARGS q, k, v, o, kv_len, dtype, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s
  switch (D) {
    case 16: return launch<16>(REPRO_FA_ARGS);
    case 32: return launch<32>(REPRO_FA_ARGS);
    case 64: return launch<64>(REPRO_FA_ARGS);
    case 80: return launch<80>(REPRO_FA_ARGS);
    case 128: return launch<128>(REPRO_FA_ARGS);
    case 256: return launch<256>(REPRO_FA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_ARGS
}

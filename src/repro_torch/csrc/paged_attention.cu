// K4/K5/K6 paged_attention, f32 body: single-token decode (q_win = 1), draft-window
// verify (q_win > 1) and ragged chunked-prefill attention through a page table,
// with an online softmax, for f32 queries (the card-vs-CPU parity runs). bf16
// queries, the serving path, run the split tensor-core body in
// paged_attention_mma.cu. One kernel body serves all three modes here.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::_paged_decode_kernel
// (launcher paged_decode_attention_pallas, pallas_call at flash_attention.py:329),
// which serves both ops.paged_decode_attention (K4) and, with a draft window,
// ops.paged_verify_attention (K5); and ::_ragged_prefill_kernel (launcher
// ragged_prefill_attention_pallas, pallas_call at flash_attention.py:556), which
// serves ops.ragged_prefill_attention (K6).
//
// Decode/verify: q (B, Hkv, R, D) with R = q_win * G rows ordered (window, group);
// o like q. Ragged: q (Nt, Hkv * G, D), a packed block where slot b owns tokens
// [q_start[b], q_start[b] + q_len[b]); k_new/v_new (Nt, Hkv, D) are those tokens'
// fp K/V (q's type); o like q, written only at owned rows (the wrapper zeroes it).
// Pools (P, ps, Hkv, D) in f32, bf16 or int8, not necessarily q's dtype; with
// int8 pools the per-token scale pools (P, ps, Hkv, 1) f32 are read in that layout
// directly (row stride Hkv). page_table (B, maxP) int32, entries >= P are
// sentinels and clamp to page P - 1; kv_len (B,) int32. Logical position t of slot
// b lives at pool row (page_table[b, t / ps], t % ps).
//
// Every row r has a query position: the slot's chunk starts at cs = kv_len - q_len
// (q_len = 1 at decode) and row r, of token w = r / G, sits at
// q_pos = cs + min(w, q_len - 1). It attends keys t <= q_pos (and q_pos - t <
// window). In ragged mode, keys at t >= cs are the chunk's own tokens: they are
// read from k_new/v_new row q_start + (t - cs) instead of the pool, and their int8
// scales are 1 (no multiply). A block walks positions up to its last row's q_pos,
// so it never reads a dead page.
//
// Numerics, in the reference's order: s = (q . k) * D^-1/2; s *= k_scale; softcap;
// m_new = max(m, max(where(mask, s, -1e30))); p = where(mask, exp(s - m_new), 0);
// l = l * corr + sum(p); acc = acc * corr + (p * v_scale) . V; out = acc / max(l,
// 1e-30). The dot product's partial sum j takes elements d = j mod 4 in order,
// whatever the element type, so a key read from an f32 pool and the same value
// read from a bf16 overlay give the same bits: a ragged row with q_len = 1 over an
// fp pool is bitwise the decode launch's row. A decode slot with kv_len = 0 writes
// zeros; an all-sentinel table row reads page P - 1 and writes finite values.
//
// What bounds it on an H100: each live K/V row is read once per kv head and meets
// the block's query rows. At the serving shape (Hkv = 4, G = 9, D = 128) the decode
// does 9 f32 flops per byte of a bf16 pool, below the 20 per byte where the f32 CUDA
// cores (67 TFLOP/s) overtake the memory (3.35 TB/s): bytes bound. The q_win = 4
// verify does 36 per byte and a 16-token prefill chunk 144 per byte: operation
// bound. The design keeps the reference's memory behaviour: the dense (B, T, Hkv,
// D) view is never formed, the scale pools are not transposed, and sentinel pages
// past kv_len are never read.
//
// Design: one block of 256 threads per (kv head, slot) at decode/verify; per (kv
// head, slot, tile of 32 of the slot's q_len * G rows) in ragged mode, so a dead
// slot (q_len = 0) or a tile past q_len exits at once. The TPU kernel walks every
// slot in one sequential grid and blends each slot's rows into one shared output
// block; here blocks run in any order and each writes only its own rows. The
// block walks its slot's logical positions 32 at a time. A chunk's K and V rows
// are gathered through the page table straight into shared memory with cp.async,
// in the pool's own type (16-byte copies; the int8 scales 4 bytes each),
// double-buffered: chunk c + 1 is in flight while chunk c computes, the
// counterpart of the TPU kernel's two DMA slots. The chunk's own tokens (ragged
// mode) are read from k_new/v_new in place, through the caches: staging them too
// would not fit shared memory at D = 256 with f32 q (gemma2-9b's parity runs). Warp w owns query rows w, w + 8,
// ...; for each, lane t scores key t against the row (a D-long dot product,
// 16-byte reads of the K row, whose padded stride keeps a quarter-warp's reads on
// distinct banks, four partial sums to break the latency chain), the warp reduces
// the chunk's max and sum with shuffles, and each lane then updates D / 32
// columns of that row's f32 accumulator (one register each over the chunk's
// keys), which lives in shared memory with the row's running max and denominator.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, KC = 32;
constexpr int kMaxCols = 8;     // accumulator columns per lane: D <= 256
constexpr int kRowTile = 32;    // ragged mode: query rows per block
constexpr float kNegInf = -1e30f;

// Shared memory, in bytes: sQ and sAcc (f32 [rows][D]); two buffers of K rows
// (stride D * sizeof(TKV) + 16) and V rows (stride D * sizeof(TKV)); two buffers
// of K and V scales [KC]; sP [warps][KC]; sM, sL and the rows' query positions
// [rows]. At most 200 KB (ragged, f32 q and pool, D = 256).
template <typename TKV>
size_t smem_bytes(int rows, int D) {
  const size_t row = (size_t)D * sizeof(TKV);
  return sizeof(float) * (2 * (size_t)rows * D + 4 * KC + kWarps * KC + 3 * rows) +
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

// q_row . k_row over D elements: partial sum j takes elements d with d % 4 == j,
// in increasing d, for every element type (the read width only changes how many
// elements one 16-byte load brings).
template <typename T>
__device__ __forceinline__ float dot_row(const float* __restrict__ qr, const T* kr, int D) {
  constexpr int VEC = 16 / sizeof(T);
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int d = 0; d < D; d += VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < VEC; u += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qr + d + u);
      s4[0] = fmaf(q4.x, kv_f32(e[u]), s4[0]);
      s4[1] = fmaf(q4.y, kv_f32(e[u + 1]), s4[1]);
      s4[2] = fmaf(q4.z, kv_f32(e[u + 2]), s4[2]);
      s4[3] = fmaf(q4.w, kv_f32(e[u + 3]), s4[3]);
    }
  }
  return (s4[0] + s4[1]) + (s4[2] + s4[3]);
}

// pv[j] += p_t * V[t, lane + 32 j] over the chunk's rows t in [t_lo, t_hi)
template <typename T>
__device__ __forceinline__ void pv_rows(float (&pv)[kMaxCols], const float* sPw,
                                        const unsigned char* vbuf, int row_bytes, int t_lo,
                                        int t_hi, int lane, int D) {
#pragma unroll 4
  for (int t = t_lo; t < t_hi; ++t) {
    const float pt = sPw[t];
    const T* vr = reinterpret_cast<const T*>(vbuf + (size_t)t * row_bytes);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (lane + 32 * j < D) pv[j] = fmaf(pt, kv_f32(vr[lane + 32 * j]), pv[j]);
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* kv_len;
  const int* q_len;     // verify and ragged
  const int* q_start;   // ragged
  const void* k_new;    // ragged
  const void* v_new;    // ragged
  void* o;
  int P, ps, Hkv, D, G, q_win, maxP, Nt;
  float scale;
  int window;
  float softcap;
};

template <typename TQ, typename TKV, bool RAGGED>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args args) {
  const int P = args.P, ps = args.ps, Hkv = args.Hkv, D = args.D, G = args.G;
  const int maxP = args.maxP, window = args.window;
  const float scale = args.scale, softcap = args.softcap;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvl = max(args.kv_len[b], 0);
  int qln, row0, rows, q0 = 0;
  if (RAGGED) {
    qln = args.q_len[b];
    row0 = blockIdx.z * kRowTile;
    rows = min(kRowTile, qln * G - row0);
    if (rows <= 0) return;               // a dead slot, or a tile past q_len
    q0 = args.q_start[b];
  } else {
    qln = args.q_win > 1 ? args.q_len[b] : 1;
    row0 = 0;
    rows = args.q_win * G;
  }
  const int cs = kvl - qln;              // the chunk's (window's) first position
  const int last_pos = cs + min((row0 + rows - 1) / G, qln - 1);
  // logical positions that exist: decode/verify walk kv_len, a ragged tile up to
  // its last row's query position
  const int walk = RAGGED ? min(last_pos + 1, maxP * ps) : min(kvl, maxP * ps);
  const int n_chunks = walk > 0 ? (walk + KC - 1) / KC : 0;
  const bool int8_kv = args.k_scale != nullptr;
  const int* tab = args.page_table + (size_t)b * maxP;

  const int row_bytes = D * sizeof(TKV);
  const int k_stride = row_bytes + 16;            // padded: conflict-free 16-byte reads
  const int nrow_stride = Hkv * D;                 // k_new/v_new elements per token
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sAcc = sQ + rows * D;
  unsigned char* sK = reinterpret_cast<unsigned char*>(sAcc + rows * D);  // [2][KC][k_stride]
  unsigned char* sV = sK + 2 * KC * k_stride;                            // [2][KC][row_bytes]
  float* sKs = reinterpret_cast<float*>(sV + 2 * KC * row_bytes);        // [2][KC]
  float* sVs = sKs + 2 * KC;                                             // [2][KC]
  float* sP = sVs + 2 * KC;                                              // [warps][KC]
  float* sM = sP + kWarps * KC;
  float* sL = sM + rows;
  int* sQpos = reinterpret_cast<int*>(sL + rows);

  // pool positions of chunk c come first: [t0, t0 + n_pool); the rest (ragged
  // mode, positions >= cs) are the chunk's own tokens
  auto n_pool_of = [&](int t0, int n) { return RAGGED ? max(0, min(n, cs - t0)) : n; };

  // gather chunk c's K/V rows (and scales) into buffer c & 1, asynchronously
  auto stage = [&](int c) {
    const int t0 = c * KC, n = min(KC, walk - t0), buf = c & 1;
    const int n_pool = n_pool_of(t0, n);
    const int pieces = row_bytes / 16;
    for (int i = tid; i < n_pool * pieces; i += kThreads) {
      const int t = i / pieces, j = i - t * pieces, pos = t0 + t;
      const int page = min(tab[pos / ps], P - 1);
      const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
      const unsigned char* kg =
          reinterpret_cast<const unsigned char*>(args.k_pages) + row * row_bytes;
      const unsigned char* vg =
          reinterpret_cast<const unsigned char*>(args.v_pages) + row * row_bytes;
      cp_async16(sK + ((size_t)buf * KC + t) * k_stride + j * 16, kg + j * 16);
      cp_async16(sV + ((size_t)buf * KC + t) * row_bytes + j * 16, vg + j * 16);
    }
    if (int8_kv) {
      for (int t = tid; t < n_pool; t += kThreads) {
        const int pos = t0 + t;
        const int page = min(tab[pos / ps], P - 1);
        const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
        cp_async4(sKs + buf * KC + t, args.k_scale + row);
        cp_async4(sVs + buf * KC + t, args.v_scale + row);
      }
    }
  };
  // the chunk's own token at chunk offset t >= n_pool: its packed k_new/v_new row
  auto new_row = [&](int t0, int t) -> size_t {
    return ((size_t)min(max(q0 + (t0 + t - cs), 0), args.Nt - 1) * Hkv + h) * D;
  };

  // q row r (local) of this block, and where its output goes
  auto row_offset = [&](int r) -> size_t {
    if (!RAGGED) return (((size_t)b * Hkv + h) * rows + r) * D;
    const int gr = row0 + r;
    return (((size_t)(q0 + gr / G) * Hkv + h) * G + gr % G) * D;
  };

  if (n_chunks > 0) stage(0);
  cp_async_commit();
  const TQ* q = static_cast<const TQ*>(args.q);
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const bool in_block = !RAGGED || q0 + (row0 + r) / G < args.Nt;
    sQ[i] = in_block ? to_f32(q[row_offset(r) + i % D]) : 0.f;
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
    sQpos[r] = cs + min((row0 + r) / G, qln - 1);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * KC, n = min(KC, walk - t0), buf = c & 1;
    const int n_pool = n_pool_of(t0, n);
    if (c + 1 < n_chunks) stage(c + 1);   // its buffer's last reader finished below
    cp_async_commit();
    cp_async_wait_all_but_one();          // chunk c has landed (this thread's copies)
    __syncthreads();                      // ... and every thread's

    const unsigned char* kr = sK + ((size_t)buf * KC + lane) * k_stride;
    const unsigned char* vbuf = sV + (size_t)buf * KC * row_bytes;
    const TQ* knr = RAGGED && lane >= n_pool && lane < n
                        ? static_cast<const TQ*>(args.k_new) + new_row(t0, lane) : nullptr;
    const TQ* vnr = RAGGED && n_pool < n
                        ? static_cast<const TQ*>(args.v_new) + new_row(t0, n_pool) : nullptr;
    const bool pool_key = !RAGGED || lane < n_pool;   // decode/verify: every key
    const int k_pos = t0 + lane;
    for (int r = warp; r < rows; r += kWarps) {
      const float* qr = sQ + r * D;
      float s = 0.f;
      if (lane < n) {
        s = (pool_key ? dot_row(qr, reinterpret_cast<const TKV*>(kr), D)
                      : dot_row(qr, knr, D)) * scale;
        if (int8_kv && pool_key) s *= sKs[buf * KC + lane];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      const int q_pos = sQpos[r];
      bool ok = lane < n && k_pos <= q_pos;
      if (window > 0) ok = ok && (q_pos - k_pos) < window;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(ok ? s : kNegInf));
      const float p = ok ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_prev - m_new);
      sP[warp * KC + lane] = int8_kv && pool_key ? p * sVs[buf * KC + lane] : p;
      __syncwarp();
      // lane owns columns lane + 32 j: one independent accumulator each
      float pv[kMaxCols];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) pv[j] = 0.f;
      pv_rows<TKV>(pv, sP + warp * KC, vbuf, row_bytes, 0, n_pool, lane, D);
      if (RAGGED && vnr != nullptr)     // the chunk's own tokens, consecutive packed rows
        pv_rows<TQ>(pv, sP + warp * KC + n_pool, reinterpret_cast<const unsigned char*>(vnr),
                    nrow_stride * (int)sizeof(TQ), 0, n - n_pool, lane, D);
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int d = lane + 32 * j;
        if (d < D) sAcc[r * D + d] = fmaf(sAcc[r * D + d], corr, pv[j]);
      }
      __syncwarp();    // every lane has read sM[r] and sP before they change
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = fmaf(sL[r], corr, psum);
      }
      __syncwarp();
    }
    __syncthreads();   // chunk c's buffer is free for chunk c + 2
  }
  __syncthreads();     // a slot with no live position still zeroes its output

  TQ* o = static_cast<TQ*>(args.o);
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    if (RAGGED && q0 + (row0 + r) / G >= args.Nt) continue;
    o[row_offset(r) + i % D] = from_f32<TQ>(__fdiv_rn(sAcc[i], fmaxf(sL[r], 1e-30f)));
  }
}

template <typename TQ, typename TKV, bool RAGGED>
int launch(const Args& args, int B, int rows, dim3 grid, cudaStream_t s) {
  const size_t smem = smem_bytes<TKV>(rows, args.D);
  cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<TQ, TKV, RAGGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_kernel<TQ, TKV, RAGGED><<<grid, kThreads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <bool RAGGED>
int dispatch(int q_dtype, int kv_dtype, const Args& args, int B, int rows, dim3 grid,
             cudaStream_t s) {
  if (kv_dtype == kI8 && (args.k_scale == nullptr || args.v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAGED_CASE(QC, TQ, KC_, TKV) \
  if (q_dtype == QC && kv_dtype == KC_) return launch<TQ, TKV, RAGGED>(args, B, rows, grid, s);
  REPRO_PAGED_CASE(kF32, float, kF32, float)
  REPRO_PAGED_CASE(kF32, float, kBF16, __nv_bfloat16)
  REPRO_PAGED_CASE(kF32, float, kI8, int8_t)
#undef REPRO_PAGED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int P, int ps, int maxP, int D) {
  return P < 1 || ps < 1 || maxP < 1 || D < 16 || D % 16 != 0 || D > 32 * kMaxCols;
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
  if (q_win < 1 || R % q_win != 0 || (q_win > 1 && q_len == nullptr) ||
      bad_shape(P, ps, maxP, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{q, k_pages, v_pages, k_scale, v_scale, page_table, kv_len, q_len,
                  nullptr, nullptr, nullptr, o, P, ps, Hkv, D, R / q_win, q_win, maxP, 0,
                  scale, window, softcap};
  return dispatch<false>(q_dtype, kv_dtype, args, B, R, dim3(Hkv, B),
                         static_cast<cudaStream_t>(stream));
}

// Ragged chunked prefill: q (Nt, Hkv * G, D) and k_new/v_new (Nt, Hkv, D) in
// q_dtype; q_start/q_len/kv_len (B,) int32; chunk_cap bounds every q_len (the
// grid's row tiles cover chunk_cap * G rows per slot); o (Nt, Hkv * G, D) zeroed
// by the caller, written at owned rows only.
REPRO_API int repro_ragged_prefill(const void* q, int q_dtype, const void* k_new,
                                   const void* v_new, const void* k_pages,
                                   const void* v_pages, int kv_dtype, const float* k_scale,
                                   const float* v_scale, const int* page_table,
                                   const int* q_start, const int* q_len, const int* kv_len,
                                   void* o, int Nt, int B, int Hkv, int G, int D, int P,
                                   int ps, int maxP, int chunk_cap, int window,
                                   float softcap, float scale, void* stream) {
  if (B == 0 || Hkv == 0 || G == 0 || Nt == 0 || chunk_cap == 0)
    return static_cast<int>(cudaGetLastError());
  if (chunk_cap < 0 || bad_shape(P, ps, maxP, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{q, k_pages, v_pages, k_scale, v_scale, page_table, kv_len, q_len,
                  q_start, k_new, v_new, o, P, ps, Hkv, D, G, 1, maxP, Nt,
                  scale, window, softcap};
  const int tiles = (chunk_cap * G + kRowTile - 1) / kRowTile;
  return dispatch<true>(q_dtype, kv_dtype, args, B, kRowTile, dim3(Hkv, B, tiles),
                        static_cast<cudaStream_t>(stream));
}

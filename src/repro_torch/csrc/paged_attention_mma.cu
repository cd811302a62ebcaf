// K4/K5/K6 paged attention, bf16 body: single-token decode (q_win = 1), draft-
// window verify (q_win > 1) and ragged chunked prefill through a page table, for
// bf16 queries, as split ("flash-decoding") tensor-core attention. f32 queries run
// the CUDA-core body in paged_attention.cu.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::_paged_decode_kernel
// (pallas_call at flash_attention.py:329; K4 and, with a draft window, K5) and
// ::_ragged_prefill_kernel (pallas_call at flash_attention.py:556; K6).
//
// What it computes is what paged_attention.cu's header states: pages through the
// table (sentinels clamp to page P - 1), per-token int8 scales read in the
// (P, ps, Hkv, 1) layout, the ragged fp overlay of the chunk's own tokens (scale 1),
// window and softcap, kv_len 0 -> zeros; q, k_new/v_new and o are bf16 here.
//
// What bounds it on an H100: at the serving shapes (Hkv = 4, G = 9, D = 128, a
// few hundred live keys per slot) the decode reads each live K/V row once for 9
// query rows: bytes-bound at ~2 us, where one block per (kv head, slot) walking
// its keys one after another took ~120 us. A packed chunk of 125 tokens meets
// each key with up to 1125 query rows: operation-bound, and CUDA-core f32 dot
// products reach 4 % of that bound.
//
// Design:
// - Split the key walk (flash-decoding). Logical positions [0, maxP * ps) are cut
//   into n_parts partitions of part_len positions (kernels/paged_attention.py::
//   split_plan, from maxP and ps only, so no kv_len is read back on the host). A
//   block owns (kv head, slot, tile of 16 * RW query rows, partition); blocks
//   whose partition starts past the tile's walk exit at once. With one
//   partition the block writes the output; else it writes its rows' unnormalised
//   (m, l, acc) to scratch and paged_combine_kernel merges the partitions in
//   ascending order: deterministic, no atomics, and it replays under CUDA graphs.
// - Tensor cores: S = Q K^T and O = P V on mma.sync.m16n8k16 bf16 with f32
//   accumulators; warp w of a block owns 16 query rows (decode: the G = 9 rows of
//   a kv head padded to 16; verify: q_win * G rows over ceil(rows / 16) warps;
//   ragged: 64-row tiles of a slot's q_len * G rows); all four warps of a block
//   stage the K/V chunks, also where fewer compute. Q fragments load once into
//   registers. K/V chunks of 32 keys are gathered through the page table into a
//   shared-memory staging buffer in the pool's own type with cp.async; the block
//   converts each landed chunk to bf16 once (int8 codes exactly, the overlay rows
//   as they are) into padded rows, double-buffered, that the warps read with
//   ldmatrix (.trans for V), so chunk c + 1 lands while chunk c computes.
//   k_scale multiplies the score column after the product and v_scale folds into
//   p, the numerics of layers.decode_attention. p * v_scale is split into three
//   bf16 terms (hi + mid + lo, three MMAs), so it keeps about f32's 24 bits, and
//   the tensor cores' own f32 sums are kept short (one k16 step of Q K^T, one
//   chunk of P V) and added up in f32 with one rounding each: with int8 codes,
//   exact in bf16, the output differs from the f32 plain version by about f32
//   rounding, as the f32 body's does. Where that output lies within f32 rounding
//   of a bf16 rounding midpoint, either body may round to the neighbouring bf16
//   value (one ulp: 0.0156 in [2, 4), 0.031 in [4, 8)).
// - Per-row arithmetic depends on neither the block's row tile nor the mode: a
//   row's keys run in the same 32-key chunks from the same partition starts, so
//   a ragged row with q_len = 1 over an fp pool is bitwise the decode launch's.
//
// D = 256 (gemma2-9b), a design of its own; D <= 128 compiles to the code above
// (bitwise and timed against the parent commit by kernel_ab.py). With one warp
// across the whole head, a warp held 64 Q-fragment and 128 accumulator registers
// before the scores, the three-term P and the addresses: ptxas used 255 registers
// and spilled 20-44 bytes, and the ragged block's two converted buffers beside the
// staging took 117,504 bytes of shared memory with an int8 pool, one 4-warp block
// an SM. So:
// - Head-dim split: warps 2 r and 2 r + 1 own row group r's 16 query rows, each
//   its half of D (128 dims: 32 Q-fragment and 64 accumulator registers, as a warp
//   at D = 128); two row groups a block, so 32-row tiles and still 4 warps (in a
//   decode launch the second pair only stages). Each warp forms its partial S over
//   its half (its 8 k16 steps in order from zero).
// - The pair shares the chunk's softmax, meeting at a named barrier three times:
//   each warp finishes half the score tiles (16 keys). (1) It posts its partial of
//   its mate's tiles and adds its mate's partial of its own (one addition of the
//   two halves of D, a + b == b + a); (2) it scales, caps and masks its keys and
//   posts their row maxima, and both take the larger (the same m, correction and
//   exponent in both warps); (3) it forms its keys' p, their share of l and their
//   three-term p * v_scale, and posts them, so both hold the chunk's P. Each
//   multiplies P into its half of V; the two shares of l are added at the end.
//   S and l add in another order than one warp over the whole head did: held to
//   the same bf16 bar.
// - Shared memory: one converted buffer, not two (the block barrier at the top of
//   each chunk already follows every warp's reads of the last one), and 11,264
//   bytes of exchange slots: 94,720 bytes with an int8 pool (ragged), 61,952 for
//   decode and verify. Under a bound of two 128-thread blocks an SM ptxas uses
//   247-254 registers and spills nothing: 8 warps an SM.
// - int8 codes widen to bf16 without the I2F unit: each byte, offset by 128, is
//   placed in the mantissa of 2^23 and 2^23 + 128 subtracted (exact), two floats
//   packed per instruction (exact: |code| <= 128).
// - The window: a block whose partition ends at or before its tile's first query
//   position - window + 1 holds no key any of its rows sees, and exits at once, as
//   a block past the walk does; paged_combine_kernel starts each row at its first
//   partition not wholly behind its window (a superset of the tile's skips;
//   kernels/paged_attention.py::behind_window models both). A skipped partition
//   would have added exact zeros (m = -1e30, l = 0, acc = 0) to sums that start at
//   zero, so the output is bitwise what merging it gives.
// What bounds it: gemma2's chunked step (a 200-row chunk ending at 4616 beside a
// decode row, 16 heads over 8, int8 pool) needs ~0.014 ms of bf16 tensor-core work
// at the card's peak; each of its 13 row tiles of a head re-stages the keys of
// its window, and each 32-key chunk costs every block two block barriers and each
// pair three meetings, with 8 warps an SM to hide their latency (PERF.md §6).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int KC = 32;                  // keys per chunk
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* kv_len;
  const int* q_len;       // verify and ragged
  const int* q_start;     // ragged
  const __nv_bfloat16* k_new;   // ragged
  const __nv_bfloat16* v_new;   // ragged
  __nv_bfloat16* o;
  float* part_acc;        // [n_parts][rows_total][D], n_parts > 1
  float2* part_ml;        // [n_parts][rows_total] (m, l)
  int P, ps, Hkv, G, q_win, maxP, Nt, rows_total, n_parts, part_len, row_warps;
  float scale;
  int window;
  float softcap;
};

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// eight consecutive elements of a shared-memory row (16-byte aligned) as eight
// bf16 (int8 codes are exact)
template <typename T> __device__ __forceinline__ uint4 cvt8(const unsigned char* src);
template <> __device__ __forceinline__ uint4 cvt8<float>(const unsigned char* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  return make_uint4(pack2(__float2bfloat16_rn(a.x), __float2bfloat16_rn(a.y)),
                    pack2(__float2bfloat16_rn(a.z), __float2bfloat16_rn(a.w)),
                    pack2(__float2bfloat16_rn(b.x), __float2bfloat16_rn(b.y)),
                    pack2(__float2bfloat16_rn(b.z), __float2bfloat16_rn(b.w)));
}
template <> __device__ __forceinline__ uint4 cvt8<__nv_bfloat16>(const unsigned char* src) {
  return *reinterpret_cast<const uint4*>(src);
}
template <> __device__ __forceinline__ uint4 cvt8<int8_t>(const unsigned char* src) {
  const char4 a = reinterpret_cast<const char4*>(src)[0];
  const char4 b = reinterpret_cast<const char4*>(src)[1];
  auto bf = [](signed char v) { return __float2bfloat16_rn(static_cast<float>(v)); };
  return make_uint4(pack2(bf(a.x), bf(a.y)), pack2(bf(a.z), bf(a.w)), pack2(bf(b.x), bf(b.y)),
                    pack2(bf(b.z), bf(b.w)));
}

// D = 256's conversion: as cvt8, int8 codes without the I2F unit. Byte i of w ^
// 0x80808080 (the code + 128) in the low mantissa byte of 2^23, minus 2^23 + 128:
// the code, exactly; two floats to bf16x2 in one instruction (exact: |code| <= 128)
__device__ __forceinline__ unsigned i8x2_bf16(unsigned w, int i) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + i)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + i + 1)) - 8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
template <typename T> __device__ __forceinline__ uint4 cvt8_wide(const unsigned char* src) {
  return cvt8<T>(src);
}
template <> __device__ __forceinline__ uint4 cvt8_wide<int8_t>(const unsigned char* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const unsigned a = raw.x ^ 0x80808080u, b = raw.y ^ 0x80808080u;
  return make_uint4(i8x2_bf16(a, 0), i8x2_bf16(a, 2), i8x2_bf16(b, 0), i8x2_bf16(b, 2));
}

// a barrier of the two warps (64 threads) of one D = 256 row pair
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// shared-memory row strides (bytes) of the staged chunk: pool rows in their type,
// overlay rows bf16; the converted bf16 rows (elements) are padded by 16 bytes so
// the ldmatrix reads are conflict-free
template <typename TKV, int D>
__host__ __device__ constexpr int pool_stride() { return D * (int)sizeof(TKV); }
template <int D> __host__ __device__ constexpr int new_stride() { return 2 * D; }
template <int D> __host__ __device__ constexpr int bf_ld() { return D + 8; }

template <typename TKV, int D, bool RAGGED>
__host__ __device__ constexpr size_t buf_bytes() {
  return (size_t)KC * (2 * pool_stride<TKV, D>() + (RAGGED ? 2 * new_stride<D>() : 0)) +
         2 * KC * sizeof(float);
}

// D = 256 splits each warp's head dims with a second warp (header): warps 2 r and
// 2 r + 1 share row group r, at most kSplitRowGroups of them a block
template <int D> __host__ __device__ constexpr bool split_d() { return D > 128; }
constexpr int kSplitRowGroups = 2;
// D = 256: a warp's exchange slot, in floats: its partial S of its mate's score
// tiles (8 x 32 lanes), its row maxima (2 x 32), its three-term P (12 x 32)
constexpr int kXsFloats = (8 + 2 + 12) * 32;

// a chunk's converted bf16 K and V rows and its scales
template <int D> __host__ __device__ constexpr size_t conv_bytes() {
  return 2 * (size_t)KC * bf_ld<D>() * sizeof(__nv_bfloat16) + 2 * KC * sizeof(float);
}
// D = 256: the four warps' exchange slots
template <int D> __host__ __device__ constexpr size_t xs_bytes() {
  return split_d<D>() ? (size_t)(2 * kSplitRowGroups) * kXsFloats * sizeof(float) : 0;
}

// one staging buffer, then two converted buffers (D = 256: one, and the pairs'
// exchange slots)
template <typename TKV, int D, bool RAGGED>
__host__ __device__ constexpr size_t smem_total() {
  return buf_bytes<TKV, D, RAGGED>() + (split_d<D>() ? 1 : 2) * conv_bytes<D>() + xs_bytes<D>();
}

// D = 256: whether the partition ending (exclusive) at t_end lies wholly behind the
// window of a query at position q_pos (kernels/paged_attention.py::behind_window)
__device__ __forceinline__ bool behind_window(int t_end, int q_pos, int window) {
  return window > 0 && t_end <= q_pos - window + 1;
}

// The rows of a block: its slot's query rows [row0, row0 + rows), their chunk
// start cs and walk; identical in the attention and the combine kernels.
struct Tile {
  int row0, rows, qln, q0, cs, walk;
};

template <bool RAGGED>
__device__ __forceinline__ bool tile_of(const Args& A, int b, int tile, int tile_rows, Tile& t) {
  const int kvl = max(A.kv_len[b], 0);
  t.row0 = tile * tile_rows;
  t.q0 = 0;
  if (RAGGED) {
    t.qln = A.q_len[b];
    t.rows = min(tile_rows, t.qln * A.G - t.row0);
    t.q0 = A.q_start[b];
  } else {
    t.qln = A.q_win > 1 ? A.q_len[b] : 1;
    t.rows = min(tile_rows, A.q_win * A.G - t.row0);
  }
  if (t.rows <= 0) return false;        // a dead slot, or a tile past q_len
  t.cs = kvl - t.qln;
  const int last_pos = t.cs + min((t.row0 + t.rows - 1) / A.G, t.qln - 1);
  t.walk = RAGGED ? min(last_pos + 1, A.maxP * A.ps) : min(kvl, A.maxP * A.ps);
  return true;
}

// global row index (output row, and scratch row) of the tile's local row r
template <bool RAGGED>
__device__ __forceinline__ int row_index(const Args& A, int b, int h, const Tile& t, int r) {
  const int gr = t.row0 + r;
  if (!RAGGED) return (b * A.Hkv + h) * (A.q_win * A.G) + gr;
  return ((t.q0 + gr / A.G) * A.Hkv + h) * A.G + gr % A.G;
}

template <bool RAGGED>
__device__ __forceinline__ bool row_in_block(const Args& A, const Tile& t, int r) {
  return r < t.rows && (!RAGGED || t.q0 + (t.row0 + r) / A.G < A.Nt);
}

template <typename TKV, int D, bool RAGGED>
__device__ __forceinline__ void paged_mma_body(const Args& A) {
  // SPLIT (D = 256): warp w owns row group w / 2's 16 rows and head dims [half *
  // DH, half * DH + DH), half = w % 2 (warps of row groups past row_warps stage
  // only); else warp w owns rows 16 w.. across all D
  constexpr bool SPLIT = split_d<D>();
  constexpr int DH = SPLIT ? D / 2 : D;
  constexpr int KS = pool_stride<TKV, D>(), NS = new_stride<D>(), KD = DH / 16, DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = blockIdx.z / A.n_parts, part = blockIdx.z % A.n_parts;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int rw = SPLIT ? warp >> 1 : warp, half = SPLIT ? warp & 1 : 0;
  Tile t;
  if (!tile_of<RAGGED>(A, b, tile, 16 * A.row_warps, t)) return;
  const int t_beg = part * A.part_len;
  if (part > 0 && t_beg >= t.walk) return;        // nothing of this tile's walk here
  const int t_end = min(t.walk, t_beg + A.part_len);
  // D = 256: nothing of this tile's windows here either (header)
  if (SPLIT && A.n_parts > 1 &&
      behind_window(t_end, t.cs + min(t.row0 / A.G, t.qln - 1), A.window))
    return;
  const int n_chunks = t_end > t_beg ? (t_end - t_beg + KC - 1) / KC : 0;
  const bool int8_kv = A.k_scale != nullptr;
  const int* tab = A.page_table + (size_t)b * A.maxP;
  const int P = A.P, ps = A.ps, Hkv = A.Hkv, G = A.G;

  // staging (chunk c + 1 lands while c computes): sK, sV [KC][KS], (ragged) sKn,
  // sVn [KC][NS], sKs, sVs [KC]; then, per chunk parity, the converted bf16 rows
  // sKb, sVb [KC][LDB] and the scales sKsb, sVsb [KC] (1 on the overlay's keys)
  unsigned char* sK = smem;
  unsigned char* sV = sK + KC * KS;
  unsigned char* sKn = sV + KC * KS;
  unsigned char* sVn = sKn + (RAGGED ? KC * NS : 0);
  float* sKs = reinterpret_cast<float*>(sVn + (RAGGED ? KC * NS : 0));
  float* sVs = sKs + KC;
  constexpr int LDB = bf_ld<D>();
  constexpr size_t CONV = conv_bytes<D>();
  auto sKb = [&](int c) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf_bytes<TKV, D, RAGGED>() +
                                            (SPLIT ? 0 : (c & 1) * CONV));
  };
  // SPLIT: the pairs' exchange slots, kXsFloats a warp
  float* const sXs = reinterpret_cast<float*>(smem + buf_bytes<TKV, D, RAGGED>() + CONV);
  auto sVb = [&](int c) { return sKb(c) + KC * LDB; };
  auto sKsb = [&](int c) { return reinterpret_cast<float*>(sVb(c) + KC * LDB); };
  auto sVsb = [&](int c) { return sKsb(c) + KC; };
  // chunk c's keys: positions [t0, t0 + n); the first n_pool from the pool, the
  // rest (ragged, positions >= cs) the chunk's own tokens
  auto chunk_n = [&](int c) { return min(KC, t_end - (t_beg + c * KC)); };
  auto chunk_pool = [&](int c) {
    const int t0 = t_beg + c * KC, n = chunk_n(c);
    return RAGGED ? max(0, min(n, t.cs - t0)) : n;
  };

  auto stage = [&](int c) {
    const int t0 = t_beg + c * KC, n = chunk_n(c), n_pool = chunk_pool(c);
    constexpr int pieces = D * (int)sizeof(TKV) / 16;
    const unsigned char* kb = static_cast<const unsigned char*>(A.k_pages);
    const unsigned char* vb = static_cast<const unsigned char*>(A.v_pages);
    for (int i = tid; i < n_pool * pieces; i += nthr) {
      const int k = i / pieces, j = i - k * pieces, pos = t0 + k;
      const int page = min(tab[pos / ps], P - 1);
      const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
      async_copy16(sK + k * KS + j * 16, kb + row * (D * sizeof(TKV)) + j * 16, true);
      async_copy16(sV + k * KS + j * 16, vb + row * (D * sizeof(TKV)) + j * 16, true);
    }
    if (int8_kv) {
      for (int k = tid; k < n_pool; k += nthr) {
        const int pos = t0 + k;
        const int page = min(tab[pos / ps], P - 1);
        const size_t row = ((size_t)page * ps + pos % ps) * Hkv + h;
        cp_async4(sKs + k, A.k_scale + row);
        cp_async4(sVs + k, A.v_scale + row);
      }
    }
    if (RAGGED) {
      constexpr int npieces = D * 2 / 16;
      for (int i = tid; i < (n - n_pool) * npieces; i += nthr) {
        const int kk = i / npieces, j = i - kk * npieces, k = n_pool + kk;
        const int orow = min(max(t.q0 + (t0 + k - t.cs), 0), A.Nt - 1);
        const size_t row = (size_t)orow * Hkv + h;
        async_copy16(sKn + k * NS + j * 16,
                     reinterpret_cast<const unsigned char*>(A.k_new + row * D) + j * 16, true);
        async_copy16(sVn + k * NS + j * 16,
                     reinterpret_cast<const unsigned char*>(A.v_new + row * D) + j * 16, true);
      }
    }
  };

  if (n_chunks > 0) stage(0);
  async_commit();

  // this lane's rows: local g and g + 8 of the warp's 16
  const int lr[2] = {16 * rw + g, 16 * rw + g + 8};
  bool valid[2];
  int qpos[2];
  unsigned qf[KD][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    valid[i] = row_in_block<RAGGED>(A, t, lr[i]);
    qpos[i] = t.cs + min((t.row0 + lr[i]) / G, t.qln - 1);
  }
  const __nv_bfloat16* qr0 =
      A.q + (size_t)(valid[0] ? row_index<RAGGED>(A, b, h, t, lr[0]) : 0) * D;
  const __nv_bfloat16* qr1 =
      A.q + (size_t)(valid[1] ? row_index<RAGGED>(A, b, h, t, lr[1]) : 0) * D;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int d = half * DH + kd * 16 + 2 * tg;
    qf[kd][0] = valid[0] ? *reinterpret_cast<const unsigned*>(qr0 + d) : 0u;
    qf[kd][1] = valid[1] ? *reinterpret_cast<const unsigned*>(qr1 + d) : 0u;
    qf[kd][2] = valid[0] ? *reinterpret_cast<const unsigned*>(qr0 + d + 8) : 0u;
    qf[kd][3] = valid[1] ? *reinterpret_cast<const unsigned*>(qr1 + d + 8) : 0u;
  }
  const bool warp_live = 16 * rw < t.rows;

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = t_beg + c * KC, n = chunk_n(c), n_pool = chunk_pool(c);
    async_wait<0>();                      // chunk c has landed (this thread's copies)
    __syncthreads();                      // ... and every thread's; chunk c - 2's
                                          // converted rows are read
    // convert the chunk's K and V to bf16 once for all warps (keys past the chunk
    // are zero), and take its scales out of the staging buffer
    __nv_bfloat16* cK = sKb(c);
    __nv_bfloat16* cV = sVb(c);
    for (int i = tid; i < KC * (D / 8); i += nthr) {
      const int key = i / (D / 8), d = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < n) {
        if (!RAGGED || key < n_pool) {
          if constexpr (SPLIT) {
            kv = cvt8_wide<TKV>(sK + key * KS + d * sizeof(TKV));
            vv = cvt8_wide<TKV>(sV + key * KS + d * sizeof(TKV));
          } else {
            kv = cvt8<TKV>(sK + key * KS + d * sizeof(TKV));
            vv = cvt8<TKV>(sV + key * KS + d * sizeof(TKV));
          }
        } else {
          kv = cvt8<__nv_bfloat16>(sKn + key * NS + 2 * d);
          vv = cvt8<__nv_bfloat16>(sVn + key * NS + 2 * d);
        }
      }
      *reinterpret_cast<uint4*>(cK + key * LDB + d) = kv;
      *reinterpret_cast<uint4*>(cV + key * LDB + d) = vv;
    }
    const float* cKs = sKsb(c);
    const float* cVs = sVsb(c);
    if (int8_kv && tid < KC) {
      const bool pool = tid < n_pool;
      sKsb(c)[tid] = pool ? sKs[tid] : 1.f;
      sVsb(c)[tid] = pool ? sVs[tid] : 1.f;
    }
    __syncthreads();                      // converted; the staging buffer is free
    if (c + 1 < n_chunks) stage(c + 1);   // lands while this chunk computes
    async_commit();
    if (warp_live) {
      // S = Q K^T: s[nt][e] is row g + 8 (e / 2), key 8 nt + 2 tg + e % 2; K
      // fragments by ldmatrix (x4: two key tiles x two d halves)
      float s[KC / 8][4];
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int nt = 0; nt < KC / 8; nt += 2) {
          unsigned kb[4];
          ldmatrix_x4(kb, cK + (nt * 8 + k_row) * LDB + half * DH + kd * 16 + k_col);
          // one 16-product tensor-core sum per step, added in f32 with one rounding
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c0, qf[kd], kb[0], kb[1]);
          mma_bf16(c1, qf[kd], kb[2], kb[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] += c0[e];
            s[nt + 1][e] += c1[e];
          }
        }
      float corr[2];
      unsigned af[KC / 16][3][4];
      if constexpr (SPLIT) {
        // The pair shares the chunk's softmax: this warp finishes score tiles 2 half
        // and 2 half + 1 (key chunk kc = half, 16 keys), its mate the other two.
        // (1) S of my tiles: post my partial of my mate's tiles, meet, add my mate's
        // partial of mine (the two halves of D, one addition: a + b == b + a)
        const int mate = warp ^ 1, bar = 1 + rw;
        float* const xs_mine = sXs + warp * kXsFloats;
        const float* const xs_mate = sXs + mate * kXsFloats;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xs_mine[(j * 4 + e) * 32 + lane] = half ? s[j][e] : s[2 + j][e];
        pair_sync(bar);
        float sv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sv[j][e] = (half ? s[2 + j][e] : s[j][e]) + xs_mate[(j * 4 + e) * 32 + lane];
        // (2) scale, int8 k scale, softcap, mask on my 16 keys; their row max, then
        // the pair's (fmaxf: the same in both warps)
        float mx[2] = {kNegInf, kNegInf};
        bool ok[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = (2 * half + j) * 8 + 2 * tg + (e & 1), r = e >> 1, k_pos = t0 + key;
            float x = sv[j][e] * A.scale;
            if (int8_kv) x *= cKs[key];   // 1 on the overlay's keys: exact
            if (A.softcap > 0.f) x = A.softcap * tanhf(x / A.softcap);
            bool o = key < n && k_pos <= qpos[r];
            if (A.window > 0) o = o && (qpos[r] - k_pos) < A.window;
            ok[j][e] = o;
            sv[j][e] = o ? x : kNegInf;
            mx[r] = fmaxf(mx[r], sv[j][e]);
          }
        float* const mx_mine = xs_mine + 8 * 32;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mx_mine[r * 32 + lane] = mx[r];
        }
        pair_sync(bar);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], xs_mate[8 * 32 + r * 32 + lane]);
          const float m_new = fmaxf(m_r[r], mx[r]);
          corr[r] = expf(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= corr[r];              // this warp's keys' share of l
        }
        // (3) p = exp(s - m) on my keys, l += p, the three-term p * v_scale of my key
        // chunk; post it, meet, take my mate's chunk
        unsigned pm[3][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = (2 * half + hh) * 8 + 2 * tg + e;
              const float p = ok[hh][2 * r + e] ? expf(sv[hh][2 * r + e] - m_r[r]) : 0.f;
              l_r[r] += p;
              pv[e] = p;
              if (int8_kv && ok[hh][2 * r + e]) pv[e] = p * cVs[key];
            }
            __nv_bfloat16 pt[3][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {    // pv = hi + mid + lo to ~24 bits, each step exact
              pt[0][e] = __float2bfloat16_rn(pv[e]);
              const float r1 = pv[e] - __bfloat162float(pt[0][e]);
              pt[1][e] = __float2bfloat16_rn(r1);
              pt[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(pt[1][e]));
            }
#pragma unroll
            for (int i = 0; i < 3; ++i) pm[i][2 * hh + r] = pack2(pt[i][0], pt[i][1]);
          }
        unsigned* const af_mine = reinterpret_cast<unsigned*>(xs_mine + 10 * 32);
        const unsigned* const af_mate = reinterpret_cast<const unsigned*>(xs_mate + 10 * 32);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) af_mine[(i * 4 + k) * 32 + lane] = pm[i][k];
        pair_sync(bar);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned pt = af_mate[(i * 4 + k) * 32 + lane];
            af[0][i][k] = half ? pt : pm[i][k];
            af[1][i][k] = half ? pm[i][k] : pt;
          }
      } else {
        // scale, int8 k scale, softcap, mask; row max
        float mx[2] = {kNegInf, kNegInf};
        bool ok[KC / 8][4];
#pragma unroll
        for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = nt * 8 + 2 * tg + (e & 1), r = e >> 1, k_pos = t0 + key;
            float x = s[nt][e] * A.scale;
            if (int8_kv) x *= cKs[key];     // 1 on the overlay's keys: exact
            if (A.softcap > 0.f) x = A.softcap * tanhf(x / A.softcap);
            bool o = key < n && k_pos <= qpos[r];
            if (A.window > 0) o = o && (qpos[r] - k_pos) < A.window;
            ok[nt][e] = o;
            s[nt][e] = o ? x : kNegInf;
            mx[r] = fmaxf(mx[r], s[nt][e]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);
          corr[r] = expf(m_r[r] - m_new);
          m_r[r] = m_new;
          l_r[r] *= corr[r];
        }
        // p = exp(s - m) (0 where masked), l += p, then p * v_scale split into three
        // bf16 terms (hi, mid, lo) as PV's A operand: key chunk kc (16 keys) = score
        // tiles 2kc, 2kc + 1
#pragma unroll
        for (int kc = 0; kc < KC / 16; ++kc)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int nt = 2 * kc + hh;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float pv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = nt * 8 + 2 * tg + e;
                const float p = ok[nt][2 * r + e] ? expf(s[nt][2 * r + e] - m_r[r]) : 0.f;
                l_r[r] += p;
                pv[e] = p;
                if (int8_kv && ok[nt][2 * r + e]) pv[e] = p * cVs[key];
              }
              __nv_bfloat16 pt[3][2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {      // pv = hi + mid + lo to ~24 bits, each step exact
                pt[0][e] = __float2bfloat16_rn(pv[e]);
                const float r1 = pv[e] - __bfloat162float(pt[0][e]);
                pt[1][e] = __float2bfloat16_rn(r1);
                pt[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(pt[1][e]));
              }
#pragma unroll
              for (int i = 0; i < 3; ++i) af[kc][i][2 * hh + r] = pack2(pt[i][0], pt[i][1]);
            }
          }
      }
      // V fragments by ldmatrix.trans (x4: two 8-dim tiles x two key halves). The
      // chunk's PV of each 8-dim tile sums in a fresh accumulator (small terms
      // first), then folds into the running one with one f32 rounding: the
      // tensor cores' own f32 sums stay 6 products deep
      const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < KC / 16; ++kc) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, cV + (kc * 16 + v_row) * LDB + half * DH + dt * 8 + v_col);
#pragma unroll
          for (int i = 2; i >= 0; --i) {
            mma_bf16(c0, af[kc][i], vb[0], vb[1]);
            mma_bf16(c1, af[kc][i], vb[2], vb[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[dt][e] = fmaf(acc[dt][e], corr[e >> 1], c0[e]);
          acc[dt + 1][e] = fmaf(acc[dt + 1][e], corr[e >> 1], c1[e]);
        }
      }
    }
  }

  // the quad's partial sums of l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (SPLIT && warp_live) {
    // the pair's two shares of l (a + b == b + a: the same in both warps); my mate
    // read my slot's S before the last chunk's second meeting
    float* const xs_mine = sXs + warp * kXsFloats;
#pragma unroll
    for (int r = 0; r < 2; ++r) xs_mine[r * 32 + lane] = l_r[r];
    pair_sync(1 + rw);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] += sXs[(warp ^ 1) * kXsFloats + r * 32 + lane];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const size_t ri = row_index<RAGGED>(A, b, h, t, lr[r]);
    if (A.n_parts == 1) {
      const float denom = fmaxf(l_r[r], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(__fdiv_rn(acc[dt][2 * r], denom),
                                                         __fdiv_rn(acc[dt][2 * r + 1], denom));
        *reinterpret_cast<__nv_bfloat162*>(A.o + ri * D + half * DH + dt * 8 + 2 * tg) = val;
      }
    } else {
      const size_t pr = (size_t)part * A.rows_total + ri;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(A.part_acc + pr * D + half * DH + dt * 8 + 2 * tg) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      if (tg == 0 && half == 0) A.part_ml[pr] = make_float2(m_r[r], l_r[r]);
    }
  }
}

// The attention kernel: D <= 128 and D = 256 differ only in their launch bound.
// At D = 256 ptxas sizes the registers for two 4-warp blocks an SM; without that
// bound it chose 168 registers and spilled on one instantiation (bf16 pool, ragged)
template <typename TKV, int D, bool RAGGED, std::enable_if_t<(D <= 128), bool> = true>
__global__ void __launch_bounds__(128) paged_mma_kernel(const Args A) {
  paged_mma_body<TKV, D, RAGGED>(A);
}
template <typename TKV, int D, bool RAGGED, std::enable_if_t<(D > 128), bool> = true>
__global__ void __launch_bounds__(128, 2) paged_mma_kernel(const Args A) {
  paged_mma_body<TKV, D, RAGGED>(A);
}

// Merge the partitions of each row in ascending order: M = max m_p, l = sum l_p
// exp(m_p - M), acc = sum acc_p exp(m_p - M), o = acc / max(l, 1e-30). A row's
// live partitions are those its walk reaches (partition 0 always runs), at D = 256
// from the first one not wholly behind its window (the attention kernel skips a
// subset of the ones before it).
template <int D, bool RAGGED>
__global__ void __launch_bounds__(128) paged_combine_kernel(const Args A) {
  const int h = blockIdx.x, b = blockIdx.y, tile = blockIdx.z;
  Tile t;
  if (!tile_of<RAGGED>(A, b, tile, 16 * A.row_warps, t)) return;
  constexpr int V = D / 4;               // float4 groups per row
  for (int i = threadIdx.x; i < t.rows * V; i += blockDim.x) {
    const int r = i / V, d = (i % V) * 4;
    if (!row_in_block<RAGGED>(A, t, r)) continue;
    const int q_pos = t.cs + min((t.row0 + r) / A.G, t.qln - 1);
    const int walk = RAGGED ? min(q_pos + 1, A.maxP * A.ps) : t.walk;
    const int n_live = min(A.n_parts, max(1, (walk + A.part_len - 1) / A.part_len));
    // D = 256: partitions p with (p + 1) * part_len <= q_pos - window + 1 lie behind
    int p0 = 0;
    if (split_d<D>() && A.window > 0)
      p0 = min(n_live - 1, max(0, q_pos - A.window + 1) / A.part_len);
    const size_t ri = row_index<RAGGED>(A, b, h, t, r);
    float M = kNegInf;
    for (int p = p0; p < n_live; ++p) M = fmaxf(M, A.part_ml[(size_t)p * A.rows_total + ri].x);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = p0; p < n_live; ++p) {
      const size_t pr = (size_t)p * A.rows_total + ri;
      const float2 ml = A.part_ml[pr];
      const float w = expf(ml.x - M);
      l = fmaf(ml.y, w, l);
      const float4 a = *reinterpret_cast<const float4*>(A.part_acc + pr * D + d);
      acc.x = fmaf(a.x, w, acc.x);
      acc.y = fmaf(a.y, w, acc.y);
      acc.z = fmaf(a.z, w, acc.z);
      acc.w = fmaf(a.w, w, acc.w);
    }
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(A.o + ri * D + d);
    o[0] = __floats2bfloat162_rn(__fdiv_rn(acc.x, denom), __fdiv_rn(acc.y, denom));
    o[1] = __floats2bfloat162_rn(__fdiv_rn(acc.z, denom), __fdiv_rn(acc.w, denom));
  }
}

template <typename TKV, int D, bool RAGGED>
int launch(const Args& A, int B, int row_tiles, cudaStream_t s) {
  const size_t smem = smem_total<TKV, D, RAGGED>();
  void (*const kernel)(const Args) = paged_mma_kernel<TKV, D, RAGGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // four warps stage every chunk; those of the first row_warps row groups also
  // compute (D = 256: two warps a row group)
  kernel<<<dim3(A.Hkv, B, row_tiles * A.n_parts), 128, smem, s>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess || A.n_parts == 1) return static_cast<int>(err);
  paged_combine_kernel<D, RAGGED><<<dim3(A.Hkv, B, row_tiles), 128, 0, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool RAGGED>
int by_dim(const Args& A, int D, int B, int row_tiles, cudaStream_t s) {
  switch (D) {
    case 16: return launch<TKV, 16, RAGGED>(A, B, row_tiles, s);
    case 32: return launch<TKV, 32, RAGGED>(A, B, row_tiles, s);
    case 64: return launch<TKV, 64, RAGGED>(A, B, row_tiles, s);
    case 128: return launch<TKV, 128, RAGGED>(A, B, row_tiles, s);
    case 256: return launch<TKV, 256, RAGGED>(A, B, row_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool RAGGED>
int dispatch(int kv_dtype, const Args& A, int D, int B, int rows_per_slot, cudaStream_t s) {
  if (kv_dtype == kI8 && (A.k_scale == nullptr || A.v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (rows_per_slot + 16 * A.row_warps - 1) / (16 * A.row_warps);
  if (kv_dtype == kF32) return by_dim<float, RAGGED>(A, D, B, row_tiles, s);
  if (kv_dtype == kBF16) return by_dim<__nv_bfloat16, RAGGED>(A, D, B, row_tiles, s);
  if (kv_dtype == kI8) return by_dim<int8_t, RAGGED>(A, D, B, row_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// query rows per block: 16 per row group, up to 4 row groups (D = 256: up to
// kSplitRowGroups, two warps each)
int row_warps(int rows_per_slot, int D) {
  return min(D > 128 ? kSplitRowGroups : 4, max(1, (rows_per_slot + 15) / 16));
}

bool bad_split(int P, int ps, int maxP, int n_parts, int part_len, const float* part_acc,
               const float2* part_ml) {
  return P < 1 || ps < 1 || maxP < 1 || n_parts < 1 || part_len < KC || part_len % KC != 0 ||
         (long long)n_parts * part_len < (long long)maxP * ps ||
         (n_parts > 1 && (part_acc == nullptr || part_ml == nullptr));
}

}  // namespace

// bf16 q: q (B, Hkv, R, D), o like q; q_win = 1: decode (q_len may be null); q_win
// > 1: verify, q_len (B,) required. Pools, scales, page_table, kv_len, window,
// softcap and scale as repro_paged_attention. n_parts partitions of part_len
// positions (a multiple of 32) cover [0, maxP * ps); with n_parts > 1, part_acc
// (n_parts, B * Hkv * R, D) f32 and part_ml (n_parts, B * Hkv * R) float2 scratch.
REPRO_API int repro_paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                         int kv_dtype, const float* k_scale,
                                         const float* v_scale, const int* page_table,
                                         const int* kv_len, const int* q_len, void* o,
                                         float* part_acc, void* part_ml, int B, int Hkv, int R,
                                         int D, int P, int ps, int maxP, int q_win, int n_parts,
                                         int part_len, int window, float softcap, float scale,
                                         void* stream) {
  if (B == 0 || Hkv == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  float2* ml = static_cast<float2*>(part_ml);
  if (q_win < 1 || R % q_win != 0 || (q_win > 1 && q_len == nullptr) ||
      bad_split(P, ps, maxP, n_parts, part_len, part_acc, ml))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args A{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages, k_scale, v_scale,
               page_table, kv_len, q_len, nullptr, nullptr, nullptr,
               static_cast<__nv_bfloat16*>(o), part_acc, ml, P, ps, Hkv, R / q_win, q_win,
               maxP, 0, B * Hkv * R, n_parts, part_len, row_warps(R, D), scale, window,
               softcap};
  return dispatch<false>(kv_dtype, A, D, B, R, static_cast<cudaStream_t>(stream));
}

// bf16 ragged chunked prefill: q (Nt, Hkv * G, D), k_new/v_new (Nt, Hkv, D) bf16,
// o (Nt, Hkv * G, D) zeroed by the caller and written at owned rows; the rest as
// repro_ragged_prefill, the split as repro_paged_attention_bf16 with scratch rows
// Nt * Hkv * G.
REPRO_API int repro_ragged_prefill_bf16(const void* q, const void* k_new, const void* v_new,
                                        const void* k_pages, const void* v_pages, int kv_dtype,
                                        const float* k_scale, const float* v_scale,
                                        const int* page_table, const int* q_start,
                                        const int* q_len, const int* kv_len, void* o,
                                        float* part_acc, void* part_ml, int Nt, int B, int Hkv,
                                        int G, int D, int P, int ps, int maxP, int chunk_cap,
                                        int n_parts, int part_len, int window, float softcap,
                                        float scale, void* stream) {
  if (B == 0 || Hkv == 0 || G == 0 || Nt == 0 || chunk_cap == 0)
    return static_cast<int>(cudaGetLastError());
  float2* ml = static_cast<float2*>(part_ml);
  if (chunk_cap < 0 || bad_split(P, ps, maxP, n_parts, part_len, part_acc, ml))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args A{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages, k_scale, v_scale,
               page_table, kv_len, q_len, q_start,
               static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
               static_cast<__nv_bfloat16*>(o), part_acc, ml, P, ps, Hkv, G, 1, maxP, Nt,
               Nt * Hkv * G, n_parts, part_len, row_warps(chunk_cap * G, D), scale, window,
               softcap};
  return dispatch<true>(kv_dtype, A, D, B, chunk_cap * G, static_cast<cudaStream_t>(stream));
}

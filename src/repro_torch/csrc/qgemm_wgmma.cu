// K2 qgemm_w8a8, wgmma body: the int8 x int8 -> int32 GEMM with the separable
// CrossQuant dequant for more activation rows than the decode body takes (the
// wrapper routes M > DECODE_MAX_M here, kernels/qgemm.py::qgemm_w8a8_plan). K7's
// wgmma body is its SKIP instantiation (below the design notes); K8's wgmma body
// (W4A8, grouped scales) follows it, on the same TMA and wgmma helpers.
//
// Replaces the TPU kernel repro/kernels/qgemm.py::_w8a8_kernel (launcher
// qgemm_w8a8_pallas, pallas_call at :71) for packed chunked steps and prefills,
// and with SKIP _w8a8_sparse_kernel (launcher qgemm_w8a8_sparse_pallas,
// pallas_call at :149); few rows run qgemm_decode.cu, shapes this body does not
// take the 64 x 64 tile body in qgemm_w8a8.cu.
//
//   out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * a[m] * sw[n]
//
// qx (M, K) int8 row-major, qw (K, N) int8 row-major (the reference's layout) with
// a row pitch of ldw bytes, a (M,) f32, sw (N,) f32, out (M, N) f32; K and ldw
// multiples of 16, ldw >= N, N any width, qx and qw 16-byte aligned (TMA's rules:
// a 16-byte aligned base and a global stride that is a multiple of 16; the wrapper
// checks). A contiguous weight has ldw = N; one whose N is off the 16-column grid
// is served as a view into a (K, ldw) buffer (models/quantize.py::prepare_served).
// The weight's tensor map spans N columns at stride ldw, so TMA zero-fills the
// last column tile past N. Where N is a multiple of 16 the epilogue stores four
// columns with one 16-byte store everywhere (the RAGGED = false instantiation,
// the code this body had before the pitch); otherwise (RAGGED) it does so where
// all four lie inside N and the rows stay 16-byte aligned (N % 4 == 0), else
// column by column. The int32 sum is exact in any order
// and the epilogue multiplies in the reference's order, so the result is bitwise
// equal to the plain version.
//
// What bounds it on an H100: at M = 2048 the product is 2*M*N*K operations on
// about M*K + K*N bytes, some 1000 int8 operations per byte against the card's
// ~590: operation-bound, and only wgmma reaches the tensor cores' full int8 rate.
// At M = 33..128 it is byte-bound on the weight read, like the decode body.
//
// Design:
// - int8 wgmma takes both shared-memory operands K-major only, and qw (K, N) is
//   N-major. So the roles are swapped as in the decode body: out^T = qw^T * qx^T
//   with wgmma.m64nBMk32.s32.s8.s8, the weight tile the register-sourced A
//   operand (64 output columns per instruction, two instructions per k32 for a
//   128-column block tile) and qx the B operand through a shared-memory
//   descriptor, its token rows wgmma's N (BM = M rounded up to 16 for M <= 128,
//   else 128-row tiles). Each lane reads 4-byte words of four k-rows and
//   transposes them in registers (transpose4x4), so the weight tile lands in
//   shared memory as it lies.
// - Loads: one producer warp issues 2-D TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle) of the 128 x 128-byte weight tile and the BM x 128-byte qx tile into
//   a ring of 3 stages, completion counted on a "full" mbarrier per stage; the
//   four consumer warps (one warpgroup) release a stage on its "empty" mbarrier
//   once their wgmma have read it. TMA zero-fills past M, N and K, so the edges
//   need no padding copies; the epilogue masks the stores. Each launch encodes
//   two tensor maps on the host with cuTensorMapEncodeTiled (qx with a BM-row
//   box, qw with a 128 x 128 box).
// - The weight tile's 128-byte swizzle (16-byte chunk c of k-row r at c ^ (r % 8))
//   leaves the lanes' 4-byte reads 2-way bank conflicted; the qx descriptor uses
//   the same swizzle, as wgmma expects it.
// - 96 KB of ring per block, so two blocks share an SM: one block's fragment
//   reads and epilogue overlap the other's wgmma.
// - Few output tiles (M <= 128 at N = 4608) would leave most SMs idle through a
//   long K, so the plan splits K = 18432 across a thread-block cluster (grid z =
//   splits, cluster (1, 1, splits); K = 4608 gained nothing from a split on the
//   H100, kernels/qgemm.py::wgmma_splits): each block leaves its int32 partials
//   in its own shared memory, and after a cluster barrier the leader sums them
//   through distributed shared memory in rank order and runs the epilogue. No
//   workspace, no atomics, deterministic, and a launch replays unchanged under
//   CUDA-graph capture.
//
// Expert-batched K2 (a stacked-expert linear at prefill and packed chunked steps,
// C = 512 rows per expert at granite's 4 x 512 admission, 128 at a 512-token chunk
// budget): one launch for all E experts. The 2-D TMA loads stay 2-D: qx is viewed
// as (E*C, K) and expert e's m-tiles start at row e*C; qw as (E*K, N) and its
// k-tiles at row e*K. Clusters sit on grid z, so the expert is folded into grid y
// with the m-tiles (y = e * mtiles + mt). The epilogue stores no row >= C of its
// expert, and a, sw and out are offset to the expert's. Where K is not a multiple
// of 128 the last weight box reads the next expert's first rows (or, for the last
// expert, rows past E*K, zero-filled), against qx columns past K, which TMA
// zero-fills: they add exact zeros.
//
// K7 (SKIP): K2's sum over the 64-row k-tiles that a (ceil(K/64), ceil(N/64))
// int32 occupancy table marks occupied in either of the block's two 64-column
// table columns; qw is zero in every empty (64 x 64) tile, so the skip is exact
// and the result bitwise K2's and the plain version's. At block start every
// thread takes part in compacting the ascending list of those k-tiles in shared
// memory (common.cuh::occupied_k_tiles); split s takes list entries [s*L/S,
// (s+1)*L/S), so the cluster shares the occupied work, not K. The host never
// reads the table, so a launch replays unchanged under CUDA-graph capture.
// The skip must work at 64-row k-tiles, finer than the 128-row stage: a mask that
// empties every other 64-row tile leaves one occupied tile in every 128-row
// stage, and a skip by stages would skip nothing there. Of the two ways to get
// there, (a) 64-row stages behind a deeper ring or (b) a 128-row stage gathered
// from two occupied 64-row tiles at arbitrary k offsets, this is (b): the
// consumers keep K2's cadence (four k32 steps and one wgmma drain and stage
// release per stage), so an all-ones table runs K2's schedule, where (a) would
// double the drains and barrier round trips per k-row. A stage is two TMA
// weight boxes of 64 k-rows x 128 columns, which under the 128-byte swizzle land
// exactly as K2's one 128-row box does (the swizzle follows the 1024-byte-aligned
// address). qx comes as one box of BM rows x 128 bytes under the 128-byte swizzle
// (K2's layout) where the two tiles are adjacent in k, as on an all-ones table,
// else as two boxes of BM rows x 64 bytes under the 64-byte swizzle, one per tile;
// the consumers pick the matching descriptors per stage. A share of odd length
// ends on a stage of one tile: its second half is loaded from wholly past K, which
// TMA zero-fills, so every stage expects the same bytes and runs four k32 steps.
// For BM <= 112 the descriptor is computed from the pair flag (hopper.cuh::
// desc_k_sw), with no branch among the wgmma. For BM = 128 it is a select between
// the two descriptors, which makes ptxas serialize the wgmma (warning C7520) and
// fit them without the register spills of K2's instantiation; measured side by
// side on the H100, the select ran faster at BM = 128 and slower below it, and
// skipping a one-tile stage's empty half by a branch slower than both (PERF.md
// §6). With a cluster split, every rank (not only the leader) sums and stores 1/S
// of the tile's rows after the first barrier, four columns a thread, reading the
// S partials at once.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 128, BK = 128, kStages = 3, kConsumers = 128, kThreads = kConsumers + 32;
constexpr int kMaxSplits = 8;
constexpr int W_BYTES = BK * BN;          // one stage's weight tile

template <int BM>
__host__ __device__ constexpr int stage_bytes() {   // both tiles multiples of 1024 bytes
  return W_BYTES + BM * BK;
}

template <int BM>
__host__ __device__ constexpr int smem_bytes() {    // 1024 bytes of alignment slack + ring + barriers
  return 1024 + kStages * stage_bytes<BM>() + 2 * kStages * 8;
}

// K7's shared memory past the barriers: warp counts, then the list of occupied
// k-tiles; a 64-row k-tile's qx box
constexpr int kListHead = kThreads / 32;
template <int BM>
__host__ __device__ constexpr int x_half_bytes() { return BM * (BK / 2); }

// The epilogue's store of four consecutive columns at out[i .. i + 3], of which the
// first nv lie inside N: the int32 accumulators (int32-out mode, out_i32 set) or
// f32(acc) * am * sw in the reference's order; one 16-byte store where ``whole``
// (all four inside, rows 16-byte aligned), else one store per column
__device__ __forceinline__ void store4(float* out, int* out_i32, size_t i, const int (&ac)[4],
                                       float am, const float (&swc)[4], int nv, bool whole) {
  if (out_i32 != nullptr) {
    if (whole) {
      *reinterpret_cast<int4*>(out_i32 + i) = make_int4(ac[0], ac[1], ac[2], ac[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nv) out_i32[i + c] = ac[c];
    }
    return;
  }
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = __fmul_rn(__fmul_rn(__int2float_rn(ac[c]), am), swc[c]);
  if (whole) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nv) out[i + c] = v[c];
  }
}

// RAGGED: N off the 16-column grid (or sw's base not 16-byte aligned), so the
// epilogue masks the last column tile per column; otherwise it stores four columns
// at a time everywhere, as before the pitch existed
template <int BM, bool SKIP, bool RAGGED>
__global__ void __launch_bounds__(kThreads, 2)
qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_xp, const float* __restrict__ a,
                   const float* __restrict__ sw, const int* __restrict__ occ,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<BM>());
  uint64_t* empty = full + kStages;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  // grid y: the m-tiles of expert 0, then of expert 1, ... (one expert for a 2-D
  // product). m0 is the tile's first row within its expert; qx's tensor map holds
  // the E experts' rows one after the other, the weight's their K-row blocks
  const int mtiles = (M + BM - 1) / BM, ex = blockIdx.y / mtiles;
  const int n0 = blockIdx.x * BN, m0 = (blockIdx.y % mtiles) * BM;
  const int xm0 = ex * M + m0, wk0 = ex * K;
  // int32-out mode (a == nullptr; sw unread): store the summed int32 accumulator
  // undequantized, for a row-parallel linear's cross-shard SUM (expert-batched too)
  int* const out_i32 = a == nullptr ? reinterpret_cast<int*>(out + (size_t)ex * M * N)
                                    : nullptr;
  if (out_i32 == nullptr) {
    a += (size_t)ex * M;
    sw += (size_t)ex * N;
  }
  out += (size_t)ex * M * N;
  const int S = gridDim.z, split = blockIdx.z;      // cluster (1, 1, S): rank == split
  // K2: 128-row stages [kt0, kt0 + steps); K7: list entries [kt0, lend), two a stage
  int kt0, steps, lend = 0;
  int* list = reinterpret_cast<int*>(empty + kStages) + kListHead;
  if constexpr (SKIP) {
    const int L = occupied_k_tiles(occ, (K + BK / 2 - 1) / (BK / 2), (N + 63) / 64,
                                   2 * blockIdx.x, list, list - kListHead);
    kt0 = split * L / S;
    lend = (split + 1) * L / S;
    steps = (lend - kt0 + 1) / 2;
  } else {
    const int KT = (K + BK - 1) / BK;
    kt0 = split * KT / S;
    steps = (split + 1) * KT / S - kt0;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  constexpr int NA = BM / 2;              // accumulators per thread per instruction
  int acc[2][NA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[i][j] = 0;

  if (warp == kConsumers / 32) {
    // producer: keep the ring full
    if (lane == 0) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        unsigned char* sW = smem + s * stage_bytes<BM>();
        if constexpr (SKIP) {
          // k-tiles e and e + 1 into the stage's halves; a stage of one tile loads its
          // second half from past K, which TMA zero-fills, so every stage expects the
          // same bytes. qx: one 128-byte box where the two tiles are adjacent in k
          const int e = kt0 + 2 * t, k0 = list[e] * (BK / 2);
          const int k1 = e + 1 < lend ? list[e + 1] * (BK / 2) : K;
          mbar_arrive_expect_tx(&full[s], stage_bytes<BM>());
          tma_load_2d(sW, &tm_w, &full[s], n0, k0);
          tma_load_2d(sW + W_BYTES / 2, &tm_w, &full[s], n0, k1);
          if (e + 1 < lend && k1 == k0 + BK / 2) {
            tma_load_2d(sW + W_BYTES, &tm_xp, &full[s], k0, xm0);
          } else {
            tma_load_2d(sW + W_BYTES, &tm_x, &full[s], k0, xm0);
            tma_load_2d(sW + W_BYTES + x_half_bytes<BM>(), &tm_x, &full[s], k1, xm0);
          }
        } else {
          // expert-batched: a weight box past the expert's K rows reads the next
          // expert's rows, against qx columns past K, which TMA zero-fills
          mbar_arrive_expect_tx(&full[s], stage_bytes<BM>());
          const int k0 = (kt0 + t) * BK;
          tma_load_2d(sW, &tm_w, &full[s], n0, wk0 + k0);
          tma_load_2d(sW + W_BYTES, &tm_x, &full[s], k0, xm0);
        }
      }
    }
  } else {
    // consumers: warp w owns the block's output columns 32w .. 32w + 31
    for (int t = 0; t < steps; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const unsigned char* sW = smem + s * stage_bytes<BM>();
      const unsigned char* sX = sW + W_BYTES;
      unsigned af[BK / 32][2][4];
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        // k-rows 32ks + 4tg + r and 32ks + 16 + 4tg + r, bytes n = 32 warp + 4g .. + 3
        // (logical 16-byte chunk 2 warp + g / 4, at chunk ^ (row % 8))
        unsigned w0[4], w1[4], t0[4], t1[4];
        const int ch = 2 * warp + (g >> 2), off = (g & 3) * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int r0 = 32 * ks + 4 * tg + r, r1 = r0 + 16;
          w0[r] = *reinterpret_cast<const unsigned*>(sW + r0 * 128 + ((ch ^ (r0 & 7)) << 4) + off);
          w1[r] = *reinterpret_cast<const unsigned*>(sW + r1 * 128 + ((ch ^ (r1 & 7)) << 4) + off);
        }
        transpose4x4(w0, t0);
        transpose4x4(w1, t1);
        // instruction 0: rows g / g + 8 <-> n = 4g / 4g + 1; instruction 1: 4g + 2 / 4g + 3
        af[ks][0][0] = t0[0]; af[ks][0][1] = t0[1]; af[ks][0][2] = t1[0]; af[ks][0][3] = t1[1];
        af[ks][1][0] = t0[2]; af[ks][1][1] = t0[3]; af[ks][1][2] = t1[2]; af[ks][1][3] = t1[3];
      }
      wgmma_fence();
      if constexpr (SKIP) {
        // K7: qx as the producer loaded it, one 128-byte-swizzled box (pair) or two
        // 64-byte-swizzled ones; the k32 steps of a zero-filled half add nothing
        const int e0 = kt0 + 2 * t, e1 = min(e0 + 1, lend - 1);
        const int pair = (e1 > e0) & (list[e1] == list[e0] + 1);
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          uint64_t db;
          if constexpr (BM == 128) {     // chosen by a select: see the notes above
            db = pair ? desc_k_sw128(sX + 32 * ks)
                      : desc_k_sw64(sX + (ks >> 1) * x_half_bytes<BM>() + 32 * (ks & 1));
          } else {
            db = desc_k_sw(smem_u32(sX) + pair * (32 * ks) +
                               (1 - pair) * ((ks >> 1) * x_half_bytes<BM>() + 32 * (ks & 1)),
                           pair);
          }
          WgmmaS8<BM>::mma(acc[0], af[ks][0], db);
          WgmmaS8<BM>::mma(acc[1], af[ks][1], db);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          const uint64_t db = desc_k_sw128(sX + 32 * ks);
          WgmmaS8<BM>::mma(acc[0], af[ks][0], db);
          WgmmaS8<BM>::mma(acc[1], af[ks][1], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();                   // this warp's reads of stage s are done
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // acc[i][4j + 2h + e] <-> token m = m0 + 8j + 2tg + e, column n = n0 + 32 warp +
  // 4g + 2i + h: for each (j, e) a thread holds four consecutive columns
  const bool consumer = warp < kConsumers / 32;
  const int nl = 32 * warp + 4 * g;
  // 16-byte stores of four columns where the rows keep 16-byte alignment (N % 4 ==
  // 0, sw's base aligned); the last column tile's edge is masked per column
  const bool vec4 = !RAGGED || ((N & 3) == 0 && (out_i32 != nullptr ||
                                                  (reinterpret_cast<uintptr_t>(sw) & 15) == 0));
  if (S == 1) {
    // of the four, the columns inside N (all four or none where N % 16 == 0)
    const int nv = RAGGED ? min(4, N - (n0 + nl)) : (n0 + nl < N ? 4 : 0);
    if (consumer && nv > 0) {
      const bool whole = !RAGGED || (vec4 && nv == 4);
      float swc[4] = {0.f, 0.f, 0.f, 0.f};
      if (out_i32 == nullptr) {
        if (whole) {
          const float4 v = *reinterpret_cast<const float4*>(sw + n0 + nl);
          swc[0] = v.x; swc[1] = v.y; swc[2] = v.z; swc[3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nv) swc[c] = sw[n0 + nl + c];
        }
      }
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * tg + e;
          if (m >= M) continue;
          const int q = 4 * j + e;
          const int ac[4] = {acc[0][q], acc[0][q + 2], acc[1][q], acc[1][q + 2]};
          store4(out, out_i32, (size_t)m * N + n0 + nl, ac, out_i32 != nullptr ? 0.f : a[m],
                 swc, nv, whole);
        }
    }
    return;
  }

  __syncthreads();                       // every warp is done with the ring: reuse it
  int* sRed = reinterpret_cast<int*>(smem);         // [BM][BN] int32 partials
  if (consumer) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 4 * j + e;
        int4 v = make_int4(acc[0][q], acc[0][q + 2], acc[1][q], acc[1][q + 2]);
        *reinterpret_cast<int4*>(sRed + (8 * j + 2 * tg + e) * BN + nl) = v;
      }
  }
  cluster.sync();                        // every split's partials are written
  if constexpr (SKIP) {
    // K7: every rank sums and stores its own 1/S of the tile's rows, four columns a
    // thread, its S partials read at once
    const int r0 = split * BM / S, nr = (split + 1) * BM / S - r0;
    for (int idx = tid; idx < nr * (BN / 4); idx += kThreads) {
      const int ml = r0 + idx / (BN / 4), nl4 = 4 * (idx % (BN / 4));
      const int m = m0 + ml, n = n0 + nl4;
      if (m >= M || n >= N) continue;
      const int nv = RAGGED ? min(4, N - n) : 4;    // of the four, the columns inside N
      const bool whole = !RAGGED || (vec4 && nv == 4);
      int4 part[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        part[r] = r < S ? *reinterpret_cast<const int4*>(cluster.map_shared_rank(sRed, r) +
                                                         ml * BN + nl4)
                        : make_int4(0, 0, 0, 0);
      int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        sum.x += part[r].x;
        sum.y += part[r].y;
        sum.z += part[r].z;
        sum.w += part[r].w;
      }
      float swc[4] = {0.f, 0.f, 0.f, 0.f};
      if (out_i32 == nullptr) {
        if (whole) {
          const float4 v = *reinterpret_cast<const float4*>(sw + n);
          swc[0] = v.x; swc[1] = v.y; swc[2] = v.z; swc[3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nv) swc[c] = sw[n + c];
        }
      }
      const int ac[4] = {sum.x, sum.y, sum.z, sum.w};
      store4(out, out_i32, (size_t)m * N + n, ac, out_i32 != nullptr ? 0.f : a[m], swc, nv,
             whole);
    }
  } else if (split == 0) {
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int ml = idx / BN, n = n0 + idx % BN, m = m0 + ml;
      if (m >= M || n >= N) continue;
      int sum = 0;
      for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(sRed, r)[idx];
      if (out_i32 != nullptr)
        out_i32[(size_t)m * N + n] = sum;
      else
        out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), a[m]), sw[n]);
    }
  }
  cluster.sync();                        // every rank's partials have been read
}

// ---- K8 qgemm_w4a8, wgmma body -------------------------------------------------
//
// Replaces repro/kernels/qgemm.py::_w4a8_kernel (launcher qgemm_w4a8_pallas,
// pallas_call at :209) for M > DECODE_MAX_M (kernels/qgemm.py::qgemm_w4a8_plan):
//
//   out[m, n] = (sum_g float(sum_{k in g} qx[m, k] * w[k, n]) * sw[g, n]) * a[m]
//
// qw4 (K/2, N) int8 holds two int4 codes per byte along K (low nibble row 2r, high
// nibble row 2r + 1, sign-extended), sw (K/group, N) f32, group 64 or a multiple of
// 128 that divides K. f32-close to the plain version (which sums the groups in
// PyTorch's order), not bitwise.
//
// Expert-batched (a W4A8 tree's stacked experts) as K2's: one launch, the expert
// folded into grid y with the m-tiles, the 2-D tensor maps over the E experts' qx
// rows and packed weight rows, a, sw and out offset to the expert's.
//
// It keeps K2's wgmma design (out^T = w^T * qx^T, the weight the register-sourced
// A operand, qx the B operand through a 128B-swizzle descriptor, a producer warp
// feeding a TMA ring on mbarriers, cluster split-K) with three changes:
// - The weight stage is 64 packed rows x 128 bytes (a TMA box of 64 rows), the
//   same 128 k-rows as K2's 128 x 128-byte tile in half the bytes. Each lane reads
//   2-byte words, columns n and n + 1 of four packed rows, unpacks the nibbles in
//   registers and byte-permutes them into its A fragments: 4 shared loads per k32,
//   no 4 x 4 transposes, and the reads of a warp hit 16 distinct banks.
// - Each group's int32 sum starts fresh (wgmma scale-d 0 on its first k32 step);
//   after its last step the warpgroup drains (wgmma.wait_group 0) and folds the sum
//   as f32 * sw[g, n] into an f32 accumulator: one fold per 128-k stage at g128,
//   two at g64. The f32 accumulator doubles the accumulator registers, so the 128
//   output columns of a block are split over two consumer warpgroups of 64 (one
//   m64nBMk32 per k32 step each): at BM = 128 a thread holds 64 int32 and 64 f32.
// - How far the drain is hidden: the fold stalls only its own warpgroup; the
//   other one, on the other 64 columns of the same stage, keeps issuing wgmma, and
//   the producer keeps kW4Stages - 1 stages of TMA loads in flight. With 288
//   threads of ~170 registers one block holds an SM at BM > 64 (two blocks at BM
//   <= 64), so the two consumer warpgroups, not a second block, carry the overlap
//   there. On the H100 the unpack's instructions, not the drain, set the pace: a
//   cheaper sign extension made the body faster, while unpacking the next
//   stage during the current one's wgmma, an int32 -> f32 conversion off the I2F
//   unit, 16x codes (one instruction less per word) and ldmatrix.trans reads (one
//   instruction for eight 2-byte loads; faster only at M <= 64) each measured
//   slower at M >= 128.
constexpr int kW4Consumers = 256, kW4Threads = kW4Consumers + 32, kW4Stages = 4;
constexpr int W4_BYTES = (BK / 2) * BN;     // 64 packed rows x 128 bytes: 128 k-rows

template <int BM>
__host__ __device__ constexpr int w4_stage_bytes() { return W4_BYTES + BM * BK; }

template <int BM>
__host__ __device__ constexpr int w4_smem_bytes() {  // slack + ring (and partials) + barriers
  return 1024 + kW4Stages * w4_stage_bytes<BM>() + 2 * kW4Stages * 8;
}

// EXPERTS: an expert stack (the offsets below); a 2-D product compiles without them,
// as the body was before the expert mode (its pointers held in registers cost the
// 2-D group-acc mode half its speed on the H100)
template <int BM, bool EXPERTS>
__global__ void __launch_bounds__(kW4Threads, BM <= 64 ? 2 : 1)
qgemm_w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ a,
                        const float* __restrict__ sw, float* __restrict__ out, int M, int N,
                        int K, int group) {
  static_assert(BM * BN * 4 <= kW4Stages * w4_stage_bytes<BM>(), "partials fit in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kW4Stages * w4_stage_bytes<BM>());
  uint64_t* empty = full + kW4Stages;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  // grid y: the m-tiles of expert 0, then of expert 1, ... (one expert for a 2-D
  // product), as K2's; the tensor maps hold the E experts' qx rows and packed weight
  // rows one after the other
  const int mtiles = (M + BM - 1) / BM, ex = EXPERTS ? blockIdx.y / mtiles : 0;
  const int n0 = blockIdx.x * BN, m0 = (EXPERTS ? blockIdx.y % mtiles : blockIdx.y) * BM;
  const int xm0 = ex * M + m0, wp0 = ex * (K / 2);
  if constexpr (EXPERTS) {
    const size_t ng = K / group;
    if (a != nullptr) {
      a += (size_t)ex * M;
      sw += (size_t)ex * ng * N;
    }
    out += (size_t)ex * M * (a == nullptr ? ng : 1) * N;
  }
  const int S = gridDim.z, split = blockIdx.z;      // cluster (1, 1, S): rank == split
  // splits take whole units of max(group, 128) k-rows: whole groups and whole stages
  const int unit = group > BK ? group : BK, spu = unit / BK;
  const int KT = (K + BK - 1) / BK, NU = (K + unit - 1) / unit;
  const int kt0 = split * NU / S * spu;
  const int steps = min(KT, (split + 1) * NU / S * spu) - kt0;

  if (tid == 0) {
    for (int s = 0; s < kW4Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kW4Consumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  constexpr int NA = BM / 2;              // accumulators per thread
  int acc[NA];
  float accf[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    acc[j] = 0;
    accf[j] = 0.f;
  }
  // consumer warp w: warpgroup w / 4 owns the block's columns 64 (w / 4) .. + 63, its
  // warp w % 4 the A rows 16 (w % 4) .. + 15; a lane's rows g and g + 8 are the
  // columns nl and nl + 1
  const int nl = 64 * (warp >> 2) + 16 * (warp & 3) + 2 * g;
  const bool consumer = warp < kW4Consumers / 32;

  if (!consumer) {
    // producer: keep the ring full
    if (lane == 0) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kW4Stages;
        if (t >= kW4Stages) mbar_wait(&empty[s], ((t / kW4Stages) - 1) & 1);
        unsigned char* sW = smem + s * w4_stage_bytes<BM>();
        mbar_arrive_expect_tx(&full[s], w4_stage_bytes<BM>());
        const int k0 = (kt0 + t) * BK;
        // expert-batched: a last box of a K that ends on a g64 group reads the next
        // expert's first rows, which the consumers' k >= K break never multiplies
        tma_load_2d(sW, &tm_w, &full[s], n0, wp0 + k0 / 2);
        tma_load_2d(sW + W4_BYTES, &tm_x, &full[s], k0, xm0);
      }
    }
  } else {
    const int ch = nl >> 4, off = nl & 15;  // logical 16-byte chunk, byte offset
    const bool col_ok = n0 + nl < N;        // N % 16 == 0: both columns or neither
    // group-acc mode (a == nullptr; sw unread): each group's int32 sum is stored as
    // out[m, g, n], (M, K/group, N) int32, for a row-parallel W4 linear's gather of
    // the group partials, and never folded
    const bool gacc = a == nullptr;
    int* const out_g = reinterpret_cast<int*>(out);
    const int G = K / group;
    float2 sc = make_float2(0.f, 0.f);
    for (int t = 0; t < steps; ++t) {
      const int s = t % kW4Stages;
      mbar_wait(&full[s], (t / kW4Stages) & 1);
      const unsigned char* sW = smem + s * w4_stage_bytes<BM>();
      const unsigned char* sX = sW + W4_BYTES;
      const int k0 = (kt0 + t) * BK;
      unsigned af[BK / 32][4];
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // k-rows 32ks + 16h + 4tg + {0..3}: packed rows p, p + 1, p = 16ks + 8h + 2tg
          const int p = 16 * ks + 8 * h + 2 * tg;
          const unsigned lo16 = *reinterpret_cast<const unsigned short*>(
              sW + p * 128 + ((ch ^ (p & 7)) << 4) + off);
          const unsigned hi16 = *reinterpret_cast<const unsigned short*>(
              sW + (p + 1) * 128 + ((ch ^ ((p + 1) & 7)) << 4) + off);
          const unsigned w = lo16 | (hi16 << 16);   // (p, n), (p, n+1), (p+1, n), (p+1, n+1)
          const unsigned lo = nibbles_lo(w), hi = nibbles_hi(w);
          // k-rows 2p, 2p + 1, 2p + 2, 2p + 3 of column n, then of column n + 1
          af[ks][2 * h] = __byte_perm(lo, hi, 0x6240);
          af[ks][2 * h + 1] = __byte_perm(lo, hi, 0x7351);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        const int k = k0 + 32 * ks;
        if (k >= K) break;                  // the last stage of a K that ends on a g64 group
        if (k % group == 0 && col_ok && !gacc)  // a new group: its scales, first
          sc = *reinterpret_cast<const float2*>(sw + (size_t)(k / group) * N + n0 + nl);
        WgmmaS8<BM>::mma(acc, af[ks], desc_k_sw128(sX + 32 * ks), k % group != 0);
        if ((k + 32) % group == 0 && gacc) {
          // the group's last k32 step: drain, then store its int32 sum; acc[4j + 2h +
          // e] <-> token m = m0 + 8j + 2tg + e, column n = n0 + nl + h
          wgmma_commit();
          wgmma_wait<0>();
          if (col_ok) {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = m0 + 8 * j + 2 * tg + e;
                if (m < M)
                  *reinterpret_cast<int2*>(out_g + ((size_t)m * G + k / group) * N + n0 +
                                           nl) = make_int2(acc[4 * j + e], acc[4 * j + 2 + e]);
              }
          }
          wgmma_fence();                    // the stores read acc: order them first
        } else if ((k + 32) % group == 0) {
          // the group's last k32 step: drain, then f32 += f32(int32 sum) * sw[g, n]
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < NA; j += 4)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                accf[j + 2 * h + e] = __fadd_rn(
                    accf[j + 2 * h + e], __fmul_rn(__int2float_rn(acc[j + 2 * h + e]),
                                                   h ? sc.y : sc.x));
          wgmma_fence();                    // the fold read acc: order it before the next wgmma
        }
      }
      wgmma_commit();
      wgmma_wait<0>();                      // this warp's reads of stage s are done
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // group-acc mode: every group is stored and no split shares one (uniform over
  // the cluster: no barrier waits)
  if (a == nullptr) return;
  // accf[4j + 2h + e] <-> token m = m0 + 8j + 2tg + e, column n = n0 + nl + h
  if (S == 1) {
    if (consumer && n0 + nl < N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * tg + e;
          if (m >= M) continue;
          const float am = a[m];
          const float2 v = make_float2(__fmul_rn(accf[4 * j + e], am),
                                       __fmul_rn(accf[4 * j + 2 + e], am));
          *reinterpret_cast<float2*>(out + (size_t)m * N + n0 + nl) = v;
        }
    }
    return;
  }

  __syncthreads();                       // every warp is done with the ring: reuse it
  float* sRed = reinterpret_cast<float*>(smem);     // [BM][BN] f32 partials
  if (consumer) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(sRed + (8 * j + 2 * tg + e) * BN + nl) =
            make_float2(accf[4 * j + e], accf[4 * j + 2 + e]);
  }
  cluster.sync();                        // every split's partials are written
  if (split == 0) {
    for (int idx = tid; idx < BM * BN; idx += kW4Threads) {
      const int ml = idx / BN, n = n0 + idx % BN, m = m0 + ml;
      if (m >= M || n >= N) continue;
      float sum = 0.f;
      for (int r = 0; r < S; ++r) sum = __fadd_rn(sum, cluster.map_shared_rank(sRed, r)[idx]);
      out[(size_t)m * N + n] = __fmul_rn(sum, a[m]);
    }
  }
  cluster.sync();                        // the leader has read every block's partials
}

// a (rows, cols) row-major int8 matrix whose rows lie ld bytes apart (ld = cols
// where 0; a multiple of 16), box (box_rows, box_cols bytes): 128 bytes under the
// 128-byte swizzle, or 64 under the 64-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
            int box_cols = 128, int ld = 0) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : cols)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, bool SKIP, bool RAGGED>
int launch(const int8_t* qx, const int8_t* qw, const float* a, const float* sw, const int* occ,
           float* out, int M, int N, int K, int ldw, int splits, cudaStream_t s,
           int experts) {
  // K7 loads 64-row k-tiles: weight boxes of 64 rows, qx boxes of 64 bytes and, for
  // two k-adjacent tiles, of 128 (tm_xp; K2 does not read it). Expert-batched K2:
  // qx viewed as (E*M, K), qw as (E*K, N) at row pitch ldw
  CUtensorMap tm_x, tm_w, tm_xp;
  if (!encode(&tm_x, qx, experts * M, K, BM, SKIP ? BK / 2 : BK) ||
      !encode(&tm_w, qw, experts * K, N, SKIP ? BK / 2 : BK, 128, ldw) ||
      (SKIP && !encode(&tm_xp, qx, M, K, BM)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!SKIP) tm_xp = tm_x;
  const int smem = smem_bytes<BM>() + (SKIP ? 4 * (kListHead + (K + BK / 2 - 1) / (BK / 2)) : 0);
  cudaError_t err = cudaFuncSetAttribute(qgemm_wgmma_kernel<BM, SKIP, RAGGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, experts * ((M + BM - 1) / BM), splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qgemm_wgmma_kernel<BM, SKIP, RAGGED>, tm_x, tm_w, tm_xp, a, sw,
                           occ, out, M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool EXPERTS>
int launch_w4(const int8_t* qx, const int8_t* qw4, const float* a, const float* sw, float* out,
              int M, int N, int K, int group, int splits, cudaStream_t s, int experts) {
  CUtensorMap tm_x, tm_w;
  if (!encode(&tm_x, qx, experts * M, K, BM) || !encode(&tm_w, qw4, experts * (K / 2), N, BK / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = w4_smem_bytes<BM>();
  cudaError_t err = cudaFuncSetAttribute(qgemm_w4a8_wgmma_kernel<BM, EXPERTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, experts * ((M + BM - 1) / BM), splits);
  cfg.blockDim = dim3(kW4Threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qgemm_w4a8_wgmma_kernel<BM, EXPERTS>, tm_x, tm_w, a, sw, out,
                           M, N, K,
                           group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <bool SKIP, bool RAGGED>
int launch_r(const int8_t* qx, const int8_t* qw, const float* a, const float* sw,
             const int* occ, float* out, int M, int N, int K, int ldw, int splits,
             cudaStream_t s, int experts) {
  const int bm = M > 128 ? 128 : (M + 15) / 16 * 16;
  switch (bm) {
    case 16: case 32: case 48:
      return launch<48, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                      experts);
    case 64:
      return launch<64, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                      experts);
    case 80:
      return launch<80, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                      experts);
    case 96:
      return launch<96, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                      experts);
    case 112:
      return launch<112, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                       experts);
    default:
      return launch<128, SKIP, RAGGED>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s,
                                       experts);
  }
}

template <bool SKIP>
int launch_m(const int8_t* qx, const int8_t* qw, const float* a, const float* sw,
             const int* occ, float* out, int M, int N, int K, int ldw, int splits,
             cudaStream_t s, int experts = 1) {
  if (N % 16 != 0 || (a != nullptr && (reinterpret_cast<uintptr_t>(sw) & 15) != 0))
    return launch_r<SKIP, true>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s, experts);
  return launch_r<SKIP, false>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits, s, experts);
}

template <bool EXPERTS>
int launch_w4_m(const int8_t* qx, const int8_t* qw4, const float* a, const float* sw,
                float* out, int M, int N, int K, int group, int splits, cudaStream_t s,
                int experts) {
  const int bm = M > 128 ? 128 : (M + 15) / 16 * 16;
  switch (bm) {
    case 16: case 32: case 48:
      return launch_w4<48, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
    case 64:
      return launch_w4<64, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
    case 80:
      return launch_w4<80, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
    case 96:
      return launch_w4<96, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
    case 112:
      return launch_w4<112, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
    default:
      return launch_w4<128, EXPERTS>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts);
  }
}

// splits: 1..8 and at most ceil(K/128); M >= 1; K a multiple of 16; qw's rows ldw
// bytes apart, ldw a multiple of 16 and >= N (N any width); qx and qw 16-byte
// aligned. The token tile is M rounded up to 16 for M <= 128, else 128 rows.
// experts = E > 1: a stacked-expert linear, qx (E, M, K), qw (E, K, N) with expert
// e's rows from e * K * ldw, a (E, M), sw (E, N), out (E, M, N), E*M and E*K below
// 2^31. The wrapper picks splits (kernels/qgemm.py::wgmma_splits) and checks the
// rest. a == nullptr (sw then unread): int32-out mode, out is (M, N) int32, or (E,
// M, N) expert-batched.
REPRO_API int repro_qgemm_w8a8_wgmma(const int8_t* qx, const int8_t* qw, const float* a,
                                     const float* sw, float* out, int M, int N, int K, int ldw,
                                     int experts, int splits, void* stream) {
  const int KT = (K + BK - 1) / BK;
  if (M < 1 || N < 1 || K < 1 || ldw < N || ldw % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || splits > KT || experts < 1 ||
      (long long)experts * ((M + 47) / 48) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_m<false>(qx, qw, a, sw, nullptr, out, M, N, K, ldw, splits,
                         static_cast<cudaStream_t>(stream), experts);
}

// K7: occ (ceil(K/64), ceil(N/64)) int32 tile occupancy of qw, row-major, qw zero
// in every empty tile; splits 1..8 (a split whose share of a block's occupied
// k-tiles is empty writes zero partials); M >= 1; K a multiple of 16, qw's row
// pitch ldw as K2's; qx and qw 16-byte aligned; a == nullptr: int32-out mode, as
// K2's. The wrapper picks splits (kernels/qgemm.py::qgemm_w8a8_sparse_plan) and
// checks the rest.
REPRO_API int repro_qgemm_w8a8_sparse_wgmma(const int8_t* qx, const int8_t* qw,
                                            const float* a, const float* sw, const int* occ,
                                            float* out, int M, int N, int K, int ldw,
                                            int splits, void* stream) {
  if (M < 1 || N < 1 || K < 1 || ldw < N || ldw % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || occ == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_m<true>(qx, qw, a, sw, occ, out, M, N, K, ldw, splits,
                        static_cast<cudaStream_t>(stream));
}

// qw4 (K/2, N) packed int4; sw (K/group, N) f32; group 64 or a positive multiple of
// 128 that divides K; splits 1..8 and at most ceil(K / max(group, 128)); M >= 1; N a
// multiple of 16; qx, qw4 and sw 16-byte aligned. a == nullptr (sw then unread):
// group-acc mode, out is (M, K/group, N) int32, each group's sum undequantized.
// experts = E > 1: a stacked-expert linear, qx (E, M, K), qw4 (E, K/2, N), a (E, M),
// sw (E, K/group, N), out (E, M, N) or, group-acc, (E, M, K/group, N); the expert
// folded into grid y with the m-tiles, E*M and E*K below 2^31. The wrapper picks
// splits (kernels/qgemm.py::w4a8_wgmma_splits) and checks the rest.
REPRO_API int repro_qgemm_w4a8_wgmma(const int8_t* qx, const int8_t* qw4, const float* a,
                                     const float* sw, float* out, int M, int N, int K,
                                     int group, int experts, int splits, void* stream) {
  const int unit = group > BK ? group : BK;
  if (M < 1 || N < 1 || K < 1 || N % 16 != 0 || group <= 0 ||
      (group != 64 && group % BK != 0) || K % group != 0 || splits < 1 ||
      splits > kMaxSplits || splits > (K + unit - 1) / unit || experts < 1 ||
      (long long)experts * ((M + 47) / 48) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return experts > 1 ? launch_w4_m<true>(qx, qw4, a, sw, out, M, N, K, group, splits, s, experts)
                     : launch_w4_m<false>(qx, qw4, a, sw, out, M, N, K, group, splits, s, 1);
}

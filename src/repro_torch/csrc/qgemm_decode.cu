// K2 qgemm_w8a8, K7 qgemm_w8a8_sparse and K8 qgemm_w4a8, decode body: the int8 x
// int8 -> int32 GEMMs with the separable CrossQuant dequant for few activation
// rows (M <= 128; the wrappers route M <= 32 here, kernels/qgemm.py::
// qgemm_w8a8_plan, qgemm_w8a8_sparse_plan and qgemm_w4a8_plan), as a split-K,
// pipelined weight stream.
//
// Replaces, for small M, the TPU kernels in repro/kernels/qgemm.py:
//   _w8a8_kernel        (launcher qgemm_w8a8_pallas,        pallas_call at :71)  -> K2
//   _w8a8_sparse_kernel (launcher qgemm_w8a8_sparse_pallas, pallas_call at :149) -> K7 (SKIP)
//   _w4a8_kernel        (launcher qgemm_w4a8_pallas,        pallas_call at :209) -> K8 (W4)
// Larger M runs the wgmma bodies in qgemm_wgmma.cu, shapes neither takes the 64 x
// 64 tile body in qgemm_w8a8.cu.
//
//   K2: out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * a[m] * sw[n]
//   K8: out[m, n] = (sum_g float(sum_{k in g} qx[m, k] * w[k, n]) * sw[g, n]) * a[m]
//   K7: K2's sum over the 64-row k-tiles a (ceil(K/64), ceil(N/64)) int32 occupancy
//       table marks occupied; qw is zero in every empty (64 x 64) tile (the caller
//       guarantees it), so skipping one is exact and K7 is bitwise K2 and the plain
//       version.
//
// qx (M, K) int8 row-major, a (M,) f32, out (M, N) f32. K2: qw (K, N) int8
// row-major (the reference's layout), sw (N,) f32; K and N multiples of 16, qx and
// qw 16-byte aligned (the wrapper checks). The int32 sum is exact in any order and
// the epilogue multiplies in the reference's order, each step one IEEE rounding,
// so K2 is bitwise equal to the plain version. K8: qw4 (K/2, N) holds two int4
// codes per byte along K (low nibble row 2r, high nibble row 2r + 1, both
// sign-extended), sw (K/group, N) f32 group scales, group a multiple of 64 that
// divides K; each group's int32 partial is flushed as f32(partial) * sw[g, n] into
// an f32 sum, so K8 is f32-close to the plain version, which sums the groups in
// PyTorch's order, not bitwise.
//
// What bounds it on an H100: at decode (M = 4) the GEMM reads the whole K x N
// weight to produce four rows, 2*M operations per weight byte against the ~590
// int8 operations per byte the card can do: byte-bound. The only gain is to keep
// enough weight bytes in flight that the stream runs at the memory rate (Little's
// law: ~3.35 TB/s x ~1 us, a few MB across the card, tens of KB per SM). K8 reads
// half K2's weight bytes, plus K/group f32 scales per column (6 % of its bytes at
// g128, read once per split and group: each warp's 32 columns, a float4 per lane
// shared by its four k-lanes).
//
// Modes for tensor parallelism (a == nullptr, sw unread): K2's int32-out mode
// writes the split-summed int32 accumulator (expert-batched too: a stacked down
// projection under expert-internal TP sums it across ranks before its dequant);
// K8's group-acc mode writes each group's int32 partial as out[m, g, n], (M,
// K/group, N), where the group flush would fold it through sw: a split owns whole
// groups, so a block stores its own groups and skips the cluster reduction.
//
// Design:
// - Roles swapped: the tensor cores compute out^T = qw^T * qx^T with
//   mma.sync.m16n8k32.s8, so the weight is the 16-row A operand and the M
//   activation rows fill the n8 side (M = 4 fills half of it, M <= 8 one tile,
//   MT = ceil(M / 8) tiles). Each lane reads four k-rows of four weight bytes
//   (n = 4g..4g+3) and transposes the 4 x 4 bytes in registers (transpose4x4;
//   ldmatrix.trans takes no 8-bit elements): its four n become rows g and g + 8
//   of two MMAs, so the weight tile needs no transposed copy in shared memory.
//   K8 reads two packed rows instead and unpacks each 4-byte word into its low
//   and high k-rows in registers (nibbles_lo / nibbles_hi: a mask, and a multiply
//   that fills the high half of each negative byte, fewer instructions than
//   __vsub4 and faster on the H100), then runs the same transposes. The B operand
//   (qx, k-contiguous) is read as it lies.
// - A block owns 128 output columns (4 warps x 32) and one K split. Its weight
//   rows stream through a ring of 4 shared-memory stages of 64 k-rows (8 KB of
//   int8 weights, or 4 KB of packed int4, plus the stage's qx slice) with
//   cp.async.cg, 16 B per thread and copy, so three stages are in flight while one
//   is multiplied (for K8, 8 stages, 128-row stages of 8 KB, or 8 warps that split
//   such a stage in two halves each measured no faster on the H100 over the four
//   decode shapes together). The 16-byte chunks of each 128-byte row are
//   XOR-swizzled by row so the lanes' 4-byte reads hit 32 distinct banks (by k-row
//   / 4 for int8 rows, by packed row / 2 for int4 rows); qx rows are padded to 80
//   bytes.
// - Expert-batched K2 (a stacked-expert linear: E experts' (C, K) dispatch rows, C
//   = 8 at every granite and llama4-scout decode step): one launch, expert e on grid
//   z, each block offsetting qx, qw, a, sw and out to its expert's; the clusters
//   and the split-K reduction stay within one expert. The plan counts all E
//   experts' output tiles when it picks the splits (granite up/gate: 4 column
//   blocks x 40 experts = 160, so 4 splits; down: 12 x 40 = 480, so 2).
// - Split-K across a thread-block cluster: the grid is (ceil(N/128), S) with
//   cluster (1, S, 1), S <= 8 splits of whole 64-row k-tiles (K2: split s takes
//   k-tiles [s*KT/S, (s+1)*KT/S)) or of whole groups (K8: groups [s*G/S,
//   (s+1)*G/S), so no group straddles two splits). Each block leaves its partials
//   (K2 int32, K8 f32) in its own shared memory; after a cluster barrier the
//   leader (rank 0) sums the S partials through distributed shared memory in rank
//   order, runs the epilogue and stores; a second barrier keeps the other blocks'
//   shared memory alive until it has read them. No workspace, no atomics,
//   deterministic, and a launch replays unchanged under CUDA-graph capture.
// - K7 (SKIP) streams only the occupied part of K2's work: at block start the
//   block reads the occupancy of its own 128 columns (two 64-column table
//   columns) and compacts the ascending list of the 64-row stages occupied in
//   either (common.cuh::occupied_k_tiles); split s then takes list entries
//   [s*L/S, (s+1)*L/S), so the cluster shares the occupied stages evenly, not K,
//   and load(step) indexes the list. A split (or a whole block) whose share is
//   empty still writes zero partials and reaches both cluster barriers, and the
//   epilogue writes 0 * a * sw where nothing was occupied. After the first
//   barrier every rank, not only the leader, sums and stores its own 1/S of the
//   block's columns, reading the S partials at once. The host never reads the
//   table: the plan is a function of (M, K, N), so a launch replays unchanged
//   under CUDA-graph capture, as K2's does. A deeper ring (6 or 8 stages) measured
//   slower on the H100 at every decode shape: fewer blocks fit an SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 128, BK = 64, kStages = 4, kThreads = 128, kMaxSplits = 8;
constexpr int LDX = BK + 16;   // 80-byte qx rows: the B-fragment reads hit 32 banks

// weight bytes of one stage: 64 int8 k-rows, or 32 packed int4 rows (64 k-rows)
template <bool W4>
__host__ __device__ constexpr int w_bytes() { return (W4 ? BK / 2 : BK) * BN; }

template <int MT, bool W4>
__host__ __device__ constexpr int stage_bytes() { return w_bytes<W4>() + 8 * MT * LDX; }

template <int MT, bool W4>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<MT, W4>() > 8 * MT * BN * 4 ? kStages * stage_bytes<MT, W4>()
                                                           : 8 * MT * BN * 4;
}

// the physical 16-byte chunk of logical chunk ch in stage row r. int8 rows: XOR
// with 2 * ((r / 4) % 4), so the four k-row groups a warp reads at once sit in
// distinct banks; packed int4 rows, of which a warp reads rows 2tg and 2tg + 1 at
// once: XOR with 2 * ((r / 2) % 4)
template <bool W4>
__device__ __forceinline__ int swz(int r, int ch) {
  return W4 ? ch ^ (((r >> 1) & 3) << 1) : ch ^ (((r >> 2) & 3) << 1);
}

// K7's shared memory past the ring: warp counts, then the list of occupied k-tiles
constexpr int kListHead = kThreads / 32;

template <int MT, bool W4, bool SKIP>
__global__ void __launch_bounds__(kThreads)
qgemm_decode_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
                    const float* __restrict__ a, const float* __restrict__ sw,
                    const int* __restrict__ occ, float* __restrict__ out, int M, int N, int K,
                    int group) {
  static_assert(!(SKIP && W4), "the tile skip is K7's, a W8 product");
  constexpr int MR = 8 * MT;              // qx rows staged: M padded to the n8 tiles
  extern __shared__ __align__(16) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int S = gridDim.y, split = blockIdx.y;   // cluster (1, S, 1): rank == split
  // expert-batched K2 (grid z = E): expert z's (M, K) rows, (K, N) weight, scales and
  // (M, N) output; z = 0 for a 2-D product
  // int32-out mode (a == nullptr; sw unread): K2 stores the summed int32 accumulator
  // undequantized, for a row-parallel linear's cross-shard SUM (expert-batched too);
  // K8 (group-acc) stores each group's int32 partial as out[m, g, n], (M, K/group, N),
  // for a row-parallel W4 linear's gather of the group partials
  const bool i32 = a == nullptr;
  const size_t ez = blockIdx.z;
  qx += ez * M * K;
  qw += ez * K * N;
  if (!i32) {
    a += ez * M;
    sw += ez * N;
  }
  out += ez * M * N;
  int* const out_i32 = i32 ? reinterpret_cast<int*>(out) : nullptr;
  int kbeg = 0, kend = K, steps;
  int* list = reinterpret_cast<int*>(smem + smem_bytes<MT, W4>()) + kListHead;   // K7
  if constexpr (SKIP) {           // this split's share of the block's occupied k-tiles
    const int L = occupied_k_tiles(occ, (K + BK - 1) / BK, (N + 63) / 64, 2 * blockIdx.x, list,
                                   list - kListHead);
    kbeg = split * L / S;         // list entries [kbeg, kbeg + steps)
    steps = (split + 1) * L / S - kbeg;
  } else {
    if (W4) {                     // whole groups per split; K % group == 0, group % 64 == 0
      const int G = K / group;
      kbeg = split * G / S * group;
      kend = (split + 1) * G / S * group;
    } else {                      // whole 64-row k-tiles per split, the last cut at K
      const int KT = (K + BK - 1) / BK;
      kbeg = split * KT / S * BK;
      kend = min(K, (split + 1) * KT / S * BK);
    }
    steps = (kend - kbeg + BK - 1) / BK;
  }

  auto load = [&](int step, int buf) {
    int8_t* sW = smem + buf * stage_bytes<MT, W4>();
    int8_t* sX = sW + w_bytes<W4>();
    const int k0 = SKIP ? list[kbeg + step] * BK : kbeg + step * BK;
    if (W4) {                     // 32 packed rows: k-rows k0 .. k0 + 63
#pragma unroll
      for (int c = tid; c < (BK / 2) * BN / 16; c += kThreads) {
        const int r = c >> 3, ch = c & 7, gp = k0 / 2 + r, gn = n0 + ch * 16;
        const bool ok = gp < kend / 2 && gn < N;
        async_copy16(sW + r * BN + swz<true>(r, ch) * 16, ok ? qw + (size_t)gp * N + gn : qw,
                     ok);
      }
    } else {
#pragma unroll
      for (int c = tid; c < BK * BN / 16; c += kThreads) {
        const int r = c >> 3, ch = c & 7, gk = k0 + r, gn = n0 + ch * 16;
        const bool ok = gk < kend && gn < N;        // N % 16 == 0: a chunk is in or out
        async_copy16(sW + r * BN + swz<false>(r, ch) * 16, ok ? qw + (size_t)gk * N + gn : qw,
                     ok);
      }
    }
    for (int c = tid; c < MR * (BK / 16); c += kThreads) {
      const int m = c >> 2, ch = c & 3, gk = k0 + ch * 16;
      const bool ok = m < M && gk < kend;           // kend % 16 == 0
      async_copy16(sX + m * LDX + ch * 16, ok ? qx + (size_t)m * K + gk : qx, ok);
    }
  };

  int acc[MT][2][4];
  float accf[MT][2][4];           // K8: the group-dequantized sum
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][i][e] = 0;
        accf[j][i][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    async_wait<kStages - 2>();   // stage t has landed (this thread's copies) ...
    __syncthreads();             // ... everyone's, and stage t - 1's buffer is free
    if (t + kStages - 1 < steps) load(t + kStages - 1, (t + kStages - 1) % kStages);
    async_commit();
    const int8_t* sW = smem + (t % kStages) * stage_bytes<MT, W4>();
    const int8_t* sX = sW + w_bytes<W4>();
    // K8: the scales of the group this stage ends, fetched before the stage's MMAs
    const int kdone = kbeg + (t + 1) * BK;
    const bool flush = W4 && kdone % group == 0;
    float4 swg = make_float4(0.f, 0.f, 0.f, 0.f);
    if (flush && !i32 && n0 + 32 * warp + 4 * g < N)  // N % 16 == 0: all four or none
      swg = *reinterpret_cast<const float4*>(sw + (size_t)(kdone / group - 1) * N + n0 +
                                             32 * warp + 4 * g);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // k-rows ks + 4tg + r (chunk tg of the mma's k32) and ks + 16 + 4tg + r
      // (chunk tg + 4), bytes n = 32 warp + 4g .. + 3; (row / 4) % 4 == tg. K8 reads
      // them as packed rows ks/2 + 2tg + {0, 1} and ks/2 + 8 + 2tg + {0, 1}, whose
      // low and high nibbles are k-rows 2p and 2p + 1; (row / 2) % 4 == tg
      unsigned w0[4], w1[4], t0[4], t1[4];
      if (W4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p0 = ks / 2 + 2 * tg + h, p1 = p0 + 8;
          const int c0 = (((2 * warp + (g >> 2)) ^ (((p0 >> 1) & 3) << 1)) << 4) + (g & 3) * 4;
          const int c1 = (((2 * warp + (g >> 2)) ^ (((p1 >> 1) & 3) << 1)) << 4) + (g & 3) * 4;
          const unsigned q0 = *reinterpret_cast<const unsigned*>(sW + p0 * BN + c0);
          const unsigned q1 = *reinterpret_cast<const unsigned*>(sW + p1 * BN + c1);
          w0[2 * h] = nibbles_lo(q0);
          w0[2 * h + 1] = nibbles_hi(q0);
          w1[2 * h] = nibbles_lo(q1);
          w1[2 * h + 1] = nibbles_hi(q1);
        }
      } else {
        const int col = (((2 * warp + (g >> 2)) ^ (tg << 1)) << 4) + (g & 3) * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w0[r] = *reinterpret_cast<const unsigned*>(sW + (ks + 4 * tg + r) * BN + col);
          w1[r] = *reinterpret_cast<const unsigned*>(sW + (ks + 16 + 4 * tg + r) * BN + col);
        }
      }
      transpose4x4(w0, t0);
      transpose4x4(w1, t1);
      // mma 0: rows g / g + 8 <-> n = 4g / 4g + 1; mma 1: n = 4g + 2 / 4g + 3
      const unsigned a0[4] = {t0[0], t0[1], t1[0], t1[1]};
      const unsigned a1[4] = {t0[2], t0[3], t1[2], t1[3]};
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int8_t* xr = sX + (8 * j + g) * LDX + ks + 4 * tg;
        const unsigned b[2] = {*reinterpret_cast<const unsigned*>(xr),
                               *reinterpret_cast<const unsigned*>(xr + 16)};
        mma_s8(acc[j][0], a0, b);
        mma_s8(acc[j][1], a1, b);
      }
    }
    if (flush && i32) {
      // group-acc mode: the group's int32 partial to out[m, g, n]; clear.
      // acc[j][i][2h + e] <-> n = n0 + 32 warp + 4g + 2i + h, m = 8j + 2tg + e
      const int G = K / group, gi = kdone / group - 1;
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = 8 * j + 2 * tg + e, n = n0 + 32 * warp + 4 * g + 2 * i + h;
              int& p = acc[j][i][2 * h + e];
              if (m < M && n < N) out_i32[((size_t)m * G + gi) * N + n] = p;
              p = 0;
            }
    } else if (flush) {
      // end of a group: f32 += f32(int32 partial) * sw[g, n]; clear. acc[j][i][2h + e]
      // <-> n = 32 warp + 4g + 2i + h: scale component 2i + h
      const float sc[4] = {swg.x, swg.y, swg.z, swg.w};
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int& p = acc[j][i][2 * h + e];
              float& f = accf[j][i][2 * h + e];
              f = __fadd_rn(f, __fmul_rn(__int2float_rn(p), sc[2 * i + h]));
              p = 0;
            }
    }
  }
  async_wait<0>();
  // group-acc mode: every group's partial is stored, and no split shares a group,
  // so there is nothing to reduce (uniform over the cluster: no barrier waits)
  if (W4 && i32) return;
  __syncthreads();               // the ring is drained: reuse it for the partials

  // partials [m][n_local], int32 (K2) or f32 (K8): acc[j][i][2h + e] <-> n = 32 warp +
  // 4g + 2i + h, m = 8j + 2tg + e
  int* sRed = reinterpret_cast<int*>(smem);
  float* sRedf = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = (8 * j + 2 * tg + e) * BN + 32 * warp + 4 * g + 2 * i + h;
          if (W4)
            sRedf[idx] = accf[j][i][2 * h + e];
          else
            sRed[idx] = acc[j][i][2 * h + e];
        }
  cluster.sync();                // every split's partials are written (release/acquire)

  if constexpr (SKIP) {
    // K7: every rank sums and stores its own slice of the block's columns, its S
    // partials read at once
    const int c0 = split * BN / S, nc = (split + 1) * BN / S - c0;
    for (int idx = tid; idx < M * nc; idx += kThreads) {
      const int m = idx / nc, cl = c0 + idx % nc, n = n0 + cl;
      if (n >= N) continue;
      int part[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        part[r] = r < S ? cluster.map_shared_rank(sRed, r)[m * BN + cl] : 0;
      int sum = 0;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) sum += part[r];
      if (out_i32 != nullptr)
        out_i32[(size_t)m * N + n] = sum;
      else
        out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), a[m]), sw[n]);
    }
  } else if (split == 0) {
    const int n = n0 + tid;      // one output column per thread (BN == kThreads)
    if (n < N) {
      if (W4) {
        for (int m = 0; m < M; ++m) {
          float sum = 0.f;
          for (int r = 0; r < S; ++r)
            sum = __fadd_rn(sum, cluster.map_shared_rank(sRedf, r)[m * BN + tid]);
          out[(size_t)m * N + n] = __fmul_rn(sum, a[m]);
        }
      } else if (out_i32 != nullptr) {
        for (int m = 0; m < M; ++m) {
          int sum = 0;
          for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(sRed, r)[m * BN + tid];
          out_i32[(size_t)m * N + n] = sum;
        }
      } else {
        const float swn = sw[n];
        for (int m = 0; m < M; ++m) {
          int sum = 0;
          for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(sRed, r)[m * BN + tid];
          out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), a[m]), swn);
        }
      }
    }
  }
  cluster.sync();                // the leader has read every block's shared memory
}

template <int MT, bool W4, bool SKIP>
int launch(const int8_t* qx, const int8_t* qw, const float* a, const float* sw, const int* occ,
           float* out, int M, int N, int K, int group, int splits, cudaStream_t s,
           int experts) {
  const int smem = smem_bytes<MT, W4>() + (SKIP ? 4 * (kListHead + (K + BK - 1) / BK) : 0);
  cudaError_t err = cudaFuncSetAttribute(qgemm_decode_kernel<MT, W4, SKIP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, splits, experts);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qgemm_decode_kernel<MT, W4, SKIP>, qx, qw, a, sw, occ, out, M,
                           N, K, group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4, bool SKIP>
int launch_m(const int8_t* qx, const int8_t* qw, const float* a, const float* sw,
             const int* occ, float* out, int M, int N, int K, int group, int splits,
             cudaStream_t s, int experts = 1) {
  if (M <= 8)
    return launch<1, W4, SKIP>(qx, qw, a, sw, occ, out, M, N, K, group, splits, s, experts);
  if (M <= 16)
    return launch<2, W4, SKIP>(qx, qw, a, sw, occ, out, M, N, K, group, splits, s, experts);
  if (M <= 32)
    return launch<4, W4, SKIP>(qx, qw, a, sw, occ, out, M, N, K, group, splits, s, experts);
  if (M <= 64)
    return launch<8, W4, SKIP>(qx, qw, a, sw, occ, out, M, N, K, group, splits, s, experts);
  return launch<16, W4, SKIP>(qx, qw, a, sw, occ, out, M, N, K, group, splits, s, experts);
}

}  // namespace

// splits: 1..8 and at most ceil(K/64), so no split is empty; M in 1..128; K and N
// multiples of 16; qx and qw 16-byte aligned. experts = E > 1: a stacked-expert
// linear, qx (E, M, K), qw (E, K, N), a (E, M), sw (E, N), out (E, M, N), expert e
// on grid z. a == nullptr (sw then unread): int32-out mode, out is (M, N) int32 (or
// (E, M, N) expert-batched), the accumulator summed over the splits in int32. The
// wrapper picks splits (kernels/qgemm.py::decode_splits) and checks the rest.
REPRO_API int repro_qgemm_w8a8_decode(const int8_t* qx, const int8_t* qw, const float* a,
                                      const float* sw, float* out, int M, int N, int K,
                                      int experts, int splits, void* stream) {
  const int KT = (K + BK - 1) / BK;
  if (M < 1 || M > 128 || N < 1 || K < 1 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || splits > KT || experts < 1 || experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_m<false, false>(qx, qw, a, sw, nullptr, out, M, N, K, 0, splits,
                                static_cast<cudaStream_t>(stream), experts);
}

// K7: occ (ceil(K/64), ceil(N/64)) int32 tile occupancy of qw, row-major, qw zero
// in every empty tile; splits 1..8 (a split whose share of a block's occupied
// k-tiles is empty writes zero partials); M in 1..128; K and N multiples of 16; qx
// and qw 16-byte aligned; a == nullptr: int32-out mode, as K2's. The wrapper picks
// splits (kernels/qgemm.py::qgemm_w8a8_sparse_plan) and checks the rest.
REPRO_API int repro_qgemm_w8a8_sparse_decode(const int8_t* qx, const int8_t* qw,
                                             const float* a, const float* sw, const int* occ,
                                             float* out, int M, int N, int K, int splits,
                                             void* stream) {
  if (M < 1 || M > 128 || N < 1 || K < 1 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || occ == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_m<false, true>(qx, qw, a, sw, occ, out, M, N, K, 0, splits,
                               static_cast<cudaStream_t>(stream));
}

// qw4 (K/2, N) packed int4, sw (K/group, N) f32; group a positive multiple of 64
// dividing K; splits 1..8 and at most K/group; M in 1..128; N a multiple of 16; qx,
// qw4 and sw 16-byte aligned. a == nullptr (sw then unread): group-acc mode, out
// is (M, K/group, N) int32, each group's partial sum of products undequantized. The
// wrapper picks splits (kernels/qgemm.py::w4a8_decode_splits) and checks the rest.
REPRO_API int repro_qgemm_w4a8_decode(const int8_t* qx, const int8_t* qw4, const float* a,
                                      const float* sw, float* out, int M, int N, int K,
                                      int group, int splits, void* stream) {
  if (M < 1 || M > 128 || N < 1 || K < 1 || N % 16 != 0 || group <= 0 || group % BK != 0 ||
      K % group != 0 || splits < 1 || splits > kMaxSplits || splits > K / group)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_m<true, false>(qx, qw4, a, sw, nullptr, out, M, N, K, group, splits,
                               static_cast<cudaStream_t>(stream));
}

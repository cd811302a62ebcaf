// K2 qgemm_w8a8, decode body: the int8 x int8 -> int32 GEMM with the separable
// CrossQuant dequant for few activation rows (M <= 128; the wrapper routes
// M <= 32 here, kernels/qgemm.py::qgemm_w8a8_plan), as a split-K, pipelined
// weight stream.
//
// Replaces the TPU kernel repro/kernels/qgemm.py::_w8a8_kernel (launcher
// qgemm_w8a8_pallas, pallas_call at :71) for small M; larger M runs the 64 x 64
// tile body in qgemm_w8a8.cu.
//
//   out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * a[m] * sw[n]
//
// qx (M, K) int8 row-major, qw (K, N) int8 row-major (the reference's layout), a
// (M,) f32, sw (N,) f32, out (M, N) f32; K and N multiples of 16, qx and qw
// 16-byte aligned (the wrapper checks). The int32 sum is exact in any order and
// the epilogue multiplies in the reference's order, each step one IEEE rounding,
// so the result is bitwise equal to the plain version.
//
// What bounds it on an H100: at decode (M = 4) the GEMM reads the whole K x N
// weight to produce four rows, 2*M operations per weight byte against the ~590
// int8 operations per byte the card can do: byte-bound. The only gain is to keep
// enough weight bytes in flight that the stream runs at the memory rate (Little's
// law: ~3.35 TB/s x ~1 us, a few MB across the card, tens of KB per SM).
//
// Design:
// - Roles swapped: the tensor cores compute out^T = qw^T * qx^T with
//   mma.sync.m16n8k32.s8, so the weight is the 16-row A operand and the M
//   activation rows fill the n8 side (M = 4 fills half of it, M <= 8 one tile,
//   MT = ceil(M / 8) tiles). Each lane reads four k-rows of four weight bytes
//   (n = 4g..4g+3) and transposes the 4 x 4 bytes in registers (transpose4x4;
//   ldmatrix.trans takes no 8-bit elements): its four n become rows g and g + 8
//   of two MMAs, so the weight tile needs no transposed copy in shared memory.
//   The B operand (qx, k-contiguous) is read as it lies.
// - A block owns 128 output columns (4 warps x 32) and one K split. Its weight
//   rows stream through a ring of 4 shared-memory stages of 64 k-rows (8 KB of
//   weights plus the stage's qx slice) with cp.async.cg, 16 B per thread and
//   copy, so three stages (24 KB) are in flight while one is multiplied. The 16-
//   byte chunks of each 128-byte row are XOR-swizzled by k-row so the lanes'
//   4-byte reads hit 32 distinct banks; qx rows are padded to 80 bytes.
// - Split-K across a thread-block cluster: the grid is (ceil(N/128), S) with
//   cluster (1, S, 1), S <= 8 splits of whole 64-row k-tiles (split s takes
//   k-tiles [s*KT/S, (s+1)*KT/S)). Each block leaves its int32 partials in its
//   own shared memory; after a cluster barrier the leader (rank 0) sums the S
//   partials through distributed shared memory in rank order, runs the epilogue
//   and stores; a second barrier keeps the other blocks' shared memory alive
//   until it has read them. No workspace, no atomics, deterministic, and a
//   launch replays unchanged under CUDA-graph capture.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 128, BK = 64, kStages = 4, kThreads = 128, kMaxSplits = 8;
constexpr int LDX = BK + 16;   // 80-byte qx rows: the B-fragment reads hit 32 banks

template <int MT>
__host__ __device__ constexpr int stage_bytes() { return BK * BN + 8 * MT * LDX; }

template <int MT>
constexpr int smem_bytes() {
  return kStages * stage_bytes<MT>() > 8 * MT * BN * 4 ? kStages * stage_bytes<MT>()
                                                       : 8 * MT * BN * 4;
}

// the physical 16-byte chunk of logical chunk ch in stage row r: XOR with 2 *
// ((r / 4) % 4), so the four k-row groups a warp reads at once sit in distinct banks
__device__ __forceinline__ int swz(int r, int ch) { return ch ^ (((r >> 2) & 3) << 1); }

template <int MT>
__global__ void __launch_bounds__(kThreads)
qgemm_decode_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
                    const float* __restrict__ a, const float* __restrict__ sw,
                    float* __restrict__ out, int M, int N, int K) {
  constexpr int MR = 8 * MT;              // qx rows staged: M padded to the n8 tiles
  extern __shared__ __align__(16) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int S = gridDim.y, split = blockIdx.y;   // cluster (1, S, 1): rank == split
  const int KT = (K + BK - 1) / BK;
  const int kt0 = split * KT / S, kt1 = (split + 1) * KT / S;
  const int steps = kt1 - kt0, kbeg = kt0 * BK, kend = min(K, kt1 * BK);

  auto load = [&](int step, int buf) {
    int8_t* sW = smem + buf * stage_bytes<MT>();
    int8_t* sX = sW + BK * BN;
    const int k0 = kbeg + step * BK;
#pragma unroll
    for (int c = tid; c < BK * BN / 16; c += kThreads) {
      const int r = c >> 3, ch = c & 7, gk = k0 + r, gn = n0 + ch * 16;
      const bool ok = gk < kend && gn < N;          // N % 16 == 0: a chunk is in or out
      async_copy16(sW + r * BN + swz(r, ch) * 16, ok ? qw + (size_t)gk * N + gn : qw, ok);
    }
    for (int c = tid; c < MR * (BK / 16); c += kThreads) {
      const int m = c >> 2, ch = c & 3, gk = k0 + ch * 16;
      const bool ok = m < M && gk < kend;           // kend % 16 == 0
      async_copy16(sX + m * LDX + ch * 16, ok ? qx + (size_t)m * K + gk : qx, ok);
    }
  };

  int acc[MT][2][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0;

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
    const int8_t* sW = smem + (t % kStages) * stage_bytes<MT>();
    const int8_t* sX = sW + BK * BN;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // k-rows ks + 4tg + r (chunk tg of the mma's k32) and ks + 16 + 4tg + r
      // (chunk tg + 4), bytes n = 32 warp + 4g .. + 3; (row / 4) % 4 == tg
      unsigned w0[4], w1[4], t0[4], t1[4];
      const int col = (((2 * warp + (g >> 2)) ^ (tg << 1)) << 4) + (g & 3) * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w0[r] = *reinterpret_cast<const unsigned*>(sW + (ks + 4 * tg + r) * BN + col);
        w1[r] = *reinterpret_cast<const unsigned*>(sW + (ks + 16 + 4 * tg + r) * BN + col);
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
  }
  async_wait<0>();
  __syncthreads();               // the ring is drained: reuse it for the partials

  // partials [m][n_local] int32: acc[j][i][2h + e] <-> n = 32 warp + 4g + 2i + h,
  // m = 8j + 2tg + e
  int* sRed = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sRed[(8 * j + 2 * tg + e) * BN + 32 * warp + 4 * g + 2 * i + h] = acc[j][i][2 * h + e];
  cluster.sync();                // every split's partials are written (release/acquire)

  if (split == 0) {
    const int n = n0 + tid;      // one output column per thread (BN == kThreads)
    if (n < N) {
      const float swn = sw[n];
      for (int m = 0; m < M; ++m) {
        int sum = 0;
        for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(sRed, r)[m * BN + tid];
        out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), a[m]), swn);
      }
    }
  }
  cluster.sync();                // the leader has read every block's shared memory
}

template <int MT>
int launch(const int8_t* qx, const int8_t* qw, const float* a, const float* sw, float* out,
           int M, int N, int K, int splits, cudaStream_t s) {
  constexpr int smem = smem_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(qgemm_decode_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, splits, 1);
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
  err = cudaLaunchKernelEx(&cfg, qgemm_decode_kernel<MT>, qx, qw, a, sw, out, M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// splits: 1..8 and at most ceil(K/64), so no split is empty; M in 1..128; K and N
// multiples of 16; qx and qw 16-byte aligned. The wrapper picks splits
// (kernels/qgemm.py::decode_splits) and checks the rest.
REPRO_API int repro_qgemm_w8a8_decode(const int8_t* qx, const int8_t* qw, const float* a,
                                      const float* sw, float* out, int M, int N, int K,
                                      int splits, void* stream) {
  const int KT = (K + BK - 1) / BK;
  if (M < 1 || M > 128 || N < 1 || K < 1 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || splits > KT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<1>(qx, qw, a, sw, out, M, N, K, splits, s);
  if (M <= 16) return launch<2>(qx, qw, a, sw, out, M, N, K, splits, s);
  if (M <= 32) return launch<4>(qx, qw, a, sw, out, M, N, K, splits, s);
  if (M <= 64) return launch<8>(qx, qw, a, sw, out, M, N, K, splits, s);
  return launch<16>(qx, qw, a, sw, out, M, N, K, splits, s);
}

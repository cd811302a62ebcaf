// K2 qgemm_w8a8, wgmma body: the int8 x int8 -> int32 GEMM with the separable
// CrossQuant dequant for more activation rows than the decode body takes (the
// wrapper routes M > DECODE_MAX_M here, kernels/qgemm.py::qgemm_w8a8_plan).
//
// Replaces the TPU kernel repro/kernels/qgemm.py::_w8a8_kernel (launcher
// qgemm_w8a8_pallas, pallas_call at :71) for packed chunked steps and prefills;
// few rows run qgemm_decode.cu, shapes this body does not take the 64 x 64 tile
// body in qgemm_w8a8.cu.
//
//   out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * a[m] * sw[n]
//
// qx (M, K) int8 row-major, qw (K, N) int8 row-major (the reference's layout), a
// (M,) f32, sw (N,) f32, out (M, N) f32; K and N multiples of 16, qx and qw
// 16-byte aligned (TMA's rules; the wrapper checks). The int32 sum is exact in
// any order and the epilogue multiplies in the reference's order, so the result
// is bitwise equal to the plain version.
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

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ a,
                   const float* __restrict__ sw, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<BM>());
  uint64_t* empty = full + kStages;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int S = gridDim.z, split = blockIdx.z;      // cluster (1, 1, S): rank == split
  const int KT = (K + BK - 1) / BK;
  const int kt0 = split * KT / S, steps = (split + 1) * KT / S - kt0;

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
        mbar_arrive_expect_tx(&full[s], stage_bytes<BM>());
        const int k0 = (kt0 + t) * BK;
        tma_load_2d(sW, &tm_w, &full[s], n0, k0);
        tma_load_2d(sW + W_BYTES, &tm_x, &full[s], k0, m0);
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
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        const uint64_t db = desc_k_sw128(sX + 32 * ks);
        WgmmaS8<BM>::mma(acc[0], af[ks][0], db);
        WgmmaS8<BM>::mma(acc[1], af[ks][1], db);
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
  if (S == 1) {
    if (consumer && n0 + nl < N) {                  // N % 16 == 0: all four or none
      const float4 swn = *reinterpret_cast<const float4*>(sw + n0 + nl);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * tg + e;
          if (m >= M) continue;
          const float am = a[m];
          const int q = 4 * j + e;
          float4 v;
          v.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[0][q]), am), swn.x);
          v.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[0][q + 2]), am), swn.y);
          v.z = __fmul_rn(__fmul_rn(__int2float_rn(acc[1][q]), am), swn.z);
          v.w = __fmul_rn(__fmul_rn(__int2float_rn(acc[1][q + 2]), am), swn.w);
          *reinterpret_cast<float4*>(out + (size_t)m * N + n0 + nl) = v;
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
  if (split == 0) {
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int ml = idx / BN, n = n0 + idx % BN, m = m0 + ml;
      if (m >= M || n >= N) continue;
      int sum = 0;
      for (int r = 0; r < S; ++r) sum += cluster.map_shared_rank(sRed, r)[idx];
      out[(size_t)m * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), a[m]), sw[n]);
    }
  }
  cluster.sync();                        // the leader has read every block's partials
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major int8 matrix, box (box_rows, box_cols = 128 bytes), 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
int launch(const int8_t* qx, const int8_t* qw, const float* a, const float* sw, float* out,
           int M, int N, int K, int splits, cudaStream_t s) {
  CUtensorMap tm_x, tm_w;
  if (!encode(&tm_x, qx, M, K, BM) || !encode(&tm_w, qw, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<BM>();
  cudaError_t err = cudaFuncSetAttribute(qgemm_wgmma_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
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
  err = cudaLaunchKernelEx(&cfg, qgemm_wgmma_kernel<BM>, tm_x, tm_w, a, sw, out, M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// splits: 1..8 and at most ceil(K/128); M >= 1; K and N multiples of 16; qx and qw
// 16-byte aligned. The token tile is M rounded up to 16 for M <= 128, else 128
// rows. The wrapper picks splits (kernels/qgemm.py::wgmma_splits) and checks the rest.
REPRO_API int repro_qgemm_w8a8_wgmma(const int8_t* qx, const int8_t* qw, const float* a,
                                     const float* sw, float* out, int M, int N, int K,
                                     int splits, void* stream) {
  const int KT = (K + BK - 1) / BK;
  if (M < 1 || N < 1 || K < 1 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits || splits > KT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bm = M > 128 ? 128 : (M + 15) / 16 * 16;
  switch (bm) {
    case 16: case 32: case 48: return launch<48>(qx, qw, a, sw, out, M, N, K, splits, s);
    case 64: return launch<64>(qx, qw, a, sw, out, M, N, K, splits, s);
    case 80: return launch<80>(qx, qw, a, sw, out, M, N, K, splits, s);
    case 96: return launch<96>(qx, qw, a, sw, out, M, N, K, splits, s);
    case 112: return launch<112>(qx, qw, a, sw, out, M, N, K, splits, s);
    default: return launch<128>(qx, qw, a, sw, out, M, N, K, splits, s);
  }
}

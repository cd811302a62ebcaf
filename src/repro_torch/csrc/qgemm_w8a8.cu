// K2 qgemm_w8a8, K7 qgemm_w8a8_sparse and K8 qgemm_w4a8: int8 x int8 -> int32
// GEMMs with the separable CrossQuant dequant, one mma.sync kernel body.
//
// Replaces the TPU kernels in repro/kernels/qgemm.py:
//   _w8a8_kernel        (launcher qgemm_w8a8_pallas,        pallas_call at :71)  -> K2
//   _w8a8_sparse_kernel (launcher qgemm_w8a8_sparse_pallas, pallas_call at :149) -> K7
//   _w4a8_kernel        (launcher qgemm_w4a8_pallas,        pallas_call at :209) -> K8
//
// K2:  out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * a[m] * sw[n]
// K7:  the same sum, skipping the (64 x 64) weight tiles an occupancy table marks
//      empty: occ (ceil(K/64), ceil(N/64)) int32, nonzero where the tile holds a
//      surviving weight. Skipping an all-zero int8 tile is exact, and with an
//      all-ones table the step sequence is K2's, so both are bitwise equal to the
//      plain version (the caller guarantees qw is zero wherever occ is 0).
// K8:  qw4 (K/2, N) holds two int4 codes per byte along K (low nibble row 2r, high
//      nibble row 2r + 1, both sign-extended); sw (K/group, N) f32 group scales.
//      out[m, n] = (sum_g float(sum_{k in g} qx[m, k] * w[k, n]) * sw[g, n]) * a[m],
//      the groups summed in order in f32. The plain version sums the groups in
//      PyTorch's order, so K8 against it is f32-close, not bitwise.
//
// qx (M, K) int8 row-major, qw (K, N) int8 row-major (the reference's layout),
// a (M,) f32, sw (N,) f32, out (M, N) f32. The W8 epilogue multiplies in the
// reference's order (acc -> f32, * a, * sw), so the result is bitwise equal to
// the plain version: the int32 sum is exact and every float step is one IEEE
// rounding. Expert-batched K2 (a stacked-expert linear of a shape the decode and
// wgmma bodies do not take): qx (E, M, K), qw (E, K, N), a (E, M), sw (E, N), out
// (E, M, N), expert e on grid z, each block's operands offset to its expert's.
//
// What bounds it on an H100 depends on M. At prefill (M = rows x bucket, up to
// 4096) the work is 2*M*N*K int8 operations against M*K + K*N bytes: operation-
// bound, on the int8 tensor cores. At decode (M = batch size, 4) it reads the
// whole K x N weight to produce 4 rows: byte-bound, and the only gain there is
// to stream the weight at the card's memory rate with enough blocks in flight.
// K8 halves those weight bytes; K7 reads only the occupied tiles' bytes.
//
// Design of this first version: one block computes a 64 x 64 output tile with
// four warps (2 x 2, each 32 x 32) issuing mma.sync.m16n8k32.s8.s8.s32 on the
// tensor cores. Each 64-deep K step stages a qx tile (row-major, k contiguous)
// and a qw tile in shared memory. The B operand of mma.sync is "col" (k
// contiguous per n), so the qw tile is transposed on its way in: each thread
// loads four k-rows of four n-bytes and transposes the 4x4 bytes in registers
// with __byte_perm. K8 loads two packed k-rows instead and sign-extends their
// nibbles into the four int8 k-rows in registers (nibbles_lo / _hi), so the MMA loop is
// K2's; after each group's K steps every thread adds its int32 partials times
// sw[g, n] into f32 registers and clears them, and the epilogue multiplies by a.
// K7 reads its tile's occupancy before each K step; the whole block skips an
// empty step (loads and MMAs), so the branch is uniform. The M, N and K edges
// are masked in the loads (zero codes add nothing to an integer sum) and in the
// epilogue stores; there is no padding.
//
// At decode this body is slow: with M = 4 a 64-row tile wastes 15/16 of the MMA,
// and N/64 blocks (8 for the 512-wide wk/wv) cannot keep 132 SMs streaming. K2,
// K7 and K8 route M <= 32 to the split-K weight stream in qgemm_decode.cu and
// larger M to the wgmma bodies in qgemm_wgmma.cu (K7 through their tile-skipping
// instantiations), and run this body only for shapes those do not take.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;   // 80-byte rows: fragment loads hit 32 distinct banks
constexpr int kThreads = 128;

enum Mode : int { kW8 = 0, kW8Sparse = 1, kW4 = 2 };

// four n-bytes of one weight row (or of one packed int4 row), masked at the N edge
__device__ __forceinline__ unsigned load_row4(const int8_t* src, int gn, int N, int vec_b) {
  if (vec_b && gn + 4 <= N) return *reinterpret_cast<const unsigned*>(src);
  unsigned w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (gn + i < N) w |= (unsigned)(uint8_t)src[i] << (8 * i);
  return w;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
qgemm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
             const float* __restrict__ a, const float* __restrict__ sw,
             const int* __restrict__ occ, float* __restrict__ out, int M, int N, int K,
             int vec_a, int vec_b, int group) {
  __shared__ __align__(16) int8_t sA[BM][LDS];   // [m][k]
  __shared__ __align__(16) int8_t sB[BN][LDS];   // [n][k]: the qw tile, transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;              // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // expert-batched K2 (grid z = E): expert z's (M, K) rows, (K, N) weight, scales
  // and (M, N) output; z = 0 for a 2-D product
  const size_t ez = blockIdx.z;
  qx += ez * M * K;
  qw += ez * K * N;
  a += ez * M;
  sw += ez * N;
  out += ez * M * N;

  int acc[2][4][4];
  float accf[2][4][4];        // K8: the group-dequantized sum
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        accf[i][j][e] = 0.f;
      }

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (MODE == kW8Sparse && occ[(k0 / BK) * gridDim.x + blockIdx.x] == 0) continue;
    // ---- qx tile: 64 rows x 64 bytes, 16 bytes per chunk, two chunks per thread
#pragma unroll
    for (int c = tid; c < BM * BK / 16; c += kThreads) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kc;
      int4 val = make_int4(0, 0, 0, 0);
      if (gm < M) {
        const int8_t* src = qx + (size_t)gm * K + gk;
        if (vec_a && gk + 16 <= K) {
          val = *reinterpret_cast<const int4*>(src);
        } else {
          alignas(16) int8_t tmp[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) tmp[i] = (gk + i < K) ? src[i] : 0;
          val = *reinterpret_cast<const int4*>(tmp);
        }
      }
      *reinterpret_cast<int4*>(&sA[r][kc]) = val;
    }
    // ---- weight tile: 64 k-rows x 64 n-bytes in 4x4-byte blocks, transposed to [n][k]
#pragma unroll
    for (int c = tid; c < (BK / 4) * (BN / 4); c += kThreads) {
      const int kb = (c / (BN / 4)) * 4, nb = (c % (BN / 4)) * 4;
      const int gn = n0 + nb;
      unsigned w[4];
      if (MODE == kW4) {
        // k-rows k0+kb .. +3 are the two packed rows (k0+kb)/2 and +1
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pr = (k0 + kb) / 2 + r;
          const unsigned p = pr < K / 2 ? load_row4(qw + (size_t)pr * N + gn, gn, N, vec_b) : 0u;
          w[2 * r] = nibbles_lo(p);
          w[2 * r + 1] = nibbles_hi(p);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gk = k0 + kb + r;
          w[r] = gk < K ? load_row4(qw + (size_t)gk * N + gn, gn, N, vec_b) : 0u;
        }
      }
      unsigned t[4];
      transpose4x4(w, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) *reinterpret_cast<unsigned*>(&sB[nb + j][kb]) = t[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(&sA[r][kk + tg * 4]);
        af[mi][1] = *reinterpret_cast<const unsigned*>(&sA[r + 8][kk + tg * 4]);
        af[mi][2] = *reinterpret_cast<const unsigned*>(&sA[r][kk + 16 + tg * 4]);
        af[mi][3] = *reinterpret_cast<const unsigned*>(&sA[r + 8][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(&sB[n][kk + tg * 4]);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(&sB[n][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();

    if (MODE == kW4 && (k0 + BK) % group == 0) {
      // end of group k0 / group: f32 += f32(int32 partial) * sw[g, n]; clear
      const float* swg = sw + (size_t)(k0 / group) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + tg * 2 + e;
          const float s = col < N ? swg[col] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int& p = acc[mi][ni][h * 2 + e];
              accf[mi][ni][h * 2 + e] =
                  __fadd_rn(accf[mi][ni][h * 2 + e], __fmul_rn(__int2float_rn(p), s));
              p = 0;
            }
        }
    }
  }

  // ---- epilogue, masked at the M and N edges:
  //      W8: (f32(acc) * a[m]) * sw[n];  W4: accf * a[m]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + h * 8;
        if (r >= M) continue;
        const float ar = a[r];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + tg * 2 + e;
          if (col >= N) continue;
          out[(size_t)r * N + col] =
              MODE == kW4 ? __fmul_rn(accf[mi][ni][h * 2 + e], ar)
                          : __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), ar),
                                      sw[col]);
        }
      }
}

template <int MODE>
int launch(const int8_t* qx, const int8_t* qw, const float* a, const float* sw,
           const int* occ, float* out, int M, int N, int K, int vec_a, int vec_b, int group,
           void* stream, int experts = 1) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, experts);
    qgemm_kernel<MODE><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        qx, qw, a, sw, occ, out, M, N, K, vec_a, vec_b, group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec_a: qx rows may be read as 16-byte vectors (K % 16 == 0, 16-byte aligned);
// vec_b: weight rows as 4-byte words (N % 4 == 0, 4-byte aligned). The wrapper decides.
// experts = E > 1: a stacked-expert linear, qx (E, M, K), qw (E, K, N), a (E, M),
// sw (E, N), out (E, M, N), expert e on grid z.
REPRO_API int repro_qgemm_w8a8(const int8_t* qx, const int8_t* qw, const float* a,
                               const float* sw, float* out, int M, int N, int K, int experts,
                               int vec_a, int vec_b, void* stream) {
  if (experts < 1 || experts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kW8>(qx, qw, a, sw, nullptr, out, M, N, K, vec_a, vec_b, 0, stream, experts);
}

// occ: (ceil(K/64), ceil(N/64)) int32 tile occupancy of qw, row-major.
REPRO_API int repro_qgemm_w8a8_sparse(const int8_t* qx, const int8_t* qw, const float* a,
                                      const float* sw, const int* occ, float* out, int M,
                                      int N, int K, int vec_a, int vec_b, void* stream) {
  if (occ == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kW8Sparse>(qx, qw, a, sw, occ, out, M, N, K, vec_a, vec_b, 0, stream);
}

// qw4: (K/2, N) packed int4; sw: (K/group, N) f32; group a positive multiple of 64
// that divides K.
REPRO_API int repro_qgemm_w4a8(const int8_t* qx, const int8_t* qw4, const float* a,
                               const float* sw, float* out, int M, int N, int K, int group,
                               int vec_a, int vec_b, void* stream) {
  if (group <= 0 || group % BK != 0 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kW4>(qx, qw4, a, sw, nullptr, out, M, N, K, vec_a, vec_b, group, stream);
}

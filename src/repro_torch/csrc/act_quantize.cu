// K1 act_quantize: fused CrossQuant activation quantization (static-c path).
//
// Replaces the TPU kernel repro/kernels/act_quantize.py::_act_quant_kernel
// (launcher act_quantize_pallas, pallas_call at act_quantize.py:89).
//
//   t_i  = max(max_j |x_ij|, 1e-8)                 row absmax, f32
//   a_i  = t_i^alpha / qmax                         row dequant scale
//   q_ij = clip(rint(x_ij / (a_i * bcol_j)), +-qmax) int8 codes
//
// What bounds it on an H100: bytes. Each element is read as bf16/f32 and written
// as one int8 byte with a handful of f32 operations in between, far below the
// ~295 operations per byte where the card turns compute-bound. So x is read from
// device memory once: every design below holds its share of the row in
// registers between the absmax and the quantization (the TPU kernel swept x
// twice), and the (M, K) f32 intermediate never exists.
//
// Three bodies; kernels/act_quantize.py::act_quantize_plan picks one:
// - split (decode and verify, M <= 32): one row per thread-block cluster of S <= 8
//   blocks (grid (M, S), cluster (1, S, 1)), S chosen so that M * S blocks come
//   near one per SM: M = 4 runs 32 blocks, not 4. Block s loads its 1/S of the row
//   (whole 8-element units) into registers with 16-byte loads, reduces its partial
//   absmax (max is exact in any order) into its shared memory; after a cluster
//   barrier one warp reads the S partials through distributed shared memory, and
//   every block forms t and a and quantizes its slice from registers. A second
//   cluster barrier keeps each block's partial alive until every rank has read it.
//   No workspace, no atomics, and a launch replays unchanged under CUDA-graph
//   capture.
// - rows (M > 32): 256 threads hold one row (two rows of 128 threads each where
//   the row fits in 5 units per thread, K <= 5120) in registers: at K = 18432 bf16
//   that is 9 16-byte loads per thread. Four blocks share an SM at bf16 (64
//   registers; three at the 69 the compiler takes unbounded, slower at K = 18432
//   on the H100), so one block's division-heavy quantization overlaps another's
//   loads. The register limit: 16 units of 8 per thread, K <= 32768.
// - sweep: beyond that limit, one block per row reduces, then sweeps the row again
//   (the first design); no serving shape reaches it.
// Given-max mode (a row-parallel linear under tensor parallelism, whose input holds
// K/tp of each row's columns): the caller passes each row's absmax over the whole
// row, the MAX all-reduce of the shards' local maxima. Every body then skips its
// reduction (the split body its cluster barriers too) and takes t_i = max(given_i,
// 1e-8), so the codes and scales are bitwise those of the full row, sliced.
// The two modes compose (expert-batched given-max): under expert-internal tensor
// parallelism a stacked down projection holds d_ff_expert / tp of each expert's
// (e, c) row, and row r reads its expert r / C's factors and the given max tmax[r].
// Expert-batched (a stacked-expert linear, E experts' dispatch buffers of C rows
// each, one launch): every body takes the (E*C, K) rows as they lie and row r reads
// the column factors bcol[r / C] and exponent alpha[r / C] of its expert; the rows
// are independent, so the plan picks the body for E*C rows (granite decode: 40 x
// 8 = 320 rows, the rows body).
// A unit is 8 elements: one 16-byte load of bf16 x or two of f32 x, two float4
// loads of bcol, one 8-byte store of codes. Where K % 8 != 0 or a pointer is not
// aligned for that, the same units are loaded and stored element by element,
// masked at K.
//
// Numerics match the reference exactly: powf for t^alpha; the reference's
// "t^alpha / qmax" is compiled by XLA into a multiply by the constant's f32
// reciprocal, so a = t^alpha * (1/qmax) here too; an IEEE division of x by the
// product a*bcol (a division by a non-constant, which XLA keeps); and rintf,
// which rounds half to even as jnp.round and torch.round do (roundf would not).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnit = 8;            // elements per thread and load step
constexpr int kRowThreads = 256;    // rows body
constexpr int kSplitThreads = 128;  // split body: threads per block of the cluster
constexpr int kMaxSplits = 8;       // a portable cluster
constexpr int kMaxUnits = 16;       // units a thread holds in registers

// a unit of x as it lies in memory: 16 bytes of bf16, 32 of f32
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> { uint4 v; };
template <> struct Raw<float> { float4 lo, hi; };

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, int j, int K, bool vec,
                                         Raw<__nv_bfloat16>& r) {
  if (vec) {
    r.v = *reinterpret_cast<const uint4*>(p + j);
  } else {
    unsigned h[kUnit];
#pragma unroll
    for (int e = 0; e < kUnit; ++e)
      h[e] = j + e < K ? reinterpret_cast<const unsigned short*>(p)[j + e] : 0u;
    r.v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                     h[6] | (h[7] << 16));
  }
}
__device__ __forceinline__ void load_raw(const float* p, int j, int K, bool vec, Raw<float>& r) {
  if (vec) {
    r.lo = *reinterpret_cast<const float4*>(p + j);
    r.hi = *reinterpret_cast<const float4*>(p + j + 4);
  } else {
    float f[kUnit];
#pragma unroll
    for (int e = 0; e < kUnit; ++e) f[e] = j + e < K ? p[j + e] : 0.f;
    r.lo = make_float4(f[0], f[1], f[2], f[3]);
    r.hi = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ void to_floats(const Raw<__nv_bfloat16>& r, float (&f)[kUnit]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void to_floats(const Raw<float>& r, float (&f)[kUnit]) {
  f[0] = r.lo.x; f[1] = r.lo.y; f[2] = r.lo.z; f[3] = r.lo.w;
  f[4] = r.hi.x; f[5] = r.hi.y; f[6] = r.hi.z; f[7] = r.hi.w;
}

template <typename T>
__device__ __forceinline__ float unit_absmax(const Raw<T>& r, float t) {
  float f[kUnit];
  to_floats(r, f);
#pragma unroll
  for (int e = 0; e < kUnit; ++e) t = fmaxf(t, fabsf(f[e]));
  return t;
}

// quantize the unit at element j of a row and store its codes
template <typename T>
__device__ __forceinline__ void quantize_unit(const Raw<T>& r, const float* __restrict__ bcol,
                                              int8_t* __restrict__ qr, int j, int K, bool vec,
                                              float a, float qmax) {
  float f[kUnit], b[kUnit];
  to_floats(r, f);
  if (vec) {
    const float4 b0 = *reinterpret_cast<const float4*>(bcol + j);
    const float4 b1 = *reinterpret_cast<const float4*>(bcol + j + 4);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  } else {
#pragma unroll
    for (int e = 0; e < kUnit; ++e) b[e] = j + e < K ? bcol[j + e] : 1.f;
  }
  unsigned c[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e) {
    float v = rintf(__fdiv_rn(f[e], __fmul_rn(a, b[e])));
    v = fminf(fmaxf(v, -qmax), qmax);
    c[e] = static_cast<unsigned>(static_cast<int>(v)) & 0xFFu;
  }
  if (vec) {
    *reinterpret_cast<uint2*>(qr + j) =
        make_uint2(c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24),
                   c[4] | (c[5] << 8) | (c[6] << 16) | (c[7] << 24));
  } else {
#pragma unroll
    for (int e = 0; e < kUnit; ++e)
      if (j + e < K) qr[j + e] = static_cast<int8_t>(c[e]);
  }
}

__device__ __forceinline__ float row_scale(float t, const float* alpha_ptr, float alpha_val,
                                           float inv_qmax) {
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  return __fmul_rn(powf(t, alpha), inv_qmax);
}

// ---- rows body: ROWS rows per 256-thread block, NV units per thread in registers
template <typename T, int NV, int ROWS>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 2 ? 4 : 2)
act_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ bcol,
                      const float* __restrict__ alpha_ptr, float alpha_val,
                      const float* __restrict__ tmax, int8_t* __restrict__ q,
                      float* __restrict__ a_out, int M, int K, int C, float qmax,
                      float inv_qmax, int vec) {
  constexpr int TPR = kRowThreads / ROWS, WPR = TPR / 32;
  __shared__ float red[kRowThreads / 32];
  const int sub = threadIdx.x / TPR, lt = threadIdx.x % TPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + sub;
  const bool live = row < M;
  const T* xr = x + (size_t)(live ? row : 0) * K;

  Raw<T> r[NV];
  float t = 1e-8f;    // the reference's EPS floor seeds the running max
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = (lt + i * TPR) * kUnit;
    if (live && j < K) {
      load_raw(xr, j, K, vec, r[i]);
      if (tmax == nullptr) t = unit_absmax(r[i], t);
    }
  }
  if (tmax != nullptr) {        // given-max mode: the row max comes from outside
    if (!live) return;
    t = fmaxf(1e-8f, tmax[row]);
  } else {
    t = warp_max(t);
    if (lane == 0) red[warp] = t;
    __syncthreads();
    t = 1e-8f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) t = fmaxf(t, red[sub * WPR + w]);
    if (!live) return;
  }

  const int e = row / C;        // the row's expert (0 for a 2-D activation)
  const float a = row_scale(t, alpha_ptr == nullptr ? nullptr : alpha_ptr + e, alpha_val,
                            inv_qmax);
  if (lt == 0) a_out[row] = a;
  int8_t* qr = q + (size_t)row * K;
  const float* br = bcol + (size_t)e * K;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = (lt + i * TPR) * kUnit;
    if (j < K) quantize_unit(r[i], br, qr, j, K, vec, a, qmax);
  }
}

// ---- split body: one row per cluster of S blocks, NV units per thread in registers
template <typename T, int NV>
__global__ void __launch_bounds__(kSplitThreads)
act_quant_split_kernel(const T* __restrict__ x, const float* __restrict__ bcol,
                       const float* __restrict__ alpha_ptr, float alpha_val,
                       const float* __restrict__ tmax, int8_t* __restrict__ q,
                       float* __restrict__ a_out, int K, int C, float qmax, float inv_qmax,
                       int vec) {
  __shared__ float red[kSplitThreads / 32];
  __shared__ float part;        // this block's absmax, read by every rank of the cluster
  __shared__ float t_row;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // cluster (1, S, 1): a row per cluster, rank == split
  const int row = blockIdx.x, S = gridDim.y, split = blockIdx.y;
  const int units = (K + kUnit - 1) / kUnit, per = (units + S - 1) / S;
  const int u0 = split * per, u1 = min(units, u0 + per);
  const T* xr = x + (size_t)row * K;

  Raw<T> r[NV];
  float t = 1e-8f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = u0 + tid + i * kSplitThreads;
    if (u < u1) {
      load_raw(xr, u * kUnit, K, vec, r[i]);
      if (tmax == nullptr) t = unit_absmax(r[i], t);
    }
  }
  // given-max mode (tmax, uniform over the cluster): no reduction, no cluster barrier
  if (tmax == nullptr) {
    t = warp_max(t);
    if (lane == 0) red[warp] = t;
    __syncthreads();
    if (tid == 0) {
      float p = red[0];
#pragma unroll
      for (int w = 1; w < kSplitThreads / 32; ++w) p = fmaxf(p, red[w]);
      part = p;
    }
    cluster.sync();             // every rank's partial is written (release/acquire)
    if (warp == 0) {
      float p = lane < S ? *cluster.map_shared_rank(&part, lane) : 1e-8f;
      p = warp_max(p);
      if (lane == 0) t_row = p;
    }
    __syncthreads();
  }
  const float trow = tmax != nullptr ? fmaxf(1e-8f, tmax[row]) : t_row;

  const int e = row / C;
  const float a = row_scale(trow, alpha_ptr == nullptr ? nullptr : alpha_ptr + e, alpha_val,
                            inv_qmax);
  if (split == 0 && tid == 0) a_out[row] = a;
  int8_t* qr = q + (size_t)row * K;
  const float* br = bcol + (size_t)e * K;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = u0 + tid + i * kSplitThreads;
    if (u < u1) quantize_unit(r[i], br, qr, u * kUnit, K, vec, a, qmax);
  }
  if (tmax == nullptr) cluster.sync();   // every rank has read this block's partial
}

// ---- sweep body (the first design): one block per row, x read twice
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
act_quant_sweep_kernel(const T* __restrict__ x, const float* __restrict__ bcol,
                       const float* __restrict__ alpha_ptr, float alpha_val,
                       const float* __restrict__ tmax, int8_t* __restrict__ q,
                       float* __restrict__ a_out, int K, int C, float qmax, float inv_qmax) {
  __shared__ float red[kRowThreads / 32];
  const int row = blockIdx.x, e = row / C;
  const T* xr = x + (size_t)row * K;
  int8_t* qr = q + (size_t)row * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float t = 1e-8f;
  if (tmax != nullptr) {
    t = fmaxf(1e-8f, tmax[row]);
  } else {
    for (int j = threadIdx.x; j < K; j += kRowThreads) t = fmaxf(t, fabsf(to_f32(xr[j])));
    t = warp_max(t);
    if (lane == 0) red[warp] = t;
    __syncthreads();
    t = 1e-8f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) t = fmaxf(t, red[w]);
  }

  const float a = row_scale(t, alpha_ptr == nullptr ? nullptr : alpha_ptr + e, alpha_val,
                            inv_qmax);
  if (threadIdx.x == 0) a_out[row] = a;
  const float* br = bcol + (size_t)e * K;
  for (int j = threadIdx.x; j < K; j += kRowThreads) {
    float v = rintf(__fdiv_rn(to_f32(xr[j]), __fmul_rn(a, br[j])));
    v = fminf(fmaxf(v, -qmax), qmax);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
}

// the smallest instantiated units-per-thread count that holds `need` units
int pick_nv(int need) {
  constexpr int kNV[] = {1, 2, 3, 5, 9, kMaxUnits};
  for (int nv : kNV)
    if (need <= nv) return nv;
  return 0;
}

struct Args {
  const void* x;
  const float* bcol;
  const float* alpha_ptr;
  float alpha_val;
  const float* tmax;
  int8_t* q;
  float* a;
  int M, K, C;
  float qmax, inv_qmax;
  int vec;
  cudaStream_t s;
};

template <typename T, int NV, int ROWS>
int launch_rows(const Args& g) {
  act_quant_rows_kernel<T, NV, ROWS><<<(g.M + ROWS - 1) / ROWS, kRowThreads, 0, g.s>>>(
      static_cast<const T*>(g.x), g.bcol, g.alpha_ptr, g.alpha_val, g.tmax, g.q, g.a, g.M, g.K,
      g.C, g.qmax, g.inv_qmax, g.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
int rows_by_nv(const Args& g, int nv) {
  switch (nv) {
    case 1: return launch_rows<T, 1, ROWS>(g);
    case 2: return launch_rows<T, 2, ROWS>(g);
    case 3: return launch_rows<T, 3, ROWS>(g);
    case 5: return launch_rows<T, 5, ROWS>(g);
    case 9: return launch_rows<T, 9, ROWS>(g);
    case kMaxUnits:
      if constexpr (ROWS == 1) return launch_rows<T, kMaxUnits, 1>(g);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_rows_body(const Args& g) {
  // two rows of 128 threads where a row fits in 5 units per thread (K <= 5120)
  const int units = (g.K + kUnit - 1) / kUnit;
  if (units <= 128 * 5) return rows_by_nv<T, 2>(g, pick_nv((units + 127) / 128));
  return rows_by_nv<T, 1>(g, pick_nv((units + kRowThreads - 1) / kRowThreads));
}

template <typename T, int NV>
int launch_split(const Args& g, int splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.M, splits, 1);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.stream = g.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, act_quant_split_kernel<T, NV>, static_cast<const T*>(g.x), g.bcol, g.alpha_ptr,
      g.alpha_val, g.tmax, g.q, g.a, g.K, g.C, g.qmax, g.inv_qmax, g.vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_body(const Args& g, int splits) {
  const int units = (g.K + kUnit - 1) / kUnit, per = (units + splits - 1) / splits;
  switch (pick_nv((per + kSplitThreads - 1) / kSplitThreads)) {
    case 1: return launch_split<T, 1>(g, splits);
    case 2: return launch_split<T, 2>(g, splits);
    case 3: return launch_split<T, 3>(g, splits);
    case 5: return launch_split<T, 5>(g, splits);
    case 9: return launch_split<T, 9>(g, splits);
    case kMaxUnits: return launch_split<T, kMaxUnits>(g, splits);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_body(const Args& g, int body, int splits) {
  if (body == 0) {
    act_quant_sweep_kernel<T><<<g.M, kRowThreads, 0, g.s>>>(
        static_cast<const T*>(g.x), g.bcol, g.alpha_ptr, g.alpha_val, g.tmax, g.q, g.a, g.K,
        g.C, g.qmax, g.inv_qmax);
    return static_cast<int>(cudaGetLastError());
  }
  if (body == 1) return launch_rows_body<T>(g);
  return launch_split_body<T>(g, splits);
}

}  // namespace

REPRO_API const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) f32|bf16 row-major; bcol (K,) f32; alpha from *alpha_ptr when it is
// not null (the prepared tree's per-layer qalpha on the device), else alpha_val.
// Writes q (M, K) int8 and a (M,) f32. body: 0 sweep, 1 rows (K <= 32768), 2 split
// over `splits` (2..8, at most one per 8-element unit) cluster ranks, each slice at
// most 2048 units; the wrapper picks both (kernels/act_quantize.py::act_quantize_plan).
// Expert-batched (a stacked-expert linear): the M rows are E experts' C rows each
// (rows_per_expert = C, M = E*C), bcol is (E, K) and *alpha_ptr (E,): row r takes
// expert r / C's factors. A 2-D activation passes rows_per_expert = M.
// Given-max mode: row_max (M,) f32, when not null, holds each row's absmax taken
// outside (a row-parallel linear's MAX all-reduce of its shards' maxima); the body
// skips its reduction and floors the given max at 1e-8 once. It composes with the
// expert-batched layout (row_max (E*C,), one max per expert row).
REPRO_API int repro_act_quantize(const void* x, int x_dtype, const float* bcol,
                                 const float* alpha_ptr, float alpha_val,
                                 const float* row_max, int8_t* q, float* a, int M, int K,
                                 int rows_per_expert, int bits, int body, int splits,
                                 void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float inv_qmax = 1.0f / qmax;   // correctly rounded, as XLA folds the constant
  if (M <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (rows_per_expert < 1 || M % rows_per_expert != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (K + kUnit - 1) / kUnit;
  if (body < 0 || body > 2 || (body == 1 && units > kRowThreads * kMaxUnits) ||
      (body == 2 && (splits < 2 || splits > kMaxSplits || splits > units ||
                     (units + splits - 1) / splits > kSplitThreads * kMaxUnits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x), bp = reinterpret_cast<uintptr_t>(bcol),
                  qp = reinterpret_cast<uintptr_t>(q);
  const int vec = K % kUnit == 0 && xp % 16 == 0 && bp % 16 == 0 && qp % 8 == 0;
  const Args g{x, bcol, alpha_ptr, alpha_val, row_max, q, a, M, K, rows_per_expert, qmax,
               inv_qmax, vec, static_cast<cudaStream_t>(stream)};
  if (x_dtype == kF32) return launch_body<float>(g, body, splits);
  if (x_dtype == kBF16) return launch_body<__nv_bfloat16>(g, body, splits);
  return static_cast<int>(cudaErrorInvalidValue);
}

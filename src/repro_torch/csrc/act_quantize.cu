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
// ~295 operations per byte where the card turns compute-bound. The design keeps
// the (M, K) f32 intermediate out of device memory, as the TPU kernel did: one
// block per row reduces the absmax in registers and shared memory, then sweeps
// the same row again (an L1/L2 hit for K <= 18432) and writes the codes. The
// ragged K edge is masked by the loop bound; there is no padding of bcol.
//
// Numerics match the reference exactly: powf for t^alpha; the reference's
// "t^alpha / qmax" is compiled by XLA into a multiply by the constant's f32
// reciprocal, so a = t^alpha * (1/qmax) here too; an IEEE division of x by the
// product a*bcol (a division by a non-constant, which XLA keeps); and rintf,
// which rounds half to even as jnp.round and torch.round do (roundf would not).
//
// Later work: vectorized 16-byte loads, several rows per block for decode (M=4
// launches only 4 blocks), and fusing the quantization into the GEMM's A load.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const T* __restrict__ x, const float* __restrict__ bcol,
                 const float* __restrict__ alpha_ptr, float alpha_val,
                 int8_t* __restrict__ q, float* __restrict__ a_out, int K, float qmax,
                 float inv_qmax) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * K;
  int8_t* qr = q + (size_t)row * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float t = 1e-8f;   // the reference's EPS floor seeds the running max
  for (int j = threadIdx.x; j < K; j += kThreads) t = fmaxf(t, fabsf(to_f32(xr[j])));
  t = warp_max(t);
  if (lane == 0) red[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kThreads / 32 ? red[lane] : 1e-8f;
    t = warp_max(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  t = red[0];

  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const float a = __fmul_rn(powf(t, alpha), inv_qmax);
  if (threadIdx.x == 0) a_out[row] = a;
  for (int j = threadIdx.x; j < K; j += kThreads) {
    float v = rintf(__fdiv_rn(to_f32(xr[j]), __fmul_rn(a, bcol[j])));
    v = fminf(fmaxf(v, -qmax), qmax);
    qr[j] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

REPRO_API const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) f32|bf16 row-major; bcol (K,) f32; alpha from *alpha_ptr when it is
// not null (the prepared tree's per-layer qalpha on the device), else alpha_val.
// Writes q (M, K) int8 and a (M,) f32.
REPRO_API int repro_act_quantize(const void* x, int x_dtype, const float* bcol,
                                 const float* alpha_ptr, float alpha_val, int8_t* q,
                                 float* a, int M, int K, int bits, void* stream) {
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float inv_qmax = 1.0f / qmax;   // correctly rounded, as XLA folds the constant
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && K > 0) {
    if (x_dtype == kF32) {
      act_quant_kernel<float><<<M, kThreads, 0, s>>>(
          static_cast<const float*>(x), bcol, alpha_ptr, alpha_val, q, a, K, qmax, inv_qmax);
    } else if (x_dtype == kBF16) {
      act_quant_kernel<__nv_bfloat16><<<M, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), bcol, alpha_ptr, alpha_val, q, a, K, qmax, inv_qmax);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Dense decode / verify attention: the C entry and the launches that keep the rows'
// scores in shared memory. The kernel and its notes are in dense_attention.cuh; the
// launches with the scores in the global scratch are built from
// dense_attention_spill.cu, a source of their own, so that the two halves of the
// instantiations compile in parallel.
#include "dense_attention.cuh"

// q_dtype: kF32 | kBF16; kv_dtype: kF32 | kBF16 | kI8 (k_scale, v_scale then
// required); q_len null at decode (W must be 1); rows: query rows a block holds
// (1 .. 8, kernels/dense_attention.py::dense_plan); scratch: null (the scores in
// shared memory) or (blocks, rows + 1, tpad) f32 for the scores; window <= 0: no
// sliding window; softcap <= 0: none; scale is D^-0.5 rounded to f32 by the caller.
// Every pointer 16-byte aligned (the wrapper passes contiguous tensors).
REPRO_API int repro_dense_attention(const void* q, int q_dtype, const void* k, const void* v,
                                    int kv_dtype, const float* k_scale, const float* v_scale,
                                    const int* cur_len, const int* q_len, void* o,
                                    float* scratch, int B, int W, int H, int Hkv, int T, int D,
                                    int rows, int window, float softcap, float scale,
                                    void* stream) {
  if (B == 0 || W == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || H % Hkv != 0 || T <= 0 || rows < 1 || rows > kMaxRows ||
      (q_len == nullptr && W != 1) || ((kv_dtype == kI8) != (k_scale != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scratch != nullptr
             ? dense_attention_spill(q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, cur_len,
                                     q_len, o, scratch, B, W, H, Hkv, T, rows, scale, window,
                                     softcap, s)
             : dense_dispatch<false>(q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, cur_len,
                                     q_len, o, nullptr, B, W, H, Hkv, T, rows, scale, window,
                                     softcap, s);
}

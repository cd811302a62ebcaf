// Dense decode / verify attention: the launches that keep the rows' scores in the
// global scratch (long caches; kernels/dense_attention.py::dense_plan), built apart
// from dense_attention.cu's so the two halves of the instantiations compile in
// parallel. The kernel and its notes are in dense_attention.cuh.
#include "dense_attention.cuh"

int dense_attention_spill(int q_dtype, int kv_dtype, int D, const void* q, const void* k,
                          const void* v, const float* k_scale, const float* v_scale,
                          const int* cur_len, const int* q_len, void* o, float* scratch, int B,
                          int W, int H, int Hkv, int T, int rows, float scale, int window,
                          float softcap, cudaStream_t s) {
  return dense_dispatch<true>(q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, cur_len, q_len, o,
                              scratch, B, W, H, Hkv, T, rows, scale, window, softcap, s);
}

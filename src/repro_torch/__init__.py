"""PyTorch/CUDA port of the CrossQuant serving system (``repro`` is the JAX reference).

The package mirrors ``repro``'s module layout. It imports torch and numpy only —
never jax, triton or anything under ``repro`` — and its hand-written Hopper
kernels (``csrc/``) are compiled with ``nvcc`` at first use on the card.

float32 matrix products stay full float32 on the card: TF32 is switched off
explicitly for matmuls and cuDNN, so a float32 run means the same numbers as the
CPU reference up to summation order.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

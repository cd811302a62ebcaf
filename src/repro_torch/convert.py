"""Carry a parameter tree from the JAX reference into the port.

The input is the reference's params pytree as nested dicts and lists of numpy
arrays — raw (``repro.models.model.init_params``) or prepared
(``repro.models.quantize.quantize_tree``), e.g. after
``jax.tree_util.tree_map(np.asarray, params)``. The output is the same tree of
torch tensors on ``device``: leaf names (``blocks/0/attn/wq/{qw,sw,bcol,qalpha}``,
``embed/w``, ``final_norm/...``; an MoE's ``blocks/0/moe/router/w``, its stacked
``(n_blocks, E, d_in, d_out)`` experts and its ``shared`` MLP; a Mamba2 layer's
``ssm/{in_proj, out_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale}``; a
hybrid's unstacked ``tail`` list and its ``shared_attn`` block) and the stacked
``(n_blocks, ...)`` layer axis are kept, so the port's model reads it as it reads
its own ``init_params``.
This module takes numpy only; it imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")           # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":         # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device).contiguous()


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays → the same tree of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, dev)

    return conv(tree)


def params_to_numpy(tree):
    """The inverse, for comparisons: tensors → numpy (bf16 widened to f32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

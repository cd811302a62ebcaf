"""Decoding-state layout (port of ``repro/models/state.py``: the attention kind's
dense and paged leaves, ``_attn_dense`` and ``_attn_paged``). SSM state
checkpoints are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def attn_dense(cfg: ModelConfig, batch_size: int, max_len: int, dtype, kv_int8: bool, *,
               device, n_stack: int) -> dict:
    """Slot-table KV leaves stacked over layers: (n_stack, B, T, Hkv, D) K and V,
    as ``dtype`` or as int8 codes with (..., 1) f32 per-token scales."""
    kv_shape = (n_stack, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kv_int8:
        return {"k": z(kv_shape, torch.int8), "v": z(kv_shape, torch.int8),
                "k_scale": z(kv_shape[:4] + (1,), torch.float32),
                "v_scale": z(kv_shape[:4] + (1,), torch.float32)}
    return {"k": z(kv_shape, dtype), "v": z(kv_shape, dtype)}


def attn_paged(cfg: ModelConfig, n_pages: int, page_size: int, dtype, kv_int8: bool, *,
               device, n_stack: int) -> dict:
    """Physical page pools stacked over layers: (n_stack, P, ps, Hkv, D) K and V,
    as ``dtype`` or as int8 codes with (..., 1) f32 per-token scale pools."""
    pool = (n_stack, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kv_int8:
        return {"k_pages": z(pool, torch.int8), "v_pages": z(pool, torch.int8),
                "k_scale_pages": z(pool[:4] + (1,), torch.float32),
                "v_scale_pages": z(pool[:4] + (1,), torch.float32)}
    return {"k_pages": z(pool, dtype), "v_pages": z(pool, dtype)}

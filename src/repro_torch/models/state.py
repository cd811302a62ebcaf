"""Layer-polymorphic decoding-state registry (port of ``repro/models/state.py``).

Every sublayer kind declares, through a :class:`StateSpec`, how its decoding state
is laid out in the two cache layouts:

  dense   per-slot leaves with a ``batch_size`` slot-table axis: attention KV
          rows, or an SSM's recurrent state and pre-conv window.
  paged   fixed-size physical pools addressed through a top-level routing table
          whose ids come from the shared ref-counted ``PagePool``. Attention
          pages hold ``page_size`` tokens of KV (``page_table`` (B, max_len/ps));
          an SSM layer's "page" is one fixed-size checkpoint, its state slab
          plus the K-1-token window, and a slot needs exactly one, shared by all
          its SSM layers (``state_table`` (B,)).

Leaves carry a leading ``(n_stack,)`` layer axis when ``n_stack`` is given (the
stacked ``blocks`` and a hybrid's ``shared`` entry) and none when it is ``None``
(a hybrid's unstacked ``tail``). The SSM state stays f32 whatever the KV dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """How one sublayer kind stores decoding state. ``table``: the cache key of the
    routing table its paged leaves are addressed through. ``paged_kv``: True when
    pages hold per-token KV (page need grows with length), False for fixed-size
    state checkpoints (one page per slot)."""
    kind: str
    table: str
    paged_kv: bool
    dense_leaves: Callable[..., dict]
    paged_leaves: Callable[..., dict]


def _lead(n_stack: Optional[int]) -> tuple:
    return () if n_stack is None else (n_stack,)


def attn_dense(cfg: ModelConfig, batch_size: int, max_len: int, dtype, kv_int8: bool, *,
               device, n_stack: Optional[int] = None) -> dict:
    """Slot-table KV leaves: ([n_stack,] B, T, Hkv, D) K and V, as ``dtype`` or as
    int8 codes with (..., 1) f32 per-token scales."""
    kv_shape = _lead(n_stack) + (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kv_int8:
        return {"k": z(kv_shape, torch.int8), "v": z(kv_shape, torch.int8),
                "k_scale": z(kv_shape[:-1] + (1,), torch.float32),
                "v_scale": z(kv_shape[:-1] + (1,), torch.float32)}
    return {"k": z(kv_shape, dtype), "v": z(kv_shape, dtype)}


def attn_paged(cfg: ModelConfig, n_pages: int, page_size: int, dtype, kv_int8: bool, *,
               device, n_stack: Optional[int] = None) -> dict:
    """Physical page pools: ([n_stack,] P, ps, Hkv, D) K and V, as ``dtype`` or as
    int8 codes with (..., 1) f32 per-token scale pools."""
    pool = _lead(n_stack) + (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kv_int8:
        return {"k_pages": z(pool, torch.int8), "v_pages": z(pool, torch.int8),
                "k_scale_pages": z(pool[:-1] + (1,), torch.float32),
                "v_scale_pages": z(pool[:-1] + (1,), torch.float32)}
    return {"k_pages": z(pool, dtype), "v_pages": z(pool, dtype)}


def _ssm_conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _ssm_leaves(cfg: ModelConfig, rows: int, names, *, device, n_stack,
                heads: Optional[int]) -> dict:
    lead = _lead(n_stack)
    z = lambda shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)  # noqa: E731
    H = cfg.ssm_heads if heads is None else heads
    return {names[0]: z((rows, H, cfg.ssm_head_dim, cfg.ssm_state)),
            names[1]: z((rows, cfg.ssm_conv - 1, _ssm_conv_channels(cfg)))}


def ssm_dense(cfg: ModelConfig, batch_size: int, max_len: int, dtype, kv_int8: bool, *,
              device, n_stack: Optional[int] = None, heads: Optional[int] = None) -> dict:
    """Per-slot recurrent state ([n_stack,] B, H, P, N) and pre-conv window (...,
    B, K-1, C), f32 whatever ``dtype`` and ``kv_int8``. ``heads`` overrides H (a
    rank's heads under a mesh)."""
    return _ssm_leaves(cfg, batch_size, ("state", "conv"), device=device, n_stack=n_stack,
                       heads=heads)


def ssm_paged(cfg: ModelConfig, n_pages: int, page_size: int, dtype, kv_int8: bool, *,
              device, n_stack: Optional[int] = None, heads: Optional[int] = None) -> dict:
    """State-checkpoint pools ([n_stack,] P, H, P, N) and (..., P, K-1, C), f32."""
    return _ssm_leaves(cfg, n_pages, ("state_pages", "conv_pages"), device=device,
                       n_stack=n_stack, heads=heads)


_ATTN = StateSpec(kind="attn", table="page_table", paged_kv=True,
                  dense_leaves=attn_dense, paged_leaves=attn_paged)
_SSM = StateSpec(kind="ssm", table="state_table", paged_kv=False,
                 dense_leaves=ssm_dense, paged_leaves=ssm_paged)

REGISTRY: Dict[str, StateSpec] = {
    "attn": _ATTN,
    "attn_local": _ATTN,
    "attn_moe": _ATTN,
    "ssm": _SSM,
}


def spec_for(kind: str) -> StateSpec:
    return REGISTRY[kind]


def cache_kinds(block_spec) -> list:
    """Every sublayer kind a cache for ``block_spec`` (models.model.BlockSpec) must
    cover, the hybrid's shared attention block included."""
    kinds = list(block_spec.sublayers) + list(block_spec.tail)
    if block_spec.shared_attn:
        kinds.append("attn")
    return kinds


def family_flags(block_spec) -> tuple:
    """(has_paged_kv, has_state_checkpoint): whether a paged cache for
    ``block_spec`` carries token-paged KV pools and fixed-size state pools. A slot
    needs ``ceil(len / page_size)`` KV pages when the first holds, plus exactly
    one state page when the second does."""
    kinds = cache_kinds(block_spec)
    has_kv = any(spec_for(k).paged_kv for k in kinds)
    has_state = any(not spec_for(k).paged_kv for k in kinds)
    return has_kv, has_state

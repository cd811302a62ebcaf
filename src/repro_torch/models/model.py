"""Dense decoder language model (port of ``repro/models/model.py`` for the dense
global-attention family).

Parameters keep the reference's layout: ``blocks`` is a list (one entry per
sublayer kind of the block spec) of dicts whose leaves carry a leading
``(n_blocks, ...)`` layer axis, so a tree converted from ``init_params`` or
``quantize_tree`` output serves unchanged. The layer stack is a Python loop over
that axis; ``unroll`` only selects the per-layer observer names calibration uses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import state as state_lib
from repro_torch.models.layers import (
    QuantContext, attention_apply, init_attention, init_mlp, init_norm, mlp_apply,
    norm_apply,
)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    sublayers: Tuple[str, ...]
    n_blocks: int


def block_spec(cfg: ModelConfig) -> BlockSpec:
    """Dense global attention only: ``[attn] × L``. Other families and layer
    patterns are not ported yet and raise rather than serve them wrongly."""
    if cfg.family != "dense" or cfg.layer_pattern != "global" or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} layer_pattern={cfg.layer_pattern!r} "
            f"frontend={cfg.frontend!r} is not ported yet (dense global decoders only)")
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: untied lm_head is not ported yet")
    return BlockSpec(("attn",), cfg.n_layers)


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random f32 params drawn from ``gen`` on ``device`` (which must match the
    generator's). Same tree and scales as the reference (it cannot reproduce
    ``jax.random`` bits and does not try to)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} cannot fill tensors on {dev}")
    spec = block_spec(cfg)
    L = spec.n_blocks
    embed = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, device=dev) * 0.02
    block = {"norm1": init_norm(cfg, device=dev, n_stack=L),
             "attn": init_attention(gen, cfg, device=dev, n_stack=L),
             "norm2": init_norm(cfg, device=dev, n_stack=L),
             "mlp": init_mlp(gen, cfg, device=dev, n_stack=L)}
    return {"embed": {"w": embed}, "blocks": [block], "final_norm": init_norm(cfg, device=dev)}


def map_tensors(tree, fn):
    """Apply ``fn`` to every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(v, fn) for v in tree]
    return fn(tree)


def layer_slice(tree, i: int):
    """The i-th layer of a stacked (n_blocks, ...) subtree, as views."""
    return map_tensors(tree, lambda t: t[i])


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=torch.bfloat16, *,
               kv_int8: bool = False, device="cuda") -> dict:
    """Dense slot-table cache: per sublayer kind, leaves stacked (n_blocks, B, T,
    ...). ``kv_int8`` stores K/V as int8 codes plus per-token f32 scales."""
    spec = block_spec(cfg)
    dev = resolve_device(device)
    return {"blocks": [state_lib.attn_dense(cfg, batch_size, max_len, dtype, kv_int8,
                                            device=dev, n_stack=spec.n_blocks)
                       for _ in spec.sublayers]}


def _embed(params, batch, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"]["w"][batch["tokens"]]
    if cfg.embed_scale:
        x = x * (cfg.d_model ** 0.5)
    return x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def _lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over cfg.vocab_padded (tied embedding); padded ids carry -1e9."""
    x = norm_apply(params["final_norm"], x, cfg)
    logits = (x @ params["embed"]["w"].T.to(x.dtype)).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits + pad.to(torch.float32) * -1e9
    return logits


def apply(params: dict, batch: dict, cfg: ModelConfig, *,
          ctx: Optional[QuantContext] = None, mode: str = "train",
          caches: Optional[dict] = None, cur_len=None,
          unroll: bool = False) -> Tuple[torch.Tensor, dict]:
    """Returns (logits, {"caches": caches-or-None}).

    mode: train (full logits, no caches) | prefill (writes caches; logits at each
    slot's last valid position) | decode (one token per slot against caches).
    ``cur_len`` is a scalar or (B,) int tensor: prompt lengths of right-padded
    prompts at prefill, post-append lengths at decode. Caches update in place.
    """
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    ctx = ctx or QuantContext(cfg.quant)
    spec = block_spec(cfg)
    x = _embed(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    use_cache = mode in ("prefill", "decode")
    if use_cache and caches is None:
        raise ValueError("prefill/decode need caches (init_cache)")
    if cur_len is not None:
        cur_len = torch.as_tensor(cur_len, device=x.device).reshape(-1).expand(B)

    for b in range(spec.n_blocks):
        # per-layer names /L{b}/S{i}/... are what calibration.stack_tables reads
        bctx = ctx.sub(f"L{b}") if unroll else ctx
        for i in range(len(spec.sublayers)):
            p = layer_slice(params["blocks"][i], b)
            c = layer_slice(caches["blocks"][i], b) if use_cache else None
            sctx = bctx.sub(f"S{i}")
            h, _ = attention_apply(p["attn"], norm_apply(p["norm1"], x, cfg), cfg,
                                   sctx.sub("attn"), cache=c,
                                   cur_len=cur_len if use_cache else None)
            x = x + h
            x = x + mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg), cfg, sctx.sub("mlp"))

    if mode == "prefill":
        if cur_len is None:
            x = x[:, -1:]
        else:
            last = torch.clamp(cur_len.to(torch.int64) - 1, 0, S - 1)
            x = x[torch.arange(B, device=x.device), last][:, None]
    return _lm_head(params, x, cfg), {"caches": caches if use_cache else None}

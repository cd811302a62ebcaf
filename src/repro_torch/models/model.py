"""Decoder language model (port of ``repro/models/model.py``: the dense, ``vlm``,
``audio``, ``moe``, ``ssm`` and ``hybrid`` families, on the dense and paged cache
layouts).

The layer stack is a block spec: a list of sublayer kinds repeated ``n_blocks``
times over stacked parameters.

  dense global        -> [attn] × L
  gemma2 alternating  -> [attn_local, attn] × L/2 (a local sublayer attends a
                         sliding window of ``cfg.window`` keys)
  moe                 -> [attn_moe] × L (attention, then
                         :func:`repro_torch.models.moe.moe_apply`)
  mamba2              -> [ssm] × L (:func:`repro_torch.models.ssm.mamba_apply`)
  zamba2 hybrid       -> ([ssm] × attn_every + shared attention) × L//k, plus an
                         unstacked ssm ``tail`` of L % k layers; the shared
                         attention + MLP block has one set of weights
                         (``shared_attn``), applied after every super-block

Sharded serving runs a rank's shard of the tree under ``ctx.shard`` (a
``sharding.collectives.ShardContext``): the linears by their roles, attention
on the rank's heads, the experts it holds, the vocab-parallel embedding and
head with the collectives that context carries.

Untied heads (``lm_head``) run through the quantized linear; the
``vision_stub``/``audio_stub`` frontends project precomputed patch or frame
features (:mod:`repro_torch.models.frontends`).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.device import resolve_device
from repro_torch.models import frontends
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import state as state_lib
from repro_torch.models.layers import (
    QuantContext, attention_apply, init_attention, init_mlp, init_norm, mlp_apply,
    norm_apply,
)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    sublayers: Tuple[str, ...]       # attn | attn_local | attn_moe | ssm
    n_blocks: int
    tail: Tuple[str, ...] = ()       # unstacked remainder layers (hybrid)
    shared_attn: bool = False        # zamba2: the shared block after each super-block


def block_spec(cfg: ModelConfig) -> BlockSpec:
    """The reference's block spec of ``cfg`` (module docstring)."""
    L = cfg.n_layers
    if cfg.family == "moe":
        return BlockSpec(("attn_moe",), L)
    if cfg.family == "ssm":
        return BlockSpec(("ssm",), L)
    if cfg.family == "hybrid":
        k = cfg.attn_every
        return BlockSpec(("ssm",) * k, L // k, tail=("ssm",) * (L % k), shared_attn=True)
    if cfg.family not in ("dense", "vlm", "audio"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.layer_pattern == "local_global":
        if L % 2:
            raise ValueError(f"{cfg.name}: local_global needs an even n_layers, got {L}")
        return BlockSpec(("attn_local", "attn"), L // 2)
    if cfg.layer_pattern != "global":
        raise ValueError(f"{cfg.name}: unknown layer_pattern {cfg.layer_pattern!r}")
    return BlockSpec(("attn",), L)


def _init_sublayer(gen: torch.Generator, kind: str, cfg: ModelConfig, dev,
                   n_stack: Optional[int]) -> dict:
    if kind == "ssm":
        return {"norm": init_norm(cfg, device=dev, n_stack=n_stack),
                "ssm": ssm_lib.init_mamba(gen, cfg, device=dev, n_stack=n_stack)}
    p = {"norm1": init_norm(cfg, device=dev, n_stack=n_stack),
         "attn": init_attention(gen, cfg, device=dev, n_stack=n_stack),
         "norm2": init_norm(cfg, device=dev, n_stack=n_stack)}
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, device=dev, n_stack=n_stack)
    else:
        p["mlp"] = init_mlp(gen, cfg, device=dev, n_stack=n_stack)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random f32 params drawn from ``gen`` on ``device`` (which must match the
    generator's). Same tree and scales as the reference (it cannot reproduce
    ``jax.random`` bits and does not try to): ``blocks`` stacked, a hybrid's
    ``tail`` a list of unstacked sublayers and its ``shared_attn`` one unstacked
    attention + MLP block. ``device="meta"`` (any generator) gives the tree's
    shapes and dtypes without storage."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} cannot fill tensors on {dev}")
    spec = block_spec(cfg)
    embed = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, device=dev) * 0.02
    params = {"embed": {"w": embed},
              "blocks": [_init_sublayer(gen, kind, cfg, dev, spec.n_blocks)
                         for kind in spec.sublayers],
              "final_norm": init_norm(cfg, device=dev)}
    if spec.tail:
        params["tail"] = [_init_sublayer(gen, kind, cfg, dev, None) for kind in spec.tail]
    if spec.shared_attn:
        params["shared_attn"] = _init_sublayer(gen, "attn", cfg, dev, None)
    if not cfg.tie_embeddings:
        params["lm_head"] = ql.init(gen, cfg.d_model, cfg.vocab_padded, device=dev)
    if cfg.frontend != "none":
        params["frontend"] = frontends.init_frontend(gen, cfg, device=dev)
    return params


def map_tensors(tree, fn, *rest):
    """Apply ``fn`` to every tensor of a nested dict/list tree; with ``rest``
    (trees of the same structure), ``fn(leaf, *their matching leaves)``."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(v, fn, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple tree in the reference's flatten
    order (dict keys sorted, as ``jax.tree_util`` orders them; sequences and
    NamedTuples in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def layer_slice(tree, i: int):
    """The i-th layer of a stacked (n_blocks, ...) subtree, as views."""
    return map_tensors(tree, lambda t: t[i])


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=torch.bfloat16, *,
               kv_int8: bool = False, layout: str = "dense", page_size: int = 16,
               n_pages: Optional[int] = None, device="cuda",
               state_heads: Optional[int] = None) -> dict:
    """Per sublayer kind, the leaves its :mod:`repro_torch.models.state` spec
    builds, stacked (n_blocks, ...) under ``blocks`` (and a hybrid's ``shared``
    attention), unstacked under a hybrid's ``tail``. ``kv_int8`` stores K/V as
    int8 codes plus per-token f32 scales; SSM state stays f32.

    ``layout="dense"``: a slot table, (n_blocks, B, ...) rows per slot.
    ``layout="paged"``: physical pools that slots address through top-level
    routing tables, ``page_table`` (B, max_len // page_size) int32 when the model
    has attention KV and ``state_table`` (B,) int32 when it has SSM state, both
    filled with the invalid sentinel ``n_pages`` (reads clamp, writes drop).
    ``n_pages`` defaults to the dense-equivalent ``batch_size * max_len /
    page_size``; the serving engine owns the tables' contents. ``state_heads``
    sizes the SSM state's head axis (a rank's heads under a mesh; default all)."""
    spec = block_spec(cfg)
    dev = resolve_device(device)
    has_kv, has_state = state_lib.family_flags(spec)
    if layout == "paged":
        if max_len % page_size:
            raise ValueError(f"page_size {page_size} must divide max_len {max_len}")
        n_pages = n_pages or batch_size * (max_len // page_size)
        rows, extent = n_pages, page_size
        leaves = lambda s: s.paged_leaves  # noqa: E731
    elif layout == "dense":
        rows, extent = batch_size, max_len
        leaves = lambda s: s.dense_leaves  # noqa: E731
    else:
        raise ValueError(f"unknown cache layout {layout!r}")

    def one(kind, n_stack):
        spec_ = state_lib.spec_for(kind)
        kw = {} if spec_.paged_kv or state_heads is None else {"heads": state_heads}
        return leaves(spec_)(cfg, rows, extent, dtype, kv_int8, device=dev, n_stack=n_stack,
                             **kw)

    cache = {"blocks": [one(kind, spec.n_blocks) for kind in spec.sublayers]}
    if spec.tail:
        cache["tail"] = [one(kind, None) for kind in spec.tail]
    if spec.shared_attn:
        cache["shared"] = one("attn", spec.n_blocks)
    if layout == "paged":
        if has_kv:
            cache["page_table"] = torch.full((batch_size, max_len // page_size), n_pages,
                                             dtype=torch.int32, device=dev)
        if has_state:
            cache["state_table"] = torch.full((batch_size,), n_pages, dtype=torch.int32,
                                              device=dev)
    return cache


def _lookup(w: torch.Tensor, tokens: torch.Tensor, shard) -> torch.Tensor:
    """Embedding rows of ``tokens``; under a vocab-sharded embedding (``shard``
    with ``embed_split``) each rank holds V/tp rows, looks up the tokens in its
    slice, zeros the others' and the rows SUM across the ranks: exactly one rank
    adds a nonzero row, so the sum is exact."""
    if shard is None or not shard.embed_split:
        return w[tokens]
    v0 = shard.tp_index * w.shape[0]
    local = tokens.to(torch.int64) - v0
    mine = (local >= 0) & (local < w.shape[0])
    rows = w[torch.where(mine, local, 0)] * mine[..., None].to(w.dtype)
    return shard.coll.sum_f32(rows)


def _embed(params, batch, cfg: ModelConfig, shard=None) -> torch.Tensor:
    """Token embeddings (or projected audio frames); under ``vision_stub`` a batch
    carrying ``patch_embeds`` (prefill) has its first ``n_patches`` positions
    replaced by the projected patches. ``embed_scale`` multiplies by sqrt(d_model)
    rounded to the embedding's dtype, as the reference does."""
    if cfg.frontend == "audio_stub":
        x = frontends.audio_stub_apply(params["frontend"], batch["frames"])
    else:
        x = _lookup(params["embed"]["w"], batch["tokens"], shard)
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            x = frontends.vision_stub_apply(params["frontend"], x, batch["patch_embeds"], cfg)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def _lm_head(params, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext) -> torch.Tensor:
    """Logits over cfg.vocab_padded; padded ids carry -1e9. A tied head multiplies
    by the embedding; an untied one runs ``lm_head`` through the top-level ctx's
    linear (under ``mode="int8"`` its fp ``{"w"}`` is prepared on the fly, with the
    column max of this call's rows). Under a vocab-sharded head (``ctx.shard``
    with ``head_split``) each rank computes its vocab slice's logits and they
    are gathered in rank order."""
    x = norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        if ctx.shard is not None and ctx.shard.head_split:
            x = ctx.shard.coll.copy_to(x)           # under autograd: the f op
        logits = x @ params["embed"]["w"].T.to(x.dtype)
    else:
        logits = ctx.linear(params["lm_head"], x, "lm_head")
    logits = logits.to(torch.float32)
    if ctx.shard is not None and ctx.shard.head_split:
        logits = ctx.shard.coll.gather_vocab(logits)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits + pad.to(torch.float32) * -1e9
    return logits


def _apply_sublayer(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                    ctx: QuantContext, *, cache, cur_len, decode, page_table, prefix_len,
                    q_len, chunk, state_table) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One sublayer with its residual; returns (x, the MoE's aux loss or None).
    Caches update in place."""
    if kind == "ssm":
        h, _ = ssm_lib.mamba_apply(p["ssm"], norm_apply(p["norm"], x, cfg), cfg,
                                   ctx.sub("ssm"), cache=cache, decode=decode,
                                   cur_len=cur_len, state_table=state_table)
        return x + h, None
    h, _ = attention_apply(p["attn"], norm_apply(p["norm1"], x, cfg), cfg, ctx.sub("attn"),
                           local=kind == "attn_local", cache=cache, cur_len=cur_len,
                           page_table=page_table, prefix_len=prefix_len, q_len=q_len,
                           chunk=chunk)
    x = x + h
    aux = None
    if kind == "attn_moe":
        h, aux = moe_lib.moe_apply(p["moe"], norm_apply(p["norm2"], x, cfg), cfg,
                                   ctx.sub("moe"))
    else:
        h = mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg), cfg, ctx.sub("mlp"))
    return x + h, aux


def _shared_block(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext, *,
                  cache, cur_len, page_table, prefix_len) -> torch.Tensor:
    """zamba2's weight-shared attention + MLP block, under the names
    ``/shared_attn/...`` and ``/shared_mlp/...`` of ``ctx``."""
    h, _ = attention_apply(p["attn"], norm_apply(p["norm1"], x, cfg), cfg,
                           ctx.sub("shared_attn"), cache=cache, cur_len=cur_len,
                           page_table=page_table, prefix_len=prefix_len)
    x = x + h
    return x + mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg), cfg, ctx.sub("shared_mlp"))


def apply(params: dict, batch: dict, cfg: ModelConfig, *,
          ctx: Optional[QuantContext] = None, mode: str = "train",
          caches: Optional[dict] = None, cur_len=None, prefix_len=None, q_len=None,
          chunk: Optional[dict] = None, unroll: bool = False,
          remat: bool = False, head_rows=None) -> Tuple[torch.Tensor, dict]:
    """Returns (logits, {"aux_loss": scalar, "caches": caches-or-None}); the MoE
    load-balancing loss is summed over the layers (zero without experts).

    ``batch`` holds ``tokens`` (B, S); under ``audio_stub`` ``frames`` (B, S,
    frontend_dim) instead; under ``vision_stub`` a prefill may add
    ``patch_embeds`` (B, n_patches, frontend_dim).

    mode: train (full logits, no caches) | prefill (writes caches; logits at each
    slot's last valid position) | decode (one token per slot against caches) |
    verify (a speculative draft window per slot; logits at every position) |
    chunked (a packed ragged token row; logits at every row).
    ``cur_len`` is a scalar or (B,) int tensor: prompt lengths of right-padded
    prompts at prefill, post-append lengths at decode, total post-scatter
    lengths at verify, where ``q_len`` (B,) counts each slot's valid window rows
    (window token i sits at ``cur_len - q_len + i``). Caches update in place.

    Paged caches carry their ``page_table`` (attention KV) and ``state_table``
    (SSM checkpoints) in the cache dict; each reaches every layer of its kind
    unchanged. SSM and hybrid stacks serve train, prefill and decode; verify and
    chunked raise ``ValueError``, since the recurrence cannot rewind rejected
    tokens or take interleaved chunks. ``prefix_len`` (B,) marks a paged prefill whose
    slots already hold that many shared-prefix tokens: the batch tokens are the
    suffix, positions start at ``prefix_len[b]`` and ``cur_len`` counts suffix
    tokens only.

    ``mode="chunked"``: tokens (1, Nt) are a packed ragged token row mixing many
    slots' work (decode tokens, draft windows, prefill chunks) served in one pass
    against a paged cache. ``chunk`` carries per-slot extents (``q_start``/
    ``q_len``/``kv_len`` (B,)) and per-token routing (``positions``/``slot_ids``
    (Nt,)); logits return for every packed row, (1, Nt, V).

    ``head_rows`` maps the final hidden rows to the rows the head runs on
    (data-parallel serving: every data rank's rows, gathered in slot order, so
    each rank computes the whole batch's logits as one device does).

    ``remat=True`` (training) recomputes each block of the layer loop in the
    backward pass instead of saving its activations
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` around its scan body does; the hybrid tail is not
    rematerialised, as in the reference.
    """
    if mode not in ("train", "prefill", "decode", "verify", "chunked"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    verify = mode == "verify"
    chunked = mode == "chunked"
    if verify and q_len is None:
        raise ValueError("mode='verify' needs q_len (per-slot valid window rows)")
    if q_len is not None and not verify:
        raise ValueError("q_len is only meaningful under mode='verify'")
    if chunked and chunk is None:
        raise ValueError("mode='chunked' needs a chunk dict (per-slot extents + "
                         "per-token routing)")
    if chunk is not None and not chunked:
        raise ValueError("chunk is only meaningful under mode='chunked'")
    if verify and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"speculative verify needs attention-only caches; "
                         f"family {cfg.family!r} carries SSM state")
    if chunked and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"chunked serving needs attention-only caches; "
                         f"family {cfg.family!r} carries SSM state")
    ctx = ctx or QuantContext(cfg.quant)
    spec = block_spec(cfg)
    x = _embed(params, batch, cfg, ctx.shard)
    B, S = x.shape[0], x.shape[1]
    use_cache = mode in ("prefill", "decode", "verify", "chunked")
    if use_cache and caches is None:
        raise ValueError("prefill/decode/verify need caches (init_cache)")
    page_table = caches.get("page_table") if use_cache else None
    state_table = caches.get("state_table") if use_cache else None
    if prefix_len is not None and page_table is None:
        raise ValueError("prefix_len needs a paged cache (its page_table routes the "
                         "shared prefix)")
    as_vec = lambda t: torch.as_tensor(t, device=x.device).reshape(-1).expand(B)  # noqa: E731
    if cur_len is not None:
        cur_len = as_vec(cur_len)
    if prefix_len is not None:
        prefix_len = as_vec(prefix_len)
    if q_len is not None:
        q_len = as_vec(q_len)
    kw = dict(cur_len=cur_len if use_cache else None, decode=mode == "decode",
              page_table=page_table, prefix_len=prefix_len, q_len=q_len, chunk=chunk,
              state_table=state_table)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x: torch.Tensor, b: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        # per-layer names /L{b}/S{i}/... are what calibration.stack_tables reads
        bctx = ctx.sub(f"L{b}") if unroll else ctx
        aux_sum = None                      # the MoE's aux losses; None without experts
        for i, kind in enumerate(spec.sublayers):
            c = layer_slice(caches["blocks"][i], b) if use_cache else None
            x, aux = _apply_sublayer(kind, layer_slice(params["blocks"][i], b), x, cfg,
                                     bctx.sub(f"S{i}"), cache=c, **kw)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        if spec.shared_attn:
            # the top-level ctx: every application observes into one
            # /shared_attn/... and one /shared_mlp/... table
            x = _shared_block(params["shared_attn"], x, cfg, ctx,
                              cache=layer_slice(caches["shared"], b) if use_cache else None,
                              cur_len=kw["cur_len"], page_table=page_table,
                              prefix_len=prefix_len)
        return x, aux_sum

    for b in range(spec.n_blocks):
        if remat:
            x, aux = checkpoint(block, x, b, use_reentrant=False)
        else:
            x, aux = block(x, b)
        if aux is not None:
            aux_total = aux_total + aux
    for i, kind in enumerate(spec.tail):
        x, aux = _apply_sublayer(kind, params["tail"][i], x, cfg, ctx.sub(f"T{i}"),
                                 cache=caches["tail"][i] if use_cache else None, **kw)

    if mode == "prefill":
        if cur_len is None:
            x = x[:, -1:]
        else:
            last = torch.clamp(cur_len.to(torch.int64) - 1, 0, S - 1)
            x = x[torch.arange(B, device=x.device), last][:, None]
    if head_rows is not None:
        x = head_rows(x)
    return _lm_head(params, x, cfg, ctx), {"aux_loss": aux_total,
                                           "caches": caches if use_cache else None}


# ======================================================================================
# Loss
# ======================================================================================

def loss_fn(params, batch, cfg: ModelConfig, *, ctx: Optional[QuantContext] = None,
            remat: bool = True) -> Tuple[torch.Tensor, dict]:
    """Causal-LM (or encoder classification) cross entropy + 0.01 x the MoE aux
    loss, as the reference's: labels are the tokens rolled left with the last
    position masked (an encoder-only config reads ``batch["labels"]``), a
    ``vision_stub`` masks its ``n_patches`` positions, ``batch["loss_mask"]``
    multiplies in. The log-softmax runs over the logits in the dtype the head
    returns. Under a data mesh (``ctx.shard.batch_axes``) ``batch`` is this
    rank's rows and the loss is the whole batch's. Returns (loss, {"ce", "aux",
    "ppl"})."""
    logits, extras = apply(params, batch, cfg, ctx=ctx, mode="train", remat=remat)
    if cfg.is_encoder_only:
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    else:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
        mask[:, -1] = 0.0
        if cfg.frontend == "vision_stub":
            mask[:, :cfg.n_patches] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    aux = extras["aux_loss"]
    sh = ctx.shard if ctx is not None else None
    if sh is not None and sh.batch_axes:
        # a data rank's rows: the numerator and the count SUM across the data
        # ranks (their masks may count unequally), the aux terms average (one
        # token group per rank); the SUM passes each rank's gradient through
        tot = sh.coll.sum_rows(torch.stack([(ll * mask).sum(), mask.sum(), aux]),
                               sh.batch_axes)
        ce = -tot[0] / torch.clamp_min(tot[1], 1.0)
        aux = tot[2] / sh.coll.size_of(sh.batch_axes)
    else:
        ce = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux, "ppl": torch.exp(torch.clamp_max(ce, 20.0))}

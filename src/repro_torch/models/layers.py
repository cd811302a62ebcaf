"""Transformer building blocks (port of ``repro/models/layers.py``, dense and paged
layouts).

Functions over params dicts of tensors. Every quantized linear goes through
:mod:`repro_torch.core.qlinear`. Caches are updated in place (the reference returns
new arrays; here the engine owns one cache and each step writes into it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.core import quantizers as Q

NEG_INF = -1e30


@dataclasses.dataclass
class QuantContext:
    """Threaded through every layer: quant behaviour + (eager) calibration.

    ``int_exec`` picks the backend for prepared integer linears (None/"ref" |
    "dequant" | "kernel"); ``use_kernels=True`` additionally routes prefill
    attention of 128 tokens or more through the flash kernel. ``shard`` (a
    ``sharding.collectives.ShardContext``) marks a rank of sharded serving: its
    params are the rank's shard, and each 2-D linear runs by its role, column-
    or row-parallel, with the collectives the shard context carries.
    ``token_groups`` is the number of data-parallel token groups an MoE
    dispatches apart (the reference's grouped dispatch; one device's training
    step passes the data axes' size, serving and a data mesh's rank 1)."""
    cfg: ql.QuantConfig
    observer: object = None
    prefix: str = ""
    use_kernels: bool = False
    int_exec: Optional[str] = None
    shard: object = None
    token_groups: int = 1

    def sub(self, name: str) -> "QuantContext":
        return QuantContext(self.cfg, self.observer, f"{self.prefix}/{name}",
                            self.use_kernels, self.int_exec, self.shard, self.token_groups)

    def linear(self, params: dict, x: torch.Tensor, name: str) -> torch.Tensor:
        """x @ W of a quantized linear: x (..., d_in) against a 2-D weight, or an
        MoE's (E, C, d_in) dispatch buffer against its (E, d_in, d_out) experts."""
        w = params.get("qw", params.get("qw4", params.get("w")))
        if self.shard is not None and w.ndim == 3 and self.shard.expert_axis is not None:
            return ql.apply_expert_parallel(params, x, self.cfg, self.shard,
                                            self.shard.expert_axis,
                                            use_kernels=self.use_kernels,
                                            int_exec=self.int_exec)
        role = self.shard.role(name) if self.shard is not None and w.ndim == 2 else None
        if self.shard is not None and w.ndim == 3 and self.shard.expert_tp:
            # expert-internal TP: up/gate split d_ff_expert on their output, down on
            # its input
            role = "row" if name == "down" else "col"
        if role == "col":
            x = self.shard.coll.copy_to(x)          # under autograd: the f op
            return ql.apply_column_parallel(params, x, self.cfg, self.shard,
                                            use_kernels=self.use_kernels,
                                            int_exec=self.int_exec)
        if role == "row":
            return ql.apply_row_parallel(params, x, self.cfg, self.shard,
                                         use_kernels=self.use_kernels, int_exec=self.int_exec)
        return ql.apply(params, x, self.cfg, name=f"{self.prefix}/{name}",
                        observer=self.observer, use_kernels=self.use_kernels,
                        int_exec=self.int_exec)


# ======================================================================================
# Norms
# ======================================================================================

def init_norm(cfg: ModelConfig, *, device, n_stack: Optional[int] = None) -> dict:
    shape = (cfg.d_model,) if n_stack is None else (n_stack, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def norm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm (eps 1e-6) or layernorm with the population variance (eps 1e-5),
    computed in f32 and cast back to x's dtype. Served on a card (no autograd)
    through ``F.rms_norm`` / ``F.layer_norm``, whose kernels reduce each row
    within one block: torch's f32 mean splits a row across warps by the number of
    rows, so a data-parallel rank's rows would round otherwise than the same rows
    among one device's (chip_smoke [8] counts both). Training and the CPU keep
    the reference's two-pass form."""
    xf = x.to(torch.float32)
    if xf.is_cuda and not xf.requires_grad:
        d = (xf.shape[-1],)
        if cfg.norm == "rmsnorm":
            y = F.rms_norm(xf, d, params["scale"], eps=1e-6)
        else:
            y = F.layer_norm(xf, d, params["scale"], params["bias"], eps=1e-5)
        return y.to(x.dtype)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
        y = y * params["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ======================================================================================
# RoPE
# ======================================================================================

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, D); positions broadcastable to
    (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                            # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ======================================================================================
# Attention
# ======================================================================================

def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   n_stack: Optional[int] = None) -> dict:
    d = cfg.d_model
    hd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    mk = lambda i, o: ql.init(gen, i, o, n_stack=n_stack, device=device)  # noqa: E731
    return {"wq": mk(d, hd), "wk": mk(d, kvd), "wv": mk(d, kvd), "wo": mk(hd, d)}


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """(Bq, Bk) boolean validity mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _promote(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: Optional[int], softcap: Optional[float],
                        kv_valid_len: Optional[torch.Tensor] = None,
                        q_block: int = 1024, kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks, in plain torch (the reference's
    jnp path for prefill below 128 tokens). q (B, Sq, H, D); k/v (B, Sk, Hkv, D),
    GQA by head-group reshape. Scores are formed in q's dtype, then softmaxed in f32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    pq, pk = (-Sq) % q_block, (-Sk) % kv_block
    qp = F.pad(q, (0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = qp.shape[1] // q_block, kp.shape[1] // kv_block
    qp = qp.reshape(B, nq, q_block, Hkv, G, D)
    kp = kp.reshape(B, nk, kv_block, Hkv, D)
    vp = vp.reshape(B, nk, kv_block, Hkv, D)
    dev = q.device
    base_q = torch.arange(q_block, device=dev)
    base_k = torch.arange(kv_block, device=dev)
    outs = []
    for iq in range(nq):
        qb = qp[:, iq]
        q_pos = iq * q_block + base_q
        m = torch.full((B, Hkv, G, q_block), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, D), dtype=torch.float32, device=dev)
        for jk in range(nk):
            kb, vb = kp[:, jk], vp[:, jk]
            k_pos = jk * kv_block + base_k
            qq, kk = _promote(qb, kb)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qq, kk) * scale
            s = _softcap(s.to(torch.float32), softcap)
            valid = _block_mask(q_pos, k_pos, causal, window) & (k_pos[None, :] < Sk)
            valid = valid[None, None, None]
            if kv_valid_len is not None:
                kvl = kv_valid_len.reshape(-1, 1, 1, 1, 1)
                valid = valid & (k_pos[None, None, None, None, :] < kvl)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])   # (B,Hkv,G,Bq,D)
    out = torch.stack(outs, dim=1)                                # (B,nq,Hkv,G,Bq,D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * q_block, H, D)
    return out[:, :Sq].to(q.dtype)


def kv_quantize(x: torch.Tensor):
    """Per-token int8 KV quantization: one f32 scale per (batch, position, kv
    head). x (B, S, Hkv, D) → (codes int8, scale (B, S, Hkv, 1) f32)."""
    qr = Q.per_token_quant(x.to(torch.float32), 8)
    return qr.codes, qr.scale


def _scale_to_scores(scale: torch.Tensor) -> torch.Tensor:
    """(B, T, Hkv, 1) per-token KV scale → (B, Hkv, 1, T) score-broadcast layout."""
    return scale[..., 0].permute(0, 2, 1)[:, :, None, :]


# --------------------------------------------------------------------- paged KV

def _pool_flat(pool: torch.Tensor) -> torch.Tensor:
    """(P, ps, Hkv, D|1) page pool → (P·ps, Hkv, D|1) flat-position view."""
    return pool.view((pool.shape[0] * pool.shape[1],) + pool.shape[2:])


def _scatter_rows(flat_idx: torch.Tensor, n_rows: int):
    """The rows of a (N,) flat-index write that land inside a pool of ``n_rows``
    positions: (source rows, destination positions). Indices ≥ P·ps (sentinel
    page-table entries, padding rows, verify rows ≥ q_len; an SSM state table's
    sentinel page id) write nowhere. The
    reference's scatter drops them (``mode="drop"``); torch's indexed write on a
    CUDA tensor would fault on them instead, so they are filtered out here."""
    keep = (flat_idx >= 0) & (flat_idx < n_rows)
    src = torch.nonzero(keep).reshape(-1)
    return src, flat_idx[src]


def _pool_scatter(pool: torch.Tensor, route, rows: torch.Tensor) -> None:
    """Write ``rows`` (N, Hkv, D|1) into a (P, ps, Hkv, D|1) pool, in place, along
    a ``route`` from :func:`_scatter_rows`. Pages of other sequences are never
    touched: the engine hands every live position exactly one page slot."""
    src, dst = route
    _pool_flat(pool)[dst] = rows[src].to(pool.dtype)


def _pool_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The logical (B, maxP·ps, Hkv, D|1) view of a pool through the page table.
    Sentinel entries clamp to a valid page; callers mask those positions. Warm
    prefix prefill only: decode and verify read the pool through the paged
    kernel, which never forms this view."""
    P, ps = pool.shape[0], pool.shape[1]
    gidx = (page_table.to(torch.int64)[:, :, None] * ps
            + torch.arange(ps, device=pool.device)[None, None, :])
    gidx = torch.clamp(gidx, 0, P * ps - 1).reshape(page_table.shape[0], -1)
    return _pool_flat(pool)[gidx]


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                            cache: dict, page_table: torch.Tensor, *,
                            prefix_len: torch.Tensor, suffix_len: torch.Tensor,
                            window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    """Suffix prefill against a shared paged prefix (plain torch, as in the
    reference). q/k_new/v_new (B, S, H|Hkv, D) are the right-padded suffix tokens
    with ``suffix_len`` valid per slot; ``prefix_len`` tokens per slot already
    live in the pool. Prefix keys/values are read back from the pool (int8 codes
    times their scale pages); suffix keys use the in-flight fp k/v, so a
    zero-prefix row computes the cold result. Suffix query i sits at absolute
    position ``prefix_len[b] + i``."""
    B, S, H, D = q.shape
    Hkv = k_new.shape[2]
    G = H // Hkv
    kf = _pool_gather(cache["k_pages"], page_table).to(torch.float32)
    vf = _pool_gather(cache["v_pages"], page_table).to(torch.float32)
    if "k_scale_pages" in cache:
        kf = kf * _pool_gather(cache["k_scale_pages"], page_table)
        vf = vf * _pool_gather(cache["v_scale_pages"], page_table)
    T = kf.shape[1]
    pl_ = prefix_len.reshape(-1).to(torch.int64)
    sl = suffix_len.reshape(-1).to(torch.int64)
    ar = torch.arange(S, device=q.device)
    abs_pos = pl_[:, None] + ar[None, :]                               # (B, S)
    over = (ar[None, :] < sl[:, None]) & (abs_pos < T)
    rows, cols = torch.nonzero(over, as_tuple=True)
    kf[rows, abs_pos[rows, cols]] = k_new[rows, cols].to(torch.float32)
    vf[rows, abs_pos[rows, cols]] = v_new[rows, cols].to(torch.float32)

    qg = q.reshape(B, S, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bshgd,bthd->bhgst", qg, kf) * (D ** -0.5)
    s = _softcap(s, softcap)
    k_pos = torch.arange(T, device=q.device)[None, None, :]              # (1, 1, T)
    valid = k_pos <= abs_pos[:, :, None]                                 # causal
    valid = valid & (k_pos < (pl_ + sl)[:, None, None])                  # total length
    if window is not None:
        valid = valid & ((abs_pos[:, :, None] - k_pos) < window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, vf)
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     cur_len: torch.Tensor, window: Optional[int],
                     softcap: Optional[float], k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention against a (B, T, Hkv, D) cache with per-slot valid
    lengths ``cur_len`` (scalar or (B,)). With ``k_scale``/``v_scale`` the cache
    holds int8 codes: the K scale multiplies the score column and the V scale
    folds into the probability row."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    kf = k_cache.to(torch.float32) if k_scale is not None else k_cache
    qq, kk = _promote(qg, kf)
    s = torch.einsum("bhgd,bthd->bhgt", qq, kk) * (D ** -0.5)
    s = s.to(torch.float32)
    if k_scale is not None:
        s = s * _scale_to_scores(k_scale)
    s = _softcap(s, softcap)
    t_pos = torch.arange(k_cache.shape[1], device=q.device)
    cl = cur_len.reshape(-1, 1, 1, 1)
    valid = t_pos[None, None, None, :] < cl
    if window is not None:
        valid &= (cl - 1 - t_pos[None, None, None, :]) < window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        out = torch.einsum("bhgt,bthd->bhgd", p * _scale_to_scores(v_scale),
                           v_cache.to(torch.float32))
    else:
        pp, vv = _promote(p.to(v_cache.dtype), v_cache)
        out = torch.einsum("bhgt,bthd->bhgd", pp, vv)
    return out.reshape(B, 1, H, D).to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     cur_len: torch.Tensor, q_len: torch.Tensor, window: Optional[int],
                     softcap: Optional[float], k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draft-window attention against a dense (B, T, Hkv, D) cache: the W window
    tokens are already scattered, ``cur_len`` is each slot's total post-scatter
    length and ``q_len`` its valid window rows; window token i sits at
    ``cur_len - q_len + i`` and attends keys up to its own position (rows ≥ q_len
    clamp to the newest valid position; their output is discarded). int8-KV
    scales apply where :func:`decode_attention` applies them.
    q (B, W, H, D) → (B, W, H, D)."""
    B, W, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, W, Hkv, G, D)
    kf = k_cache.to(torch.float32) if k_scale is not None else k_cache
    qq, kk = _promote(qg, kf)
    s = torch.einsum("bwhgd,bthd->bhwgt", qq, kk) * (D ** -0.5)
    s = s.to(torch.float32)
    if k_scale is not None:
        s = s * _scale_to_scores(k_scale)[:, :, None]            # (B, Hkv, 1, 1, T)
    s = _softcap(s, softcap)
    cl = cur_len.reshape(-1).to(torch.int64).expand(B)
    qln = q_len.reshape(-1).to(torch.int64).expand(B)
    q_pos = ((cl - qln)[:, None]
             + torch.minimum(torch.arange(W, device=q.device)[None, :], (qln - 1)[:, None]))
    t_pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, None, :]
    qp = q_pos[:, None, :, None, None]
    valid = t_pos <= qp
    if window is not None:
        valid = valid & ((qp - t_pos) < window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        out = torch.einsum("bhwgt,bthd->bwhgd", p * _scale_to_scores(v_scale)[:, :, None],
                           v_cache.to(torch.float32))
    else:
        pp, vv = _promote(p.to(v_cache.dtype), v_cache)
        out = torch.einsum("bhwgt,bthd->bwhgd", pp, vv)
    return out.reshape(B, W, H, D).to(q.dtype)


def _prefill_attention(q, k, v, cfg: ModelConfig, ctx: QuantContext, *,
                       window: Optional[int], seq_lens: Optional[torch.Tensor]):
    """Self-attention over a (right-padded) prefill window: the flash kernel for
    128 tokens or more on the kernel path, else the blockwise online softmax —
    the reference's rule, so served tokens follow the same numerics."""
    S = q.shape[1]
    if ctx.use_kernels and S >= 128:
        from repro_torch.kernels import ops
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), kv_len=seq_lens, causal=cfg.causal,
            window=window, softcap=cfg.attn_softcap)
        return out.transpose(1, 2)
    blk = min(1024, max(S, 16))
    return blockwise_attention(q, k, v, causal=cfg.causal, window=window,
                               softcap=cfg.attn_softcap, kv_valid_len=seq_lens,
                               q_block=blk, kv_block=blk)


def _kv_rows(k: torch.Tensor, v: torch.Tensor, kv_int8: bool) -> dict:
    """The (B, S, Hkv, D|1) K/V rows a cache stores: fp, or int8 codes + scales."""
    if not kv_int8:
        return {"k": k, "v": v}
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _paged_attention(q, k, v, cache: dict, page_table: Optional[torch.Tensor],
                     cfg: ModelConfig, ctx: QuantContext, *, cur_len, prefix_len,
                     window: Optional[int], decode: bool, q_len=None) -> torch.Tensor:
    """Attention against a paged pool: scatter the new K/V through the page table
    (in place), then attend. Decode and verify read the pool through the paged
    kernel (K4/K5 via ``ops``, fp pools and int8 codes + scale pools alike); a cold
    prefill runs exactly the dense prefill attention, a warm one
    :func:`paged_prefill_attention`."""
    from repro_torch.kernels import ops

    if page_table is None:
        raise ValueError("paged cache without a page_table")
    B, S = q.shape[0], q.shape[1]
    kv_int8 = "k_scale_pages" in cache
    P, ps = cache["k_pages"].shape[0], cache["k_pages"].shape[1]
    maxP = page_table.shape[1]
    table = page_table.to(torch.int64)
    ar = torch.arange(S, device=q.device)

    if q_len is not None:
        # draft-window verify: window token i of slot b sits at cur_len - q_len + i
        cl = cur_len.reshape(-1).to(torch.int64).expand(B)
        qln = q_len.reshape(-1).to(torch.int64).expand(B)
        abs_pos = (cl - qln)[:, None] + ar[None, :]                       # (B, S)
        row_valid = ar[None, :] < qln[:, None]
    elif decode:
        cl = cur_len.reshape(-1).to(torch.int64).expand(B)
        abs_pos = torch.clamp(cl - 1, 0, maxP * ps - 1)[:, None]          # (B, 1)
        row_valid = torch.ones_like(abs_pos, dtype=torch.bool)
    else:
        sl = (torch.full((B,), S, device=q.device) if cur_len is None
              else cur_len.reshape(-1).expand(B)).to(torch.int64)
        pl_ = (torch.zeros((B,), dtype=torch.int64, device=q.device) if prefix_len is None
               else prefix_len.reshape(-1).to(torch.int64).expand(B))
        abs_pos = pl_[:, None] + ar[None, :]                              # (B, S)
        row_valid = ar[None, :] < sl[:, None]
    entry = torch.gather(table, 1, torch.clamp(abs_pos // ps, 0, maxP - 1))
    flat = torch.where(row_valid, entry * ps + abs_pos % ps, P * ps).reshape(-1)
    route = _scatter_rows(flat, P * ps)
    merge = lambda t: t.reshape((-1,) + t.shape[2:])  # noqa: E731
    written = {name: merge(rows) for name, rows in _kv_rows(k, v, kv_int8).items()}
    for name, rows in written.items():
        _pool_scatter(cache[f"{name}_pages"], route, rows)
    if ctx.shard is not None and ctx.shard.dp > 1:
        # data-parallel slots: the other data ranks write these rows into their
        # whole pools after the model call (sharding.collectives.exchange_pages)
        ctx.shard.kv_log.append((cache, flat, written))
    scales = dict(k_scale_pages=cache.get("k_scale_pages"),
                  v_scale_pages=cache.get("v_scale_pages"))

    if q_len is not None:
        return ops.paged_verify_attention(q, cache["k_pages"], cache["v_pages"], page_table,
                                          cl, qln, window=window,
                                          softcap=cfg.attn_softcap, **scales)
    if decode:
        return ops.paged_decode_attention(q, cache["k_pages"], cache["v_pages"], page_table,
                                          cl, window=window, softcap=cfg.attn_softcap,
                                          **scales)
    if prefix_len is None:
        # cold admission: exactly the dense prefill attention
        return _prefill_attention(q, k, v, cfg, ctx, window=window,
                                  seq_lens=None if cur_len is None else sl)
    return paged_prefill_attention(q, k, v, cache, page_table, prefix_len=pl_, suffix_len=sl,
                                   window=window, softcap=cfg.attn_softcap)


def _chunked_attention(q, k, v, cache: dict, page_table: torch.Tensor, cfg: ModelConfig,
                       chunk: dict, *, window: Optional[int]) -> torch.Tensor:
    """Packed ragged chunk step: scatter every packed token through the page table
    at its own absolute position (in place), then score the whole ragged block in
    one ``ragged_prefill_attention`` launch (K6). ``chunk`` carries per-slot
    extents (``q_start``/``q_len``/``kv_len`` (B,)) and per-token routing
    (``positions``/``slot_ids`` (Nt,); ``slot_ids == B`` marks a padding row,
    which writes nowhere). Decode rows are one-token chunks; prefill chunks and
    draft windows are longer ones. q/k/v (1, Nt, H|Hkv, D) → (1, Nt, H, D)."""
    from repro_torch.kernels import ops

    B_tab, maxP = page_table.shape
    kv_int8 = "k_scale_pages" in cache
    P, ps = cache["k_pages"].shape[0], cache["k_pages"].shape[1]
    pos = chunk["positions"].reshape(-1).to(torch.int64)
    sid = chunk["slot_ids"].reshape(-1).to(torch.int64)
    entry = page_table.to(torch.int64)[torch.clamp(sid, 0, B_tab - 1),
                                        torch.clamp(pos // ps, 0, maxP - 1)]
    flat = torch.where(sid < B_tab, entry * ps + pos % ps, P * ps)
    route = _scatter_rows(flat, P * ps)
    for name, rows in _kv_rows(k, v, kv_int8).items():
        _pool_scatter(cache[f"{name}_pages"], route, rows[0])
    out = ops.ragged_prefill_attention(
        q[0], k[0], v[0], cache["k_pages"], cache["v_pages"], page_table,
        chunk["q_start"], chunk["q_len"], chunk["kv_len"], chunk_cap=q.shape[1],
        k_scale_pages=cache.get("k_scale_pages"), v_scale_pages=cache.get("v_scale_pages"),
        window=window, softcap=cfg.attn_softcap)
    return out[None]


def attention_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext, *,
                    cache: Optional[dict] = None, cur_len: Optional[torch.Tensor] = None,
                    page_table: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None,
                    q_len: Optional[torch.Tensor] = None,
                    chunk: Optional[dict] = None,
                    local: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """Attention sublayer (causal unless ``cfg.causal`` is False); the cache is
    updated in place. ``local=True`` (gemma2's local sublayers) masks keys
    ``cfg.window`` or more positions behind each query, on every path.

    Dense ``cache`` {"k", "v"[, "k_scale", "v_scale"]}: (B, T, Hkv, D) rows.
    Prefill (S > 1) writes each row's prefix and zeroes the rest; decode (S == 1)
    writes the new token at ``cur_len - 1`` of its own slot, then attends. Paged
    ``cache`` {"k_pages", "v_pages"[, scale pools]} scatters through
    ``page_table`` instead; ``prefix_len`` (B,) marks a suffix prefill against a
    shared paged prefix. ``cur_len`` is a (B,) int tensor: prompt (or suffix)
    lengths at prefill, post-append lengths at decode.

    ``q_len`` (B,) marks a draft-window verify batch: all S window tokens scatter
    (rows ≥ q_len write nowhere) and every window row is scored in one pass;
    ``cur_len`` is then the total post-scatter length, so window token i sits at
    ``cur_len - q_len + i``.

    ``chunk`` marks a packed ragged chunk batch: the S axis is one packed token
    row mixing decode tokens, draft windows and prefill chunks of many slots, each
    token at its own ``chunk["positions"]``; see :func:`_chunked_attention`. Paged
    caches only. Returns (output, cache)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sh = ctx.shard
    if sh is not None:          # this rank's heads (sharding.collectives.ShardContext)
        H, Hkv = sh.q_heads, sh.kv_heads
    q = ctx.linear(params["wq"], x, "wq").reshape(B, S, H, D)
    k = ctx.linear(params["wk"], x, "wk")
    v = ctx.linear(params["wv"], x, "wv")
    if sh is not None and sh.kv_proj_heads != Hkv:
        # tp_kv_rep: whole kv projections; keep the kv heads this rank's queries read
        # (under autograd the slices' gradients sum across the ranks: the f op)
        lo = sh.kv_lo * D
        k, v = sh.coll.copy_to(k), sh.coll.copy_to(v)
        k, v = k[..., lo:lo + Hkv * D], v[..., lo:lo + Hkv * D]
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)

    is_chunked = cache is not None and chunk is not None
    is_verify = cache is not None and q_len is not None and not is_chunked
    is_decode = cache is not None and S == 1 and q_len is None and not is_chunked
    paged = cache is not None and "k_pages" in cache
    if is_chunked and not paged:
        raise ValueError("chunked serving needs a paged cache")
    if is_chunked:
        # every packed token carries its own absolute position
        positions = chunk["positions"].reshape(1, -1)
    elif is_verify:
        # window token i at cur_len - q_len + i; rows ≥ q_len clamp to the newest
        # valid position (their output is discarded)
        ql_ = q_len.reshape(-1, 1)
        positions = ((cur_len.reshape(-1, 1) - ql_)
                     + torch.minimum(torch.arange(S, device=x.device)[None, :], ql_ - 1))
    elif is_decode and cur_len is not None:
        positions = cur_len.reshape(-1, 1) - 1
    elif paged and prefix_len is not None:
        # paged suffix prefill: suffix token i of slot b sits at prefix_len[b] + i
        positions = prefix_len.reshape(-1, 1) + torch.arange(S, device=x.device)[None, :]
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    window = cfg.window if local else None
    if is_chunked:
        out = _chunked_attention(q, k, v, cache, page_table, cfg, chunk, window=window)
        y = ctx.linear(params["wo"], out.reshape(B, S, H * D), "wo")
        return y, cache
    if paged:
        out = _paged_attention(q, k, v, cache, page_table, cfg, ctx, cur_len=cur_len,
                               prefix_len=prefix_len, window=window, decode=is_decode,
                               q_len=q_len if is_verify else None)
        y = ctx.linear(params["wo"], out.reshape(B, S, H * D), "wo")
        return y, cache
    kv_int8 = cache is not None and "k_scale" in cache
    scales = (dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"]) if kv_int8 else {})
    if is_verify:
        # dense draft-window verify: scatter the S window tokens at their absolute
        # positions (rows ≥ q_len write nowhere), then score the window
        cl = cur_len.reshape(-1).to(torch.int64).expand(B)
        qln = q_len.reshape(-1).to(torch.int64).expand(B)
        T = cache["k"].shape[1]
        ar = torch.arange(S, device=x.device)
        idx = torch.clamp((cl - qln)[:, None] + ar[None, :], 0, T - 1)
        rows, cols = torch.nonzero(ar[None, :] < qln[:, None], as_tuple=True)
        for name, val in _kv_rows(k, v, kv_int8).items():
            cache[name][rows, idx[rows, cols]] = val[rows, cols].to(cache[name].dtype)
        out = verify_attention(q, cache["k"], cache["v"], cur_len=cl, q_len=qln,
                               window=window, softcap=cfg.attn_softcap, **scales)
    elif is_decode:
        cl = cur_len.reshape(-1).to(torch.int64).expand(B)
        idx = torch.clamp(cl - 1, 0, cache["k"].shape[1] - 1)
        rows = torch.arange(B, device=x.device)
        for name, val in _kv_rows(k, v, kv_int8).items():
            cache[name][rows, idx] = val[:, 0].to(cache[name].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cur_len=cl, window=window,
                               softcap=cfg.attn_softcap, **scales)
    else:
        seq_lens = None
        if cache is not None and cur_len is not None:
            seq_lens = cur_len.reshape(-1)
        out = _prefill_attention(q, k, v, cfg, ctx, window=window, seq_lens=seq_lens)
        if cache is not None:
            # the in-flight attention above ran on fp k/v; only the stored cache is int8
            for name, val in _kv_rows(k, v, kv_int8).items():
                cache[name][:, :S] = val.to(cache[name].dtype)
                cache[name][:, S:] = 0
    y = ctx.linear(params["wo"], out.reshape(B, S, H * D), "wo")
    return y, cache


# ======================================================================================
# MLP
# ======================================================================================

def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, device,
             n_stack: Optional[int] = None, d_ff: Optional[int] = None) -> dict:
    """An MLP of width ``d_ff`` (default ``cfg.d_ff``; an MoE's shared expert is
    wider)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"up": ql.init(gen, d, f, n_stack=n_stack, device=device),
         "down": ql.init(gen, f, d, n_stack=n_stack, device=device)}
    if cfg.act.endswith("_glu"):
        p["gate"] = ql.init(gen, d, f, n_stack=n_stack, device=device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: QuantContext) -> torch.Tensor:
    up = ctx.linear(params["up"], x, "up")
    if cfg.act == "silu_glu":
        h = F.silu(ctx.linear(params["gate"], x, "gate")) * up
    elif cfg.act == "gelu_glu":
        h = F.gelu(ctx.linear(params["gate"], x, "gate"), approximate="tanh") * up
    elif cfg.act == "gelu":
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu defaults to the tanh form
    elif cfg.act == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(cfg.act)
    return ctx.linear(params["down"], h, "down")

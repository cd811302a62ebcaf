"""Transformer building blocks (port of ``repro/models/layers.py``, dense layout).

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
    "kernel"); ``use_kernels=True`` additionally routes prefill attention of 128
    tokens or more through the flash kernel."""
    cfg: ql.QuantConfig
    observer: object = None
    prefix: str = ""
    use_kernels: bool = False
    int_exec: Optional[str] = None

    def sub(self, name: str) -> "QuantContext":
        return QuantContext(self.cfg, self.observer, f"{self.prefix}/{name}",
                            self.use_kernels, self.int_exec)

    def linear(self, params: dict, x: torch.Tensor, name: str) -> torch.Tensor:
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
    computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
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


def attention_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, ctx: QuantContext, *,
                    cache: Optional[dict] = None,
                    cur_len: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full (global, causal) attention sublayer on the dense slot-table cache.

    ``cache`` {"k", "v"[, "k_scale", "v_scale"]}: (B, T, Hkv, D) rows. Prefill
    (S > 1) writes each row's prefix and zeroes the rest; decode (S == 1) writes
    the new token at ``cur_len - 1`` of its own slot, then attends. ``cur_len``
    is a (B,) int tensor: prompt lengths at prefill, post-append lengths at
    decode. Returns (output, cache), the cache updated in place."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ctx.linear(params["wq"], x, "wq").reshape(B, S, H, D)
    k = ctx.linear(params["wk"], x, "wk").reshape(B, S, Hkv, D)
    v = ctx.linear(params["wv"], x, "wv").reshape(B, S, Hkv, D)

    is_decode = cache is not None and S == 1
    if is_decode and cur_len is not None:
        positions = cur_len.reshape(-1, 1) - 1
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    window = None                    # global layers; local (windowed) ones are not ported
    kv_int8 = cache is not None and "k_scale" in cache
    if is_decode:
        cl = cur_len.reshape(-1).to(torch.int64).expand(B)
        idx = torch.clamp(cl - 1, 0, cache["k"].shape[1] - 1)
        rows = torch.arange(B, device=x.device)
        if kv_int8:
            kq, ks = kv_quantize(k)
            vq, vs = kv_quantize(v)
            cache["k"][rows, idx] = kq[:, 0]
            cache["v"][rows, idx] = vq[:, 0]
            cache["k_scale"][rows, idx] = ks[:, 0]
            cache["v_scale"][rows, idx] = vs[:, 0]
            out = decode_attention(q, cache["k"], cache["v"], cur_len=cl, window=window,
                                   softcap=cfg.attn_softcap, k_scale=cache["k_scale"],
                                   v_scale=cache["v_scale"])
        else:
            cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
            out = decode_attention(q, cache["k"], cache["v"], cur_len=cl, window=window,
                                   softcap=cfg.attn_softcap)
    else:
        seq_lens = None
        if cache is not None and cur_len is not None:
            seq_lens = cur_len.reshape(-1)
        out = _prefill_attention(q, k, v, cfg, ctx, window=window, seq_lens=seq_lens)
        if cache is not None:
            # the in-flight attention above ran on fp k/v; only the stored cache is int8
            if kv_int8:
                kq, ks = kv_quantize(k)
                vq, vs = kv_quantize(v)
                new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            else:
                new = {"k": k, "v": v}
            for name, val in new.items():
                cache[name][:, :S] = val.to(cache[name].dtype)
                cache[name][:, S:] = 0
    y = ctx.linear(params["wo"], out.reshape(B, S, H * D), "wo")
    return y, cache


# ======================================================================================
# MLP
# ======================================================================================

def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, device,
             n_stack: Optional[int] = None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
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

"""Whole-model weight quantization and N:M structured sparsity (port of
``repro/models/quantize.py``: ``quantize_tree``, ``dequantize_tree``,
``fake_quantize_weights``, ``quantized_bytes``, ``parse_nm``, ``SparsityPlan``,
``nm_keep_mask``, ``sparsify_tree``, ``make_sparsity_plan`` and
``sparsity_summary``), and ``with_tile_occupancy``, which routes masked leaves
to the sparse kernel on the card.

The offline PTQ step of a deployment: every quantizable linear becomes its
prepared int8 static-c CrossQuant form (or packed int4 groups at ``w_bits <=
4``); embeddings and norms stay fp. ``sparsify_tree`` prunes prepared or fp
linears to N:M and attaches a bit-packed ``mask`` leaf; ``make_sparsity_plan``
picks the linears to prune by their §4.1 quantization-kernel proportion.

Stacked ``(L, d_in, d_out)`` leaves, and an MoE's ``(L, E, d_in, d_out)``
experts, are prepared and pruned one layer at a time: every step is per layer,
so this equals the stacked call while the f32 temporaries stay one layer large.
An expert stack's calibrated column table is (L, d_in), shared by the layer's
experts; its prepared ``bcol`` is broadcast to (L, E, d_in) and ``qalpha`` is (L,
E). The router stays fp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import qlinear as ql
from repro_torch.core import quantizers as Q

QUANTIZABLE_PARENTS = ("wq", "wk", "wv", "wo", "up", "gate", "down",
                       "in_proj", "out_proj")


def _per_layer(fn, node: dict, *stacked_args):
    """Apply ``fn(layer_node, *layer_args)`` to each layer of a stacked leaf dict
    and stack the results (f32 temporaries one layer large: 10.9 GB would be
    needed at once for a 32-layer 4608x18432 stack)."""
    L = next(iter(node.values())).shape[0]
    parts = [fn({k: v[i] for k, v in node.items()},
                *(None if a is None else a[i] for a in stacked_args))
             for i in range(L)]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def quantize_tree(params, cfg: ql.QuantConfig,
                  tables: Optional[Dict[str, np.ndarray]] = None):
    """Returns a new params tree with prepared linears: int8, or packed int4
    groups when ``cfg.w_bits <= 4``. ``tables``: calibration column absmax per
    linear path (``calibration.stack_tables``); a missing name falls back to
    c=1 (pure per-token row scaling)."""
    tables = tables or {}
    prepare = ql.prepare_int4 if cfg.w_bits <= 4 else ql.prepare_int8

    def convert(node, prefix):
        if isinstance(node, dict):
            if "w" in node and prefix and prefix.split("/")[-1] in QUANTIZABLE_PARENTS:
                w = node["w"]
                if w.ndim >= 2:
                    cmax = node.get("cmax")
                    if cmax is None and prefix in tables:
                        cmax = torch.as_tensor(tables[prefix], device=w.device)
                    if w.ndim >= 3:
                        return _per_layer(lambda n, c: prepare(n, cfg, c), {"w": w}, cmax)
                    return prepare({"w": w}, cfg, cmax)
            return {k: convert(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return node

    return convert(params, "")


def dequantize_tree(qparams, cfg: ql.QuantConfig):
    """Invert :func:`quantize_tree`'s *weight* quantization: every prepared linear
    becomes ``{"w": dequant(q)/b, "cmax": ...}``, an fp tree whose weights carry
    exactly the integer path's weight rounding.

    Served with ``mode="fake", act_quant="crossquant", static_c=True,
    w_prequantized=True`` it is the fake-quant twin of the fused int path: the
    activation fake-quant applies the same ``t_i^α · c_j^(1-α)`` grid the kernels
    use, so logits agree up to f32 association. Leaves prepared without
    calibration (``qalpha == 1``) get ``cmax = 1``: their twin is per-token
    activation quantization. Stacked leaves convert one layer at a time."""
    def one(node):
        b = node["bcol"]
        if "qw" in node:
            wb = node["qw"].to(torch.float32) * node["sw"][..., None, :]
        else:
            wb = ql.dequant_int4_weight(node["qw4"], node["sw"], cfg.w_group)
        alpha = node["qalpha"][..., None]
        denom = torch.where(alpha < 1.0, 1.0 - alpha, torch.ones_like(alpha))
        cmax = torch.where(alpha < 1.0, b ** (1.0 / denom), torch.ones_like(b))
        return {"w": wb / b[..., :, None], "cmax": cmax}

    def convert(node):
        if isinstance(node, dict):
            if "qw" in node or "qw4" in node:
                q = node.get("qw", node.get("qw4"))
                return _per_layer(one, node) if q.ndim >= 3 else one(node)
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return node

    return convert(qparams)


def fake_quantize_weights(params, cfg: ql.QuantConfig):
    """Offline PTQ for the fake-quant evaluation path: every quantizable linear's
    ``w`` becomes its fake-quantized value. Serving with ``cfg.w_prequantized``
    is then identical to in-graph weight fake quantization with no weight-quant
    work per step."""
    def one(w):
        # per_channel and group scales never reach across layers (a flat group
        # stays inside one layer when it divides d_in·d_out), so a stacked leaf
        # quantizes one layer at a time; crossquant_w and awq take statistics
        # over the whole leaf, as the reference does
        per_layer = w.ndim >= 3 and (cfg.w_quant == "per_channel" or (
            cfg.w_quant == "group" and w[0].numel() % cfg.w_group == 0))
        if per_layer:
            return torch.stack([ql._fake_weight(wi, cfg) for wi in w])
        return ql._fake_weight(w, cfg)

    def convert(node, prefix):
        if isinstance(node, dict):
            if ("w" in node and prefix and prefix.split("/")[-1] in QUANTIZABLE_PARENTS
                    and node["w"].ndim >= 2):
                return {**node, "w": one(node["w"])}
            return {k: convert(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return node

    return convert(params, "")


# --------------------------------------------------------------------------------------
# N:M structured sparsity
# --------------------------------------------------------------------------------------

def parse_nm(spec: str) -> Tuple[int, int]:
    """``"2:4"`` -> ``(2, 4)`` (keep n of every m consecutive input channels)."""
    try:
        n, m = (int(p) for p in spec.split(":"))
    except ValueError:
        raise ValueError(f"sparsity spec {spec!r} is not 'N:M'") from None
    if not 0 < n < m:
        raise ValueError(f"sparsity spec {spec!r} needs 0 < N < M")
    return n, m


@dataclasses.dataclass
class SparsityPlan:
    """Which linears to prune, at what N:M, and the §4.1 evidence for the choice.

    ``layers=None`` prunes every eligible leaf; otherwise only the listed leaf
    paths (``blocks/0/attn/wq``). :func:`make_sparsity_plan` lists the layers
    whose CrossQuant quantization-kernel proportion (``fractions``) stays at or
    under ``threshold``: a small kernel says the activation grid already keeps
    the layer's information, so extra weight compression is safest there."""

    nm: Tuple[int, int] = (2, 4)
    layers: Optional[Tuple[str, ...]] = None
    fractions: Dict[str, float] = dataclasses.field(default_factory=dict)
    threshold: float = 0.0

    def wants(self, prefix: str) -> bool:
        return self.layers is None or prefix in self.layers


def nm_keep_mask(score: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Boolean keep-mask holding the top-``n`` scores of every ``m`` consecutive
    input channels (axis -2), independently per output channel. Ties break
    toward the lower channel index (stable sorts), so exactly ``n`` survive per
    group. A trailing remainder when ``d_in % m != 0`` stays dense."""
    *lead, K, N = score.shape
    kg = (K // m) * m
    head = score[..., :kg, :].reshape(*lead, kg // m, m, N)
    order = torch.argsort(-head, dim=-2, stable=True)       # descending in the group
    rank = torch.argsort(order, dim=-2, stable=True)         # each element's rank
    keep = (rank < n).reshape(*lead, kg, N)
    if kg < K:
        tail = torch.ones((*lead, K - kg, N), dtype=torch.bool, device=score.device)
        keep = torch.cat([keep, tail], dim=-2)
    return keep


def _activation_weight(cm, alpha, d_in: int) -> torch.Tensor:
    """Residual activation factor ``c^α`` that turns |wb| (which already carries
    ``c^(1-α)``) into the full |w|·c score; uncalibrated leaves (α=1) get c."""
    cm = torch.clamp_min(torch.as_tensor(cm, dtype=torch.float32), Q.EPS)
    cm = cm.expand(cm.shape[:-1] + (d_in,))
    return cm ** torch.as_tensor(alpha, dtype=torch.float32, device=cm.device)[..., None]


def sparsify_tree(qparams, plan: SparsityPlan,
                  tables: Optional[Dict[str, np.ndarray]] = None):
    """Prune the linears named by ``plan`` to N:M structured sparsity.

    Prepared int8 leaves score ``|qw·sw|`` (times ``c^α`` when calibration
    columns are known), zero the losers, refit ``sw`` to the survivors and
    requantize; fp leaves score ``|w|·cmax`` and zero the pruned weights in
    place. Either way the leaf gains a bit-packed ``mask``. Packed-int4 leaves
    and leaves that already carry a mask pass through untouched. An expert stack
    is pruned per layer, its (d_in,) column table against each expert's
    ``qalpha``; its products stay dense over the zeros, as in the reference."""
    tables = tables or {}
    n, m = plan.nm

    def table_cmax(node, prefix):
        cm = node.get("cmax")
        if cm is None and prefix in tables:
            cm = torch.as_tensor(tables[prefix], device=next(iter(node.values())).device)
        return cm

    def prune_prepared(node, cm):
        qw, sw = node["qw"], node["sw"]
        wb = qw.to(torch.float32) * sw[..., None, :]
        score = wb.abs()
        if cm is not None:
            score = score * _activation_weight(cm, node["qalpha"], qw.shape[-2])[..., :, None]
        mask = nm_keep_mask(score, n, m)
        wbp = torch.where(mask, wb, torch.zeros_like(wb))
        sw2 = torch.clamp_min(wbp.abs().amax(dim=-2), Q.EPS) / Q.qmax(8)
        qw2 = torch.clamp(torch.round(wbp / sw2[..., None, :]), -Q.qmax(8), Q.qmax(8))
        return {**node, "qw": qw2.to(torch.int8), "sw": sw2.to(torch.float32),
                "mask": packing.pack_mask(mask)}

    def prune_fp(node, cm):
        w = node["w"]
        score = w.abs().to(torch.float32)
        if cm is not None:
            score = score * torch.clamp_min(torch.as_tensor(cm, dtype=torch.float32),
                                            Q.EPS)[..., :, None]
        mask = nm_keep_mask(score, n, m)
        return {**node, "w": torch.where(mask, w, torch.zeros_like(w)),
                "mask": packing.pack_mask(mask)}

    def convert(node, prefix):
        if isinstance(node, dict):
            leaf = prefix.split("/")[-1] if prefix else ""
            if leaf in QUANTIZABLE_PARENTS and "mask" not in node and plan.wants(prefix):
                prune = (prune_prepared if "qw" in node
                         else prune_fp if "w" in node and node["w"].ndim >= 2 else None)
                if prune is not None:
                    cm = table_cmax(node, prefix)
                    ref = node["qw" if "qw" in node else "w"]
                    if ref.ndim >= 3:
                        return _per_layer(prune, node, cm)
                    return prune(node, cm)
            return {k: convert(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return node

    return convert(qparams, "")


def make_sparsity_plan(cfg, params, batches: Iterable, *, nm: Tuple[int, int] = (2, 4),
                       threshold: float = 0.05, bits: int = 8, alpha: float = 0.15,
                       ) -> SparsityPlan:
    """Measure each linear's §4.1 quantization-kernel proportion on calibration
    traffic and plan N:M pruning for the layers where it stays at or under
    ``threshold``.

    The proportion is ``|K(Q)| / |X|`` under the CrossQuant grid, averaged over
    ``batches`` (dicts with ``tokens``) in an eager observer pass of fake
    ``W8A8_CROSSQUANT`` mode (``mode="train", unroll=True``, as calibration
    runs); a stacked leaf is gated on its **worst** layer, so one outlier-heavy
    layer keeps the whole leaf dense."""
    from repro_torch.core import kernel_analysis as KA
    from repro_torch.core.calibration import stack_tables
    from repro_torch.models import model as M
    from repro_torch.models.layers import QuantContext

    per_name: Dict[str, list] = {}

    class _Shim:
        def observe(self, name, x):
            x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
            frac = float(KA.crossquant_kernel_fraction(x2, bits=bits, alpha=alpha))
            per_name.setdefault(name, []).append(frac)

    ctx = QuantContext(ql.W8A8_CROSSQUANT, observer=_Shim())
    with torch.no_grad():
        for batch in batches:
            M.apply(params, batch, cfg, ctx=ctx, mode="train", unroll=True)
    stacked = stack_tables({k: np.float32(np.mean(v)) for k, v in per_name.items()})
    fractions = {path: float(np.max(v)) for path, v in stacked.items()}
    layers = tuple(sorted(p for p, f in fractions.items()
                          if f <= threshold and p.split("/")[-1] in QUANTIZABLE_PARENTS))
    return SparsityPlan(nm=nm, layers=layers, fractions=fractions, threshold=threshold)


def with_tile_occupancy(qparams):
    """The tree with an ``occ`` leaf beside every int8 ``mask`` that leaves a
    (64, 64) weight tile empty in some layer: the sparse GEMM's per-layer
    tile-occupancy table (``ops.tile_occupancy``), derived here once per leaf so
    that no serving step syncs the host for it. Expert stacks run the dense
    expert-batched GEMM and get none. On the card a leaf with ``occ``
    runs K7, which skips the empty tiles, and one without runs K2, as the
    reference routes a mask that fills every tile. Derive it after the last edit
    of the codes; a stale ``occ`` is replaced or dropped."""
    from repro_torch.kernels.ops import tile_occupancy

    def convert(node):
        if isinstance(node, dict):
            if "mask" in node and "qw" in node and node["qw"].ndim <= 3:   # not experts
                rest = {k: v for k, v in node.items() if k != "occ"}
                K, mask = node["qw"].shape[-2], node["mask"]
                occ = (torch.stack([tile_occupancy(m, K) for m in mask]) if mask.ndim == 3
                       else tile_occupancy(mask, K))
                return rest if bool(occ.all()) else {**rest, "occ": occ}
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return node

    return convert(qparams)


_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def _popcount(packed: torch.Tensor, chunk: int = 1 << 24) -> int:
    """Set bits of a packed mask (its pad bits are zero: the survivor count),
    a byte lookup over slices so a full-width stack needs no 8x temporary."""
    flat = packed.reshape(-1)
    table = _POPCOUNT.to(flat.device)
    return sum(int(table[flat[i:i + chunk].long()].sum())
               for i in range(0, flat.numel(), chunk))


def sparsity_summary(qparams) -> Dict[str, float]:
    """``{leaf path: kept fraction}`` for every masked leaf (popcount / elements)."""
    out: Dict[str, float] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if "mask" in node:
                ref = node["qw"] if "qw" in node else node["w"]
                out[prefix] = _popcount(node["mask"]) / ref.numel()
                return
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")

    walk(qparams, "")
    return out


def quantized_bytes(params, *, deploy_sparse: bool = False) -> int:
    """Total bytes of every tensor leaf: codes and scale/aux leaves alike.

    ``deploy_sparse=True`` costs each masked int8 leaf at its N:M deployment
    size, its surviving codes (the mask's popcount) plus the packed mask,
    instead of the dense zero-carrying layout stored here."""
    if isinstance(params, dict):
        if deploy_sparse and "qw" in params and "mask" in params:
            aux = sum(quantized_bytes(v, deploy_sparse=True)
                      for k, v in params.items() if k != "qw")
            return aux + _popcount(params["mask"]) * params["qw"].element_size()
        return sum(quantized_bytes(v, deploy_sparse=deploy_sparse) for v in params.values())
    if isinstance(params, list):
        return sum(quantized_bytes(v, deploy_sparse=deploy_sparse) for v in params)
    return params.numel() * params.element_size()


def pad_head_params(params, cfg_from, cfg_to):
    """Transplant params into a head-padded layout (``configs.with_padded_heads``).

    Padding is per kv group (GQA maps head h to kv group h // G, so heads
    appended at the tail would move existing heads to other groups): each group
    gains zero q-columns (padded heads emit q = 0) and zero wo-rows (padded heads
    contribute nothing), so the padded model computes the same function while its
    attention projections divide the TP degree."""
    dh = cfg_to.head_dim
    hkv = cfg_from.n_kv_heads
    g0 = cfg_from.n_heads // hkv
    g1 = cfg_to.n_heads // hkv
    assert dh == cfg_from.head_dim and cfg_to.n_kv_heads == hkv
    if g0 == g1:
        return params

    def pad_wq(w):            # (..., d, H0*dh) -> (..., d, H1*dh)
        lead = w.shape[:-1]
        wg = w.reshape(*lead, hkv, g0, dh)
        z = torch.zeros(*lead, hkv, g1 - g0, dh, dtype=w.dtype, device=w.device)
        return torch.cat([wg, z], dim=-2).reshape(*lead, hkv * g1 * dh)

    def pad_wo(w):            # (..., H0*dh, d) -> (..., H1*dh, d)
        lead, d_out = w.shape[:-2], w.shape[-1]
        wg = w.reshape(*lead, hkv, g0, dh, d_out)
        z = torch.zeros(*lead, hkv, g1 - g0, dh, d_out, dtype=w.dtype, device=w.device)
        return torch.cat([wg, z], dim=-3).reshape(*lead, hkv * g1 * dh, d_out)

    def convert(node, parent=""):
        if isinstance(node, dict):
            if parent == "wq" and "w" in node:
                return {**node, "w": pad_wq(node["w"])}
            if parent == "wo" and "w" in node:
                return {**node, "w": pad_wo(node["w"])}
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, parent) for v in node]
        return node

    return convert(params)

"""The training step (port of ``repro/training/trainer.py``): microbatched
gradient accumulation over the loss, each block of the layer loop recomputed in
the backward pass (remat), then the AdamW update.

The linears run in plain torch (``use_kernels=False``), as the reference builds
its training context with ``use_pallas=False``: the hand-written kernels have no
backward and refuse inputs that require grad. The reference's
``hints.constrain_microbatches`` lays microbatches out over a mesh; on one device
there is nothing to lay out.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import qlinear as ql
from repro_torch.models import model as M
from repro_torch.models.model import leaves, map_tensors
from repro_torch.models.layers import QuantContext
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib


def pick_n_micro(cfg: ModelConfig, global_batch: int, dp: int) -> int:
    """Microbatch count heuristic: keep the per-replica microbatch small enough that
    activations and f32 logits fit; MoE and wide or large-vocabulary models take
    one sequence per microbatch."""
    local = max(1, global_batch // dp)
    target_local_mb = 1 if (cfg.d_model >= 4096 or cfg.vocab >= 128000
                            or cfg.n_experts) else 4
    n_micro = max(1, local // target_local_mb)
    while global_batch % (n_micro * dp) and n_micro > 1:
        n_micro -= 1
    while global_batch % n_micro:
        n_micro -= 1
    return n_micro


def _value_and_grad(loss, params, batch):
    """(loss, grads) of ``loss(params, batch)`` with respect to every leaf; the
    params are not modified (the graph runs on detached aliases of them). A leaf
    the loss does not reach gets zeros, as ``jax.grad`` gives."""
    flat = leaves(params)
    alias = {id(p): p.detach().requires_grad_() for p in flat}
    value, _ = loss(map_tensors(params, lambda p: alias[id(p)]), batch)
    got = torch.autograd.grad(value, [alias[id(p)] for p in flat], allow_unused=True)
    grads = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)}
    return value.detach(), map_tensors(params, lambda p: grads[id(p)])


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig, n_micro: int = 1,
                    quant: Optional[ql.QuantConfig] = None,
                    compression: Optional[comp_lib.CompressionConfig] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; with ``compression`` set, ``train_step(params, opt_state,
    err_state, batch) -> (params, opt_state, err_state, metrics)``: gradients are
    int8-compressed (CrossQuant geometry + error feedback) before the optimizer.

    ``batch`` is a dict of tensors on the params' device with a leading batch axis
    that ``n_micro`` divides. Microbatch gradients accumulate in f32 and are
    divided by ``n_micro``; ``metrics["loss"]`` is the mean microbatch loss. The
    params and the optimizer state are updated in place and returned
    (:func:`repro_torch.training.optimizer.apply_updates`)."""
    ctx = QuantContext(quant or cfg.quant, use_kernels=False)

    def loss(params, mb):
        return M.loss_fn(params, mb, cfg, ctx=ctx, remat=True)

    def train_step(params, opt_state, batch, err_state=None):
        if n_micro > 1:
            gsum, lsum = None, None
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
                      for k, v in batch.items()}
                value, grads = _value_and_grad(loss, params, mb)
                if gsum is None:
                    gsum = map_tensors(grads, lambda g: g.to(torch.float32))
                    lsum = value
                else:
                    for a, g in zip(leaves(gsum), leaves(grads)):
                        a.add_(g)
                    lsum = lsum + value
                del grads
            for g in leaves(gsum):
                g.div_(n_micro)
            grads, mean_loss = gsum, lsum / n_micro
        else:
            mean_loss, grads = _value_and_grad(loss, params, batch)

        if compression is not None:
            grads, err_state = comp_lib.compress_grads(grads, err_state, compression)

        new_params, new_opt, om = opt_lib.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = {"loss": mean_loss, **om}
        if compression is not None:
            return new_params, new_opt, err_state, metrics
        return new_params, new_opt, metrics

    if compression is not None:
        def train_step_c(params, opt_state, err_state, batch):
            return train_step(params, opt_state, batch, err_state)
        return train_step_c
    return train_step


def make_eval_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None):
    """``eval_step(params, batch) -> metrics`` ({"ce", "aux", "ppl"}) without remat
    or gradients."""
    ctx = QuantContext(quant or cfg.quant)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = M.loss_fn(params, batch, cfg, ctx=ctx, remat=False)
        return metrics

    return eval_step

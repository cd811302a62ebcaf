"""The training step (port of ``repro/training/trainer.py``): microbatched
gradient accumulation over the loss, each block of the layer loop recomputed in
the backward pass (remat), then the AdamW update, on one device or on a (data,
model) mesh of ``torch.distributed`` ranks.

The linears run in plain torch (``use_kernels=False``), as the reference builds
its training context with ``use_pallas=False``: the hand-written kernels have no
backward and refuse inputs that require grad.

On a mesh (``layout``, ``training.layout.TrainLayout``) a rank holds its FSDP
shard of the params and of both moments (the planner's training placements) and
computes Megatron-style on its model-axis slice. Each step it gathers its
compute slices once, runs every microbatch's forward and backward on its rows
of it (the reference's ``hints.constrain_microbatches`` layout) with the shard
context in its ``QuantContext`` (the loss is the whole batch's, an MoE's rows
one token group of it), SUMs the accumulated gradients over the data axes,
keeps its shard, and applies AdamW to its shards with the whole tree's clip
norm. Gradient compression runs on the data-summed gradient of each whole leaf
before the shard is taken, so its codes are one device's.
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
                    compression: Optional[comp_lib.CompressionConfig] = None, *,
                    mesh=None, plan=None, token_groups: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; with ``compression`` set, ``train_step(params, opt_state,
    err_state, batch) -> (params, opt_state, err_state, metrics)``: gradients are
    int8-compressed (CrossQuant geometry + error feedback) before the optimizer.

    ``batch`` is a dict of tensors on the params' device with a leading batch axis
    that ``n_micro`` divides. Microbatch gradients accumulate in f32 and are
    divided by ``n_micro``; ``metrics["loss"]`` is the mean microbatch loss. The
    params and the optimizer state are updated in place and returned
    (:func:`repro_torch.training.optimizer.apply_updates`). ``token_groups``: an
    MoE's grouped dispatch on one device (the reference's under a data axis of
    that size).

    ``mesh`` (``launch.mesh.Mesh``) runs the step on it under ``plan`` (default
    ``make_plan(cfg, ShapeConfig(kind="train"), mesh)``), through the returned
    step's ``layout`` (``training.layout.TrainLayout``; None on one device):
    ``params`` and ``opt_state`` are this rank's shards (``step.layout.shard``),
    ``batch`` the global batch (``n_micro`` times the data ranks divide it),
    ``err_state`` ``step.layout.init_error_state``; the metrics are the whole
    batch's on every rank. Raises the planner's ``ShardedTrainingError`` for the
    cases it leaves out."""
    quant = quant or cfg.quant
    ctx = QuantContext(quant, use_kernels=False, token_groups=token_groups)
    layout = None
    if mesh is not None:
        from repro_torch.sharding.planner import check_train
        from repro_torch.training.layout import train_layout
        layout = train_layout(cfg, mesh, plan)
        check_train(cfg, layout.plan, mesh, quant, compression)
        ctx = QuantContext(quant, use_kernels=False, shard=layout.shard_ctx)

    def loss(params, mb):
        return M.loss_fn(params, mb, cfg, ctx=ctx, remat=True)

    def train_step(params, opt_state, batch, err_state=None):
        if layout is None and n_micro == 1:
            mean_loss, grads = _value_and_grad(loss, params, batch)
        else:
            compute = layout.gather(params) if layout is not None else params
            gsum, lsum = None, None
            for i in range(n_micro):
                mb = (layout.rows(batch, i, n_micro) if layout is not None
                      else _rows(batch, i, n_micro))
                value, grads = _value_and_grad(loss, compute, mb)
                if gsum is None:
                    gsum = map_tensors(grads, lambda g: g.to(torch.float32))
                    lsum = value
                else:
                    for a, g in zip(leaves(gsum), leaves(grads)):
                        a.add_(g)
                    lsum = lsum + value
                del grads
            if n_micro > 1:
                for g in leaves(gsum):
                    g.div_(n_micro)
            grads, mean_loss = gsum, lsum / n_micro
            del compute

        if layout is not None:
            layout.sum_grads(grads)
        if compression is not None:
            grads, err_state = comp_lib.compress_grads(grads, err_state, compression)
        if layout is not None:
            grads = layout.to_shards(grads)

        new_params, new_opt, om = opt_lib.apply_updates(params, grads, opt_state, opt_cfg,
                                                        layout=layout)
        metrics = {"loss": mean_loss, **om}
        if compression is not None:
            return new_params, new_opt, err_state, metrics
        return new_params, new_opt, metrics

    if compression is not None:
        def train_step_c(params, opt_state, err_state, batch):
            return train_step(params, opt_state, batch, err_state)
        train_step_c.layout = layout
        return train_step_c
    train_step.layout = layout
    return train_step


def _rows(batch, i: int, n_micro: int):
    """Microbatch ``i`` of ``batch``: rows [i·B/n_micro, (i+1)·B/n_micro)."""
    return {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_eval_step(cfg: ModelConfig, quant: Optional[ql.QuantConfig] = None):
    """``eval_step(params, batch) -> metrics`` ({"ce", "aux", "ppl"}) without remat
    or gradients."""
    ctx = QuantContext(quant or cfg.quant)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = M.loss_fn(params, batch, cfg, ctx=ctx, remat=False)
        return metrics

    return eval_step

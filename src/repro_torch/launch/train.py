"""Training launcher (port of ``repro/launch/train.py``): data → train loop →
checkpoints → fault-tolerant supervision, on one device or on a (data, model)
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 100 --global-batch 8 --seq-len 256 --ckpt-every 25
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke \\
        --device cpu --steps 12 --fail-at 6      # plain torch on the CPU
    PYTHONPATH=src torchrun --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.train --arch starcoder2-7b --smoke --mesh 2,1 \\
        --device cpu --steps 8 --global-batch 4 --n-micro 2

The flags are the reference's, plus ``--device`` (default ``cuda``, which raises
without a card) and ``--mesh DATA,MODEL``: one process per rank under
``torchrun``, FSDP over the data axis and tensor parallelism over the model axis
(``training.layout``), with gloo on the CPU or with more ranks than cards and
NCCL with a card per rank; rank 0 prints and writes the checkpoints (the
logical arrays, restorable on any mesh). ``--shape`` takes the global batch and
sequence length from ``SHAPES``. The reference's ``--production`` (the TPU pod
mesh) is not ported. Checkpoints resume: a ``--ckpt-dir`` holding a committed
step starts from it.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get
from repro_torch.configs.base import ModelConfig
from repro_torch.data import make_train_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime import FailureInjector, RunResult, Supervisor
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib, trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 CrossQuant gradient compression + error feedback")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject WorkerFailure at these steps (chaos testing)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES),
                    help="take --global-batch and --seq-len from this named shape")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train sharded over this mesh, one process per rank (torchrun)")
    return ap.parse_args(argv)


def run(cfg: ModelConfig, *, steps: int = 50, global_batch: int = 8, seq_len: int = 128,
        n_micro: int = 1, lr: float = 3e-3, ckpt_dir: str, ckpt_every: int = 25,
        seed: int = 0, compress_grads: bool = False, fail_at: Sequence[int] = (),
        log_every: int = 10, device="cuda", mesh=None) -> RunResult:
    """Train ``cfg`` from seeded params for ``steps`` steps under the supervisor,
    checkpointing to ``ckpt_dir`` every ``ckpt_every`` steps; ``fail_at`` injects a
    worker failure at those steps. Returns the supervisor's result; its
    ``state["params"]`` is the trained tree (this rank's shards on a ``mesh``,
    ``launch.mesh.Mesh``: every rank builds the same seeded tree and keeps its
    shards)."""
    dev = resolve_device(device)
    opt_cfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    compression = comp_lib.CompressionConfig() if compress_grads else None
    train_step = trainer.make_train_step(cfg, opt_cfg, n_micro=n_micro,
                                         compression=compression,
                                         mesh=mesh if mesh is not None and mesh.size > 1
                                         else None)
    layout = train_step.layout
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = M.init_params(gen, cfg, device=dev)
    if layout is not None:
        params = layout.shard(params)
    state = {"params": params, "opt": opt_lib.init(params)}
    if compression:
        state["err"] = (comp_lib.init_error_state(params) if layout is None
                        else layout.init_error_state(dev))
    batch_fn = make_train_batches(cfg.vocab, seq_len, global_batch, seed=seed)
    ckpt = CheckpointManager(ckpt_dir, keep_n=3, mesh=mesh,
                             placements=None if layout is None
                             else layout.state_placements(state))
    lead = layout is None or mesh.rank == 0
    t_last = time.time()

    def step_fn(state, step):
        nonlocal t_last
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_fn(step).items()}
        if compression:
            p, o, e, metrics = train_step(state["params"], state["opt"], state["err"], batch)
            new_state = {"params": p, "opt": o, "err": e}
        else:
            p, o, metrics = train_step(state["params"], state["opt"], batch)
            new_state = {"params": p, "opt": o}
        loss = float(metrics["loss"])
        if step % log_every == 0 and lead:
            dt = time.time() - t_last
            t_last = time.time()
            print(f"step {step:5d} loss={loss:.4f} ppl={math.exp(min(loss, 20.0)):.2f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} ({dt:.1f}s)")
        return new_state, {"loss": loss}

    sup = Supervisor(ckpt, ckpt_every=ckpt_every)
    injector = FailureInjector(fail_at_steps=tuple(fail_at)) if fail_at else None
    start = ckpt.latest_step() or 0
    if start:
        if lead:
            print(f"resuming from checkpoint step {start}")
        state, start = ckpt.restore(state)
    result = sup.run(state, step_fn, steps, start_step=start, injector=injector)
    if lead:
        print(f"done: step={result.step} restarts={result.restarts} "
              f"final_loss={result.metrics_history[-1]['loss']:.4f}"
              + ("" if layout is None else f" mesh={dict(mesh.shape)} "
                 f"tier={layout.plan.tier} moe_mode={layout.plan.moe_mode}"))
    return result


def main(argv: Optional[Sequence[str]] = None) -> RunResult:
    args = parse_args(argv)
    if args.shape:
        args.global_batch, args.seq_len = SHAPES[args.shape].global_batch, \
            SHAPES[args.shape].seq_len
    device, mesh = args.device, None
    if args.mesh is not None:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_debug_mesh
        try:
            dims = [int(x) for x in args.mesh.split(",")]
            if len(dims) != 2 or min(dims) < 1:
                raise ValueError(args.mesh)
        except ValueError:
            raise SystemExit(f"--mesh expects DATA,MODEL (e.g. --mesh 2,1 or --mesh 1,2), "
                             f"got {args.mesh!r}")
        device = resolve_device(device)
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            device = resolve_device(f"cuda:{local % torch.cuda.device_count()}")
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            shared = device.type == "cpu" or ranks > torch.cuda.device_count()
            dist.init_process_group("gloo" if shared else "nccl")
        mesh = make_debug_mesh(*dims)
    result = run(get(args.arch, smoke=args.smoke), steps=args.steps,
                 global_batch=args.global_batch, seq_len=args.seq_len, n_micro=args.n_micro,
                 lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 seed=args.seed, compress_grads=args.compress_grads, fail_at=args.fail_at,
                 log_every=args.log_every, device=device, mesh=mesh)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()

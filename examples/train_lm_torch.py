"""End-to-end training on the PyTorch port: data pipeline → supervised train loop
with an injected failure → checkpoint restart → post-training quantization of the
result with CrossQuant, held-out perplexity compared (the flow of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # smoke config
    PYTHONPATH=src python examples/train_lm_torch.py                # on the card

On the card (the default) it trains ``--arch`` at full width; ``--device cpu``
trains its smoke config with the plain versions. The evaluation runs fake W8A8
(per-token and CrossQuant) on the trained fp weights.
"""
from __future__ import annotations

import argparse
import math
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.core import qlinear as ql
from repro_torch.data import make_train_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import QuantContext
from repro_torch.runtime import FailureInjector, Supervisor
from repro_torch.training import optimizer as opt_lib, trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (smoke config)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get(args.arch, smoke=dev.type == "cpu")
    seq, batch_size = 64, 8
    opt_cfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    step = trainer.make_train_step(cfg, opt_cfg, n_micro=2)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(gen, cfg, device=dev)
    state = {"params": params, "opt": opt_lib.init(params)}
    batch_fn = make_train_batches(cfg.vocab, seq, batch_size, seed=0)

    def to_dev(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def step_fn(state, s):
        p, o, metrics = step(state["params"], state["opt"], to_dev(batch_fn(s)))
        if s % 20 == 0:
            print(f"  step {s:4d} loss={float(metrics['loss']):.3f}")
        return {"params": p, "opt": o}, {"loss": float(metrics["loss"])}

    with tempfile.TemporaryDirectory(prefix="repro_torch_example_") as ckpt_dir:
        print(f"training {cfg.name} ({'smoke' if dev.type == 'cpu' else 'full width'}) on "
              f"{dev} for {args.steps} steps with an injected failure at step "
              f"{args.steps // 2} ...")
        sup = Supervisor(CheckpointManager(ckpt_dir, keep_n=2), ckpt_every=20)
        result = sup.run(state, step_fn, args.steps,
                         injector=FailureInjector(fail_at_steps=(args.steps // 2,)))
    print(f"finished at step {result.step} after {result.restarts} restart(s); "
          f"final loss {result.metrics_history[-1]['loss']:.3f}")

    # post-training quantization of the trained model (the paper's deployment)
    trained = result.state["params"]
    eval_batch = to_dev(batch_fn(10_001))
    ppl = {}
    with torch.no_grad():
        for name, qc in [("fp", ql.FP), ("per-token W8A8", ql.W8A8_PER_TOKEN),
                         ("CrossQuant W8A8", ql.W8A8_CROSSQUANT)]:
            _, m = M.loss_fn(trained, eval_batch, cfg, ctx=QuantContext(qc), remat=False)
            ppl[name] = math.exp(float(m["ce"]))
            print(f"  eval {name:18s} ppl={ppl[name]:.3f}")
    return {"restarts": result.restarts, "final_loss": result.metrics_history[-1]["loss"],
            "ppl": ppl}


if __name__ == "__main__":
    main()

"""Serving launcher (port of ``repro/launch/serve.py``): init a model, quantize it
post-training (calibrate static-c column statistics, ``quantize_tree``) and run
greedy decoding through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant int8 --path fused-int8 --kv-cache int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b --smoke \\
        --quant int8 --path fused-int8 --device cpu     # plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant int8 --path fused-int8 --cache-layout paged --speculate 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant int8 --path fused-int8 --cache-layout paged --chunked --token-budget 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant int8 --path fused-int8 --sparsity 2:4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant fake                 # the paper's fake-quant W8A8 CrossQuant path
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --quant int8 --path dequant-fp --scheduler grouped
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --quant int8 --path fused-int8 --kv-cache int8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --quant int8 --path fused-int8   # MoE: the experts on expert-batched K1/K2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke \\
        --quant int8 --path fused-int8 --device cpu --cache-layout paged \\
        --no-prefix-reuse               # hybrid: one state page per slot

``--arch`` takes the dense decoders (starcoder2-7b, gemma2-9b, nemotron-4-15b,
deepseek-coder-33b), pixtral-12b, served text-only, the mixtures of experts
(granite-moe-3b-a800m, llama4-scout-17b-a16e), the SSM mamba2-130m and the
hybrid zamba2-1.2b. The engine's ``check_model`` refuses before any work what it
cannot serve: an encoder-only model (``NotPortedError``), and on the SSM and
hybrid families ``--speculate`` above 1, ``--chunked`` and the paged layout
with prefix reuse (the reference's ``UnsupportedModelError`` subclasses; pass
``--no-prefix-reuse``).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibration, qlinear as ql
from repro_torch.data import make_train_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import QuantContext
from repro_torch.models.quantize import quantize_tree, quantized_bytes
from repro_torch.serving.config import SPARSITY_CHOICES, EngineConfig
from repro_torch.serving.engine import ServeEngine

QUANTS = {
    "fp": ql.FP,
    "fake": ql.W8A8_CROSSQUANT,
    "fake_pt": ql.W8A8_PER_TOKEN,
    "w4a8": ql.W4A8_G128,
    "int8": ql.W8A8_INT8,
}


def calibration_batches(cfg: ModelConfig, *, calib_batches: int, seq_len: int,
                        batch_size: int, seed: int, device) -> List[dict]:
    """The launcher's calibration traffic: ``calib_batches`` seeded Markov-corpus
    batches of (batch_size, seq_len) tokens on ``device``."""
    batch_fn = make_train_batches(cfg.vocab, seq_len, batch_size, seed=seed + 1)
    return [{"tokens": torch.as_tensor(batch_fn(b)["tokens"], dtype=torch.int64,
                                       device=device)} for b in range(calib_batches)]


@torch.no_grad()
def calibrate(params: dict, cfg: ModelConfig, quant: ql.QuantConfig, *, calib_batches: int,
              seq_len: int, batch_size: int, seed: int) -> dict:
    """Record static-c column absmax over ``calib_batches`` eager passes
    (``mode="train"``, per-layer observer names, int8 on the unprepared weights,
    i.e. the ``ref`` integer GEMM). Returns the stacked tables ``quantize_tree``
    reads."""
    obs = calibration.Observer()
    ctx = QuantContext(quant, observer=obs)
    dev = next(iter(params["embed"].values())).device
    for batch in calibration_batches(cfg, calib_batches=calib_batches, seq_len=seq_len,
                                     batch_size=batch_size, seed=seed, device=dev):
        M.apply(params, batch, cfg, ctx=ctx, mode="train", unroll=True)
    return calibration.stack_tables(obs.tables())


def calibrate_and_quantize(params: dict, cfg: ModelConfig, quant: ql.QuantConfig, *,
                           calib_batches: int, seq_len: int, batch_size: int,
                           seed: int) -> dict:
    """Offline PTQ: :func:`calibrate`, then fold the tables into int8 weights.
    Returns the prepared tree; the caller drops the fp tree to free it."""
    return quantize_tree(params, quant, tables=calibrate(
        params, cfg, quant, calib_batches=calib_batches, seq_len=seq_len,
        batch_size=batch_size, seed=seed))


def make_prompts(vocab: int, lens: Sequence[int], n_requests: int,
                 seed: int) -> List[np.ndarray]:
    """``n_requests`` random prompts cycling through ``lens`` (seeded numpy)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=lens[i % len(lens)]).astype(np.int32)
            for i in range(n_requests)]


def main(argv: Optional[Sequence[str]] = None) -> List:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="int8", choices=QUANTS)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-lens", default=None, metavar="L1,L2,...",
                    help="mixed-length workload: cycle prompt lengths over requests")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="EOS token id; default: no EOS (token 0 is the PAD token)")
    ap.add_argument("--calib-batches", type=int, default=2,
                    help="calibration batches for the int8 static-c path")
    ap.add_argument("--scheduler", default="continuous", choices=["continuous", "grouped"],
                    help="continuous slot refill mid-decode, or the grouped baseline "
                         "(equal-length groups, drained)")
    ap.add_argument("--path", default="ref", choices=["ref", "dequant-fp", "fused-int8"],
                    help="integer execution backend (int8 quant): plain ref GEMM, "
                         "dequantize + fp product, or the kernels")
    ap.add_argument("--kv-cache", default="fp", choices=["fp", "int8"])
    ap.add_argument("--cache-layout", default="dense", choices=["dense", "paged"],
                    help="dense slot table, or page pool + radix prefix reuse")
    ap.add_argument("--no-prefix-reuse", dest="prefix_reuse", action="store_false",
                    help="paged layout without the radix prefix index (required for "
                         "SSM and hybrid models, whose state cannot restart mid-prompt)")
    ap.add_argument("--speculate", type=int, default=1,
                    help="draft-window size of speculative decoding (1: off)")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill interleaved with decode (paged layout)")
    ap.add_argument("--token-budget", type=int, default=64,
                    help="per-step token budget of chunked serving")
    ap.add_argument("--sparsity", default="none", choices=SPARSITY_CHOICES,
                    help="N:M structured weight sparsity applied at engine build")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    quant = QUANTS[args.quant]
    path = None if (args.quant != "int8" or args.path == "ref") else args.path
    config = EngineConfig(batch_size=args.batch_size, max_len=args.max_len, path=path,
                          kv_cache=args.kv_cache, eos_id=args.eos_id,
                          cache_layout=args.cache_layout, prefix_reuse=args.prefix_reuse,
                          speculate=args.speculate,
                          chunked=args.chunked, token_budget=args.token_budget,
                          sparsity=args.sparsity, scheduler=args.scheduler)
    config.check_model(cfg)              # refuse before init and calibration
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = M.init_params(gen, cfg, device=device)
    base_bytes = quantized_bytes(params)
    if args.quant == "int8":
        print("calibrating static-c column statistics ...")
        params = calibrate_and_quantize(params, cfg, quant, calib_batches=args.calib_batches,
                                        seq_len=args.prompt_len,
                                        batch_size=args.batch_size, seed=args.seed)
        q_bytes = quantized_bytes(params)
        print(f"quantized weights: {base_bytes / 2**20:.1f} MiB -> "
              f"{q_bytes / 2**20:.1f} MiB ({base_bytes / q_bytes:.2f}x smaller)")

    engine = ServeEngine(cfg, params, config=config, quant=quant, device=device)
    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len])
    engine.submit(make_prompts(cfg.vocab, lens, args.n_requests, args.seed),
                  max_new=args.max_new)
    t0 = time.perf_counter()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) quant={quant.tag()} path={path} "
          f"kv={args.kv_cache} layout={args.cache_layout} device={device} "
          f"occupancy={engine.occupancy():.2f} prefix_hit_rate={engine.prefix_hit_rate():.3f} "
          f"accept_rate={engine.accept_rate():.3f} tokens_per_step={engine.tokens_per_step():.3f} "
          f"chunk_steps={engine.counters['chunk_steps']} sparsity={args.sparsity} "
          f"scheduler={args.scheduler}")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> out={r.out[:8]}")
    return done


if __name__ == "__main__":
    main()

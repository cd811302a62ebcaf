"""Async streaming serving through the PyTorch port's ``AsyncServer`` (the
counterpart of ``examples/serve.py``).

Spins up ``--replicas`` ServeEngine replicas behind the asyncio front end and
streams a mixed-length workload through ``submit()``: per-request TTFT/TPOT,
queue wait, prefix reuse and (with ``--kernel-stats``) the paper's §4.1
quantization-kernel proportion print as each request finishes, followed by the
fleet ``metrics()`` snapshot.

Engine knobs are derived from the :class:`EngineConfig` dataclass fields, and
``--config path.json`` loads a JSON EngineConfig first, with explicit flags
layered on top::

    PYTHONPATH=src:. python examples/serve_torch.py --smoke --device cpu \\
        --replicas 2 --cache-layout paged --shared-prefix 16 --router affinity
    PYTHONPATH=src:. python examples/serve_torch.py --quant int8 \\
        --cache-layout paged --kv-cache int8 --shared-prefix 256 --max-len 1024

Without ``--smoke`` the full-width config is served; ``--device`` is ``cuda``
by default (the kernels; it raises when no card is visible) or ``cpu`` (the
plain versions, smoke configs). ``--stagger`` spaces submissions out
(offered-load shaping); with ``--max-queue``/``--admission-timeout`` you can
watch backpressure reject the overflow instead of thrashing the radix cache.
"""
import argparse
import asyncio
import json
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import qlinear as ql
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.quantize import quantize_tree
from repro_torch.serving.api import AdmissionError, Request
from repro_torch.serving.config import EngineConfig, add_config_args, config_from_args
from repro_torch.serving.server import AsyncServer


def workload(cfg, n_requests, prompt_lens, shared_prefix=0, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab, size=shared_prefix).astype(np.int32)
    return [np.concatenate([
        shared, rng.integers(1, cfg.vocab,
                             size=prompt_lens[i % len(prompt_lens)])
        .astype(np.int32)]) for i in range(n_requests)]


async def drive(srv, prompts, max_new, stagger):
    async def one(i, p):
        await asyncio.sleep(i * stagger)
        toks, fin = [], None
        try:
            async for ev in srv.submit(Request(prompt=p.tolist(),
                                               max_new=max_new)):
                if ev.kind == "token":
                    toks.append(ev.token)
                elif ev.kind == "finished":
                    fin = ev
                else:
                    print(f"  req {i}: ERROR {ev.error}")
                    return
        except AdmissionError as e:
            print(f"  req {i}: REJECTED after {e.queue_wait_s * 1e3:.0f}ms "
                  f"({e})")
            return
        m = fin.metrics
        kp = (f" kernel_prop={m.kernel_proportion:.2%}"
              if m.kernel_proportion is not None else "")
        print(f"  req {i}: {len(toks)} toks [{fin.finish_reason}] "
              f"replica={m.replica} ttft={m.ttft_s * 1e3:.0f}ms "
              f"tpot={m.tpot_s * 1e3:.1f}ms queue={m.queue_wait_s * 1e3:.0f}ms "
              f"prefix_reused={m.prefix_reused} requeues={m.requeues}{kp}")

    await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="PATH.json",
                    help="load an EngineConfig from JSON; explicit engine "
                         "flags below override its fields")
    add_config_args(ap)
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (default: full width)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain versions)")
    ap.add_argument("--quant", default="fp", choices=["fp", "fake", "int8"])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--router", default="affinity",
                    choices=["affinity", "least-loaded", "random"])
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: max in-flight requests "
                         "(default 2*replicas*batch_size)")
    ap.add_argument("--admission-timeout", type=float, default=1.0,
                    help="seconds a submit may wait for capacity before the "
                         "typed AdmissionError")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="6,10,14", metavar="L1,L2,...")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="N-token shared system prompt (prefix affinity + "
                         "paged radix reuse)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--stagger", type=float, default=0.0, metavar="S",
                    help="seconds between submissions (offered-load shaping)")
    ap.add_argument("--kernel-stats", action="store_true",
                    help="per-request §4.1 quantization-kernel proportion")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = M.init_params(gen, cfg, device=device)
    base = (EngineConfig.from_json(pathlib.Path(args.config).read_text())
            if args.config else None)
    quant = {"fp": ql.FP, "fake": ql.W8A8_CROSSQUANT,
             "int8": ql.W8A8_INT8}[args.quant]
    defaults = dict(batch_size=4, max_len=48)
    if args.quant == "int8":
        params = quantize_tree(params, quant)
        defaults["path"] = "fused-int8"
    config = config_from_args(args, base=base, **defaults)
    prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    prompts = workload(cfg, args.n_requests, prompt_lens,
                       shared_prefix=args.shared_prefix)

    async def run():
        async with AsyncServer(cfg, params, config=config,
                               replicas=args.replicas, quant=quant,
                               router=args.router, max_queue=args.max_queue,
                               admission_timeout=args.admission_timeout,
                               kernel_stats=args.kernel_stats,
                               device=device) as srv:
            print(f"serving {len(prompts)} requests on {args.replicas} "
                  f"replica(s), router={args.router}, device={device}, "
                  f"config={config.to_json()}")
            await drive(srv, prompts, args.max_new, args.stagger)
            print("fleet metrics:")
            print(json.dumps(srv.metrics(), indent=2))

    asyncio.run(run())


if __name__ == "__main__":
    main()

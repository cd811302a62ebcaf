#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold each of its
hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
3. Each kernel against its plain version on the card, at the main path's shapes,
   with its time, the plain version's, a one-call library yardstick where one
   exists, and the bound the card's data-sheet peaks allow. Times are device
   times: many calls captured in a CUDA graph and replayed. ``call_ms`` is the
   time of back-to-back calls from Python, host dispatch included.
4. The main path at full width and depth: starcoder2-7b (32 layers) initialised
   from a seeded generator, calibrated (2 batches), quantized to W8A8 static-c
   CrossQuant, and served through ``ServeEngine(path="fused-int8")``: on the dense
   continuous layout with fp and int8 KV; on the paged layout with radix prefix
   reuse, fp and int8 KV, over traffic that shares a 389-token system prefix; and
   paged with ``speculate=4`` over motif-tiled prompts. Each run's kernel launch
   counts must equal what its schedule implies.
5. The same width cut to 2 layers (float32): one admission prefill through the
   flash path and 8 greedy decode steps on the dense and on the paged layout,
   kernels on the card against the plain versions on the CPU: equal greedy
   tokens, logits within 5e-2 of max|logit| (beside what a one-ulp input nudge
   does on the CPU alone). Then the engine on the card: paged ≡ dense and
   speculate=4 ≡ speculate=1 in greedy tokens.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the card's
nvidia-smi name and power limit, and the one before that the kernels' JSON.
Exits non-zero without printing a result when no CUDA card is visible.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}   # dense, no sparsity
L2_BYTES = 50 * 2 ** 20

LENS = [130, 200, 300, 450, 520, 700, 250, 600]   # buckets 256, 512 and 1024
BATCH, MAX_LEN, MAX_NEW = 4, 1024, 16
SYSTEM_PREFIX = 389                                # not a page multiple: tails copy on write
SUFFIXES = [20, 150, 60, 300, 40, 200, 90, 10]
MOTIF = 16                                         # speculative traffic: tiled motifs


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops over peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.core import qlinear as ql
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import calibrate_and_quantize, make_prompts
    from repro_torch.models import model as M
    from repro_torch.models.layers import QuantContext
    from repro_torch.models.quantize import quantized_bytes
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- phase 1
    smi = nvidia_smi_line()
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[1] nvidia-smi: {smi}")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    lib_path, log = build.build(verbose=True)
    build.library()
    print(f"[2] built {lib_path.name} in {time.perf_counter() - t0:.1f}s")
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error", "warning")):
            print(f"[2]   {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps: int) -> float:
        """Device time per call: ``reps`` calls captured in one CUDA graph and
        replayed, so the host's dispatch of each call (Python, argument checks,
        ctypes) is not in the number, as it is in ``time_ms``."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(0)                                   # warm-up outside the graph
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(reps):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * reps)

    def once(fn):
        return lambda i=0: fn()

    results = {}

    # K1 act_quantize: every quantized linear's input; bf16 activations (FULL dtype)
    k1_shapes = [(m, k) for m in (4, 2048) for k in (4608, 18432)]
    for (Mr, K) in k1_shapes:
        x = (torch.randn(Mr, K, generator=gen, device=dev) * 2).to(torch.bfloat16)
        x[:, torch.randperm(K, generator=gen, device=dev)[:8]] *= 30   # outlier channels
        bcol = torch.rand(K, generator=gen, device=dev) * 3 + 0.25
        alpha = torch.tensor(0.15, device=dev)
        q, a = ops.act_quantize(x, bcol, alpha)
        qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
        torch.cuda.synchronize()
        d = (q.int() - qr.int()).abs()
        n_off = int((d > 0).sum())
        a_ulps = int((a.view(torch.int32) - ar.view(torch.int32)).abs().max())
        check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel(),
              f"act_quantize codes M={Mr} K={K}: max |dq|={int(d.max())}, off={n_off}")
        check(a_ulps <= 1, f"act_quantize scale M={Mr} K={K}: {a_ulps} ulp")
        ms = graph_ms(once(lambda: ops.act_quantize(x, bcol, alpha)), 200)
        cms = time_ms(once(lambda: ops.act_quantize(x, bcol, alpha)), 200)
        pms = graph_ms(once(lambda: ref.act_quantize_ref(x, bcol, 8, alpha)), 20)
        nbytes = Mr * K * 2 + K * 4 + Mr * K + Mr * 4
        bms, by = bound(nbytes, 6 * Mr * K, PEAK_OPS["f32"])
        results[("act_quantize", Mr, K)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=float(d.max()))
        print(f"[3] act_quantize M={Mr} K={K} bf16: kernel_ms={ms:.4f} call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} "
              f"library_ms=None bound_ms={bms:.4f} ({by}) off_by_one={n_off}/{q.numel()} "
              f"a_max_ulp={a_ulps}")

    # K2 qgemm_w8a8: wq/wo/down (N=4608), wk/wv (N=512), up (N=18432)
    k2_shapes = [(m, k, n) for m in (4, 2048)
                 for (k, n) in ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))]
    for (Mr, K, N) in k2_shapes:
        qx = torch.randint(-127, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
        # the main path reads each layer's weight once per step, from device memory:
        # rotate through enough copies that the timed loop cannot serve it from L2
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N))))
        qws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
               for _ in range(n_copies)]
        qw = qws[0]
        a = torch.rand(Mr, 1, generator=gen, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N, generator=gen, device=dev) * 0.1 + 1e-3
        out = ops.qgemm_w8a8(qx, qw, a, sw)
        want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"qgemm_w8a8 M={Mr} K={K} N={N} not bitwise: {err}")
        ms = graph_ms(lambda i=0: ops.qgemm_w8a8(qx, qws[i % n_copies], a, sw), 50)
        cms = time_ms(lambda i=0: ops.qgemm_w8a8(qx, qws[i % n_copies], a, sw), 50)
        pms = graph_ms(lambda i=0: ref.qgemm_w8a8_ref(qx, qws[i % n_copies], a, sw), 5)
        lms = None
        if Mr > 16:      # torch._int_mm needs more than 16 rows; int32 product only
            lms = graph_ms(lambda i=0: torch._int_mm(qx, qws[i % n_copies]), 50)
        nbytes = Mr * K + K * N + Mr * 4 + N * 4 + Mr * N * 4
        bms, by = bound(nbytes, 2 * Mr * N * K, PEAK_OPS["int8"])
        results[("qgemm_w8a8", Mr, K, N)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by,
            max_abs_err=err)
        lstr = "None" if lms is None else f"{lms:.4f}"
        print(f"[3] qgemm_w8a8 M={Mr} K={K} N={N}: kernel_ms={ms:.4f} call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} "
              f"library_ms={lstr} (torch._int_mm) bound_ms={bms:.4f} ({by}) "
              f"bitwise=True tflops={2 * Mr * N * K / ms / 1e9:.1f}")
        del qws, qw

    # K3 flash_attention: admission prefill, B=4 rows, 36 heads over 4 kv heads, D=128
    B3, H3, Hkv3, D3 = 4, 36, 4, 128
    for S in (128, 512):
        kv_len = torch.tensor([S, S - 37, S // 2, S // 3 + 1], device=dev, dtype=torch.int32)
        for dtype, atol, pk in ((torch.bfloat16, 2e-2, "bf16"), (torch.float32, 1e-4, "f32")):
            q = torch.randn(B3, H3, S, D3, generator=gen, device=dev).to(dtype)
            k = torch.randn(B3, Hkv3, S, D3, generator=gen, device=dev).to(dtype)
            v = torch.randn(B3, Hkv3, S, D3, generator=gen, device=dev).to(dtype)
            out = ops.flash_attention(q, k, v, kv_len)
            want = ref.flash_attention_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            check(err <= atol, f"flash_attention S={S} {pk}: max err {err} > {atol}")
            ms = graph_ms(once(lambda: ops.flash_attention(q, k, v, kv_len)), 20)
            cms = time_ms(once(lambda: ops.flash_attention(q, k, v, kv_len)), 20)
            pms = graph_ms(once(lambda: ref.flash_attention_ref(q, k, v, kv_len)), 5)
            pos = torch.arange(S, device=dev)
            mask = ((pos[:, None] >= pos[None, :])[None, None]
                    & (pos[None, None, None, :] < kv_len.view(-1, 1, 1, 1)))
            sdpa = lambda i=0: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
            lms = graph_ms(sdpa, 20)
            kvl = kv_len.cpu().numpy()
            live = sum(int(np.minimum(np.arange(1, S + 1), n).sum()) for n in kvl)
            flops = 4 * D3 * H3 * live
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * B3
            bms, by = bound(nbytes, flops, PEAK_OPS[pk])
            results[("flash_attention", S, pk)] = dict(
                ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by,
                max_abs_err=err)
            print(f"[3] flash_attention B={B3} H={H3}/{Hkv3} S={S} D={D3} {pk} kv_len="
                  f"{kvl.tolist()}: kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} "
                  f"library_ms={lms:.4f} "
                  f"(sdpa) bound_ms={bms:.4f} ({by}) max_abs_err={err:.2e} tol={atol}")

    # K4/K5 paged_attention: the decode (q_win = 1) and the speculative verify
    # (q_win = 4) of every layer, B=4 slots, 36 heads over 4 kv heads, D=128, at the
    # kv_len a long, a medium, a short and a just-admitted slot hold. The serving q
    # is bf16; the engine's fp pool takes the tree's first float leaf (f32), int8 KV
    # carries f32 scale pools. Slot 3's table row is all sentinel.
    B4, Hkv4, G4, D4, W5 = 4, 4, 9, 128, 4
    kv_len4 = torch.tensor([700, 517, 130, 1], device=dev, dtype=torch.int32)
    q_len5 = torch.tensor([4, 1, 3, 2], device=dev, dtype=torch.int32)
    kvl_np, qln_np = kv_len4.cpu().numpy(), q_len5.cpu().numpy()
    paged_cases = [(q_dt, pool_dt, ps) for ps in (8, 16)
                   for q_dt, pool_dt in ((torch.bfloat16, torch.float32),
                                         (torch.bfloat16, torch.bfloat16),
                                         (torch.bfloat16, torch.int8),
                                         (torch.float32, torch.float32))]
    dt_name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
    for q_dt, pool_dt, ps in paged_cases:
        maxP = MAX_LEN // ps
        P = B4 * maxP
        tab = torch.full((B4, maxP), P, dtype=torch.int32, device=dev)
        perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
        off = 0
        for b in range(B4 - 1):                     # slot 3 keeps an all-sentinel row
            n = -(-int(kvl_np[b]) // ps)
            tab[b, :n] = perm[off: off + n]
            off += n
        shape = (P, ps, Hkv4, D4)
        if pool_dt == torch.int8:
            kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            ks = torch.rand(shape[:3] + (1,), generator=gen, device=dev) * 0.05 + 2e-3
            vs = torch.rand(shape[:3] + (1,), generator=gen, device=dev) * 0.05 + 2e-3
        else:
            kp = torch.randn(shape, generator=gen, device=dev).to(pool_dt)
            vp = torch.randn(shape, generator=gen, device=dev).to(pool_dt)
            ks = vs = None
        sc = dict(k_scale_pages=ks, v_scale_pages=vs)
        atol = 2e-2 if q_dt == torch.bfloat16 else 2e-5
        tag = f"q {dt_name[q_dt]} pool {dt_name[pool_dt]} ps={ps}"
        # the bytes the function must read: each live K/V row once (positions
        # < kv_len), plus scales, q, o, the table and the lengths
        live = int(kvl_np.sum())
        row_bytes = Hkv4 * D4 * pool_dt.itemsize * 2 + (8 * Hkv4 if ks is not None else 0)
        peak = PEAK_OPS["f32"]                      # the kernel computes in f32
        for mode, W in (("decode", 1), ("verify", W5)):
            q = torch.randn(B4, W, Hkv4 * G4, D4, generator=gen, device=dev).to(q_dt)
            if mode == "decode":
                call = lambda: ops.paged_decode_attention(q, kp, vp, tab, kv_len4, **sc)  # noqa: E731
                out = call()
                want = ref.paged_decode_attention_ref(q.reshape(B4, Hkv4, G4, D4), kp, vp,
                                                      tab, kv_len4, **sc).reshape(out.shape)
                plain = lambda: ref.paged_decode_attention_ref(  # noqa: E731
                    q.reshape(B4, Hkv4, G4, D4), kp, vp, tab, kv_len4, **sc)
                valid = torch.ones(B4, W, dtype=torch.bool, device=dev)
                flops = 4 * G4 * D4 * Hkv4 * live
                # verify at q_win = 1 must be bitwise this launch
                ver1 = ops.paged_verify_attention(q, kp, vp, tab, kv_len4,
                                                  torch.ones_like(kv_len4), **sc)
                check(torch.equal(ver1, out), f"paged verify q_win=1 != decode launch ({tag})")
            else:
                call = lambda: ops.paged_verify_attention(q, kp, vp, tab, kv_len4, q_len5,  # noqa: E731
                                                          **sc)
                out = call()
                qg = q.reshape(B4, W, Hkv4, G4, D4).permute(0, 2, 1, 3, 4)
                want = ref.paged_verify_attention_ref(qg, kp, vp, tab, kv_len4, q_len5, **sc)
                want = want.permute(0, 2, 1, 3, 4).reshape(out.shape)
                plain = lambda: ref.paged_verify_attention_ref(  # noqa: E731
                    qg, kp, vp, tab, kv_len4, q_len5, **sc)
                valid = torch.arange(W, device=dev)[None, :] < q_len5[:, None]
                flops = 4 * G4 * D4 * Hkv4 * int((qln_np * kvl_np).sum())
            # the all-sentinel row reads a clamped page (the plain version clamps
            # to another row): finite, and not compared
            valid[B4 - 1] = False
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()), f"paged {mode} {tag}: non-finite")
            err = float((out.float() - want.float()).abs()[valid].max())
            check(err <= atol, f"paged {mode} {tag}: max err {err} > {atol}")
            ms = graph_ms(once(call), 50)
            cms = time_ms(once(call), 50)
            pms = graph_ms(once(plain), 5)
            nbytes = (live * row_bytes + 2 * q.numel() * q.element_size() + tab.numel() * 4
                      + 4 * B4 * (1 if mode == "decode" else 2))
            bms, by = bound(nbytes, flops, peak)
            name = "paged_decode_attention" if mode == "decode" else "paged_verify_attention"
            results[(name, dt_name[q_dt], dt_name[pool_dt], ps)] = dict(
                ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms,
                bound_by=by, max_abs_err=err)
            print(f"[3] {name} B={B4} H={Hkv4 * G4}/{Hkv4} D={D4} q_win={W} {tag} kv_len="
                  f"{kvl_np.tolist()}{'' if W == 1 else f' q_len={qln_np.tolist()}'}: "
                  f"kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None "
                  f"bound_ms={bms:.5f} ({by}) max_abs_err={err:.2e} tol={atol}")
        del kp, vp, ks, vs

    # ---------------------------------------------------------------- phase 4
    cfg = get("starcoder2-7b")
    quant = ql.W8A8_INT8
    check(cfg.n_layers == 32 and cfg.d_model == 4608 and cfg.dtype == "bfloat16",
          "starcoder2-7b FULL config")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(g, cfg, device=dev)
    fp_bytes = quantized_bytes(params)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = calibrate_and_quantize(params, cfg, quant, calib_batches=2, seq_len=16,
                                    batch_size=BATCH, seed=0)     # drops the f32 tree
    torch.cuda.synchronize()
    q_bytes = quantized_bytes(params)
    print(f"[4] {cfg.name} FULL: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e9:.2f}B init {t_init:.1f}s, calibrate+PTQ "
          f"{time.perf_counter() - t0:.1f}s, weights {fp_bytes / 2**30:.2f} GiB -> "
          f"{q_bytes / 2**30:.2f} GiB, allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(min(LENS) >= 128, "every prompt's bucket reaches the flash kernel")
    prompts = make_prompts(cfg.vocab, LENS, len(LENS), seed=0)
    per_layer = 6                                   # wq wk wv wo up down
    launches = {name: 0 for name in ops.LAUNCHES}
    e2e = {}

    def serve(label: str, reqs, **kw):
        """One serving run of ``reqs`` at full width and depth. The kernel counts are
        zeroed just before the run and read just after, and must equal what its
        schedule implies: 192 act_quantize/qgemm launches per model step, 32 flash
        launches per cold admission of 128 tokens or more, 32 paged decode
        launches per decode step of a paged engine, 32 verify launches per
        speculative step."""
        engine = ServeEngine(cfg, params, quant=quant, device=dev,
                             config=EngineConfig(batch_size=BATCH, max_len=MAX_LEN,
                                                 path="fused-int8", **kw))
        cold_buckets = []                 # the flash kernel serves cold prefills only
        attr = "_admit_cold" if engine.paged else "_admit_step"
        admit = getattr(engine, attr)

        def counted(p, tokens, *rest):
            cold_buckets.append(tokens.shape[1])
            return admit(p, tokens, *rest)

        setattr(engine, attr, counted)
        engine.submit(reqs, max_new=MAX_NEW)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        c = engine.counters
        steps = c["prefill_calls"] + c["decode_steps"]
        n_tok = sum(len(r.out) for r in done)
        L = cfg.n_layers
        check(len(done) == len(reqs) and all(len(r.out) == MAX_NEW for r in done),
              f"{label}: every request gets {MAX_NEW} tokens")
        check(all(0 <= t < cfg.vocab for r in done for t in r.out), f"{label}: token ids")
        want = {"act_quantize": per_layer * L * steps, "qgemm_w8a8": per_layer * L * steps,
                "flash_attention": L * sum(b >= 128 for b in cold_buckets),
                "paged_decode_attention": (L * c["decode_steps"]
                                           if engine.paged and engine.spec == 1 else 0),
                "paged_verify_attention": (L * c["spec_steps"]
                                           if engine.paged and engine.spec > 1 else 0)}
        for name, n in want.items():
            check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n} "
                  f"(prefill_calls={c['prefill_calls']} decode_steps={c['decode_steps']} "
                  f"spec_steps={c['spec_steps']} cold buckets={cold_buckets})")
        for name in launches:
            launches[name] += counts[name]
        e2e[label] = n_tok / dt
        pool_dt = engine.caches["blocks"][0]["k_pages" if engine.paged else "k"].dtype
        print(f"[4] serve {label}: {len(done)} requests, {n_tok} tokens in {dt:.2f}s = "
              f"{n_tok / dt:.1f} tok/s; prefill_calls={c['prefill_calls']} (cold buckets "
              f"{cold_buckets}) decode_steps={c['decode_steps']} occupancy="
              f"{engine.occupancy():.2f} kv pool dtype={pool_dt} launches={counts}; "
              f"req0 out[:8]={done[0].out[:8]}")
        return engine, done

    for kv in ("fp", "int8"):
        serve(f"dense fused-int8 kv={kv}", prompts, kv_cache=kv)

    # paged with radix reuse: 8 requests behind one 389-token system prefix
    rng = np.random.default_rng(4)
    system = rng.integers(1, cfg.vocab, size=SYSTEM_PREFIX).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(1, cfg.vocab, size=n).astype(np.int32)])
              for n in SUFFIXES]
    for kv in ("fp", "int8"):
        engine, _ = serve(f"paged fused-int8 kv={kv}", shared, kv_cache=kv,
                          cache_layout="paged")
        c = engine.counters
        check(c["prefix_hits"] > 0, f"paged kv={kv}: no prefix hit")
        engine.pool.check()
        print(f"[4]   paged kv={kv}: page_size={engine.ps} n_pages={engine.n_pages} "
              f"prefix_hits={c['prefix_hits']} prefix_hit_rate={engine.prefix_hit_rate():.3f} "
              f"prefill_tokens={c['prefill_tokens']}/{c['prompt_tokens']} "
              f"cow_copies={c['cow_copies']} peak_pages_in_use={c['peak_pages_in_use']}")
        del engine

    # paged + speculate=4: every prompt tiles its own 16-token motif, so the
    # n-gram drafter always finds a continuation to propose
    rng = np.random.default_rng(5)
    motifs = [np.tile(rng.integers(1, cfg.vocab, size=MOTIF).astype(np.int32),
                      -(-n // MOTIF))[:n] for n in LENS]
    engine, _ = serve("paged fused-int8 kv=fp speculate=4", motifs, cache_layout="paged",
                      speculate=4)
    c = engine.counters
    check(c["spec_steps"] > 0 and c["spec_drafted"] > 0, "speculative run drafted nothing")
    print(f"[4]   speculate=4: spec_steps={c['spec_steps']} drafted={c['spec_drafted']} "
          f"accepted={c['spec_accepted']} accept_rate={engine.accept_rate():.3f} "
          f"tokens_per_step={engine.tokens_per_step():.3f}")
    del engine
    del params
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 5
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    p2 = calibrate_and_quantize(M.init_params(g, cfg2, device=dev), cfg2, quant,
                                calib_batches=2, seq_len=16, batch_size=BATCH, seed=1)
    p2_cpu = M.map_tensors(p2, lambda t: t.cpu())
    rng = np.random.default_rng(2)
    lens = np.array([150, 131], np.int32)                    # bucket 256: flash path
    toks = np.zeros((2, 256), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(1, cfg2.vocab, size=n)
    ctx = QuantContext(quant, use_kernels=True, int_exec="kernel")

    # paged parity runs through a permuted page table (64 pages of 8 per slot)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(6)).to(torch.int32)

    def greedy(params, device, forced=None, layout="dense"):
        """Prefill + 8 decode steps, feeding its own argmax (or ``forced`` tokens)."""
        caches = M.init_cache(cfg2, 2, 512, dtype=torch.float32, layout=layout, page_size=8,
                              device=device)
        if layout == "paged":
            caches["page_table"] = perm.reshape(2, 64).to(device)
        logits, _ = M.apply(params, {"tokens": torch.as_tensor(toks, device=device)}, cfg2,
                            ctx=ctx, mode="prefill", caches=caches,
                            cur_len=torch.as_tensor(lens, device=device))
        out_logits, out_toks = [logits[:, -1].float().cpu()], []
        for i in range(8):
            tok = (torch.argmax(logits[:, -1], dim=-1) if forced is None
                   else forced[i].to(device))
            out_toks.append(tok.cpu())
            logits, _ = M.apply(params, {"tokens": tok[:, None]}, cfg2, ctx=ctx,
                                mode="decode", caches=caches,
                                cur_len=torch.as_tensor(lens + i + 1, device=device))
            out_logits.append(logits[:, -1].float().cpu())
        return torch.stack(out_logits), torch.stack(out_toks)

    cpu = torch.device("cpu")
    with torch.no_grad():
        ops.reset_launches()
        gl, gt = greedy(p2, dev)
        check(ops.LAUNCHES["flash_attention"] == cfg2.n_layers, "parity prefill used flash")
        t0 = time.perf_counter()
        cl, ct = greedy(p2_cpu, cpu)
        # How far ulp-level float differences carry: the same CPU run with every
        # embedding weight moved by one ulp, fed the same tokens.
        emb = p2_cpu["embed"]["w"]
        up = torch.rand(emb.shape, generator=torch.Generator().manual_seed(3)) < 0.5
        nudged = torch.where(up, torch.nextafter(emb, torch.full_like(emb, 1.0)),
                             torch.nextafter(emb, torch.full_like(emb, -1.0)))
        ul, _ = greedy({**p2_cpu, "embed": {"w": nudged}}, cpu, forced=ct)
    err = float((gl - cl).abs().max())
    ulp_err = float((ul - cl).abs().max())
    # An int8 code moves by one wherever a value sits within an ulp of a rounding
    # boundary, and the integer GEMMs carry that move exactly; so the card's and
    # the CPU's differently ordered float sums (norms, attention, lm head) part by
    # about what a one-ulp nudge of the input does (ulp_err). The tolerance leaves
    # room above that; the greedy tokens must match exactly.
    tol = 5e-2 * float(cl.abs().max())
    check(torch.equal(gt, ct), f"card vs CPU greedy tokens differ: {gt.T} vs {ct.T}")
    check(err <= tol, f"card vs CPU logits: max err {err} > {tol}")
    print(f"[5] 2-layer FULL-width f32 card vs CPU: 1 prefill (bucket 256) + 8 decode steps, "
          f"tokens equal {gt.T.tolist()}, logits max_abs_err={err:.3e}, one-ulp input nudge "
          f"on CPU moves them {ulp_err:.3e}, tol 5e-2*max|logit|={tol:.3e}, "
          f"CPU side {time.perf_counter() - t0:.1f}s")

    # the paged layout: the same prefill + decode through a permuted page table,
    # the decode through K4 on the card and its plain version on the CPU
    with torch.no_grad():
        ops.reset_launches()
        pgl, pgt = greedy(p2, dev, layout="paged")
        check(ops.LAUNCHES["paged_decode_attention"] == 8 * cfg2.n_layers,
              f"paged parity decode launches {ops.LAUNCHES['paged_decode_attention']}")
        pcl, pct = greedy(p2_cpu, cpu, layout="paged")
    perr = float((pgl - pcl).abs().max())
    check(torch.equal(pgt, pct), f"paged card vs CPU greedy tokens differ: {pgt.T} vs {pct.T}")
    check(torch.equal(pgt, gt), f"paged vs dense greedy tokens differ: {pgt.T} vs {gt.T}")
    check(perr <= tol, f"paged card vs CPU logits: max err {perr} > {tol}")
    print(f"[5] paged (ps=8, permuted table) card vs CPU: tokens equal, equal to dense; "
          f"logits max_abs_err={perr:.3e} (dense card vs paged card "
          f"{float((pgl - gl).abs().max()):.3e}), tol={tol:.3e}")

    # the engine on the card: paged ≡ dense over shared-prefix traffic (warm
    # admissions and copy-on-write at batch 2), speculate=4 ≡ speculate=1 (paged)
    rng = np.random.default_rng(7)
    system = rng.integers(1, cfg2.vocab, size=SYSTEM_PREFIX).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(1, cfg2.vocab, size=n).astype(np.int32)])
              for n in SUFFIXES[:4]]
    motifs = [np.tile(rng.integers(1, cfg2.vocab, size=MOTIF).astype(np.int32),
                      -(-n // MOTIF))[:n] for n in LENS[:4]]

    def engine_tokens(reqs, **kw):
        eng = ServeEngine(cfg2, p2, quant=quant, device=dev,
                          config=EngineConfig(batch_size=2, max_len=MAX_LEN,
                                              path="fused-int8", **kw))
        eng.submit(reqs, max_new=8)
        return [r.out for r in eng.run()], eng

    dense_out, _ = engine_tokens(shared)
    paged_out, peng = engine_tokens(shared, cache_layout="paged")
    check(peng.counters["prefix_hits"] > 0, "2-layer paged run: no prefix hit")
    check(paged_out == dense_out, f"engine paged vs dense tokens differ: {paged_out} vs "
          f"{dense_out}")
    base_out, _ = engine_tokens(motifs, cache_layout="paged")
    spec_out, seng = engine_tokens(motifs, cache_layout="paged", speculate=4)
    check(spec_out == base_out, f"speculate=4 vs 1 tokens differ: {spec_out} vs {base_out}")
    print(f"[5] 2-layer engine on the card: paged == dense over {len(shared)} shared-prefix "
          f"requests (prefix_hits={peng.counters['prefix_hits']} cow_copies="
          f"{peng.counters['cow_copies']}); speculate=4 == speculate=1 over {len(motifs)} "
          f"motif prompts (accept_rate={seng.accept_rate():.3f} tokens_per_step="
          f"{seng.tokens_per_step():.3f})")

    # ---------------------------------------------------------------- result
    kernel_rows = [
        ("act_quantize", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize", 4, 4608), "M=4 K=4608 bf16"),
        ("qgemm_w8a8", "src/repro_torch/csrc/qgemm_w8a8.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8", 4, 4608, 18432), "M=4 K=4608 N=18432"),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:33", ("flash_attention", 512, "bf16"),
         "B=4 H=36/4 S=512 D=128 bf16"),
        ("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/flash_attention.py:98",
         ("paged_decode_attention", "bf16", "f32", 8),
         "B=4 H=36/4 D=128 ps=8 q bf16 pool f32 kv_len=[700,517,130,1]"),
        ("paged_verify_attention", "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/flash_attention.py:98",
         ("paged_verify_attention", "bf16", "f32", 8),
         "B=4 H=36/4 D=128 ps=8 q_win=4 q bf16 pool f32 q_len=[4,1,3,2]"),
    ]
    kernels = []
    for name, source, replaces, key, shape in kernel_rows:
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape})
    print("[6] e2e tok/s " + "; ".join(f"{k}={v:.1f}" for k, v in e2e.items())
          + f"; total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The hand-written kernels of this checkout against those of another checkout of
the port (an earlier commit, unpacked with ``git archive``), on one NVIDIA card.

    python3 kernel_ab.py --base DIR

runs the same seeded cases four times, each in a process of its own that builds
and imports the kernels of one checkout: base, this one, this one, base (so a drift
of the card over the call weighs on both sides alike). Each case is a kernel
wrapper's call at a shape the main path gives it; its output is kept and its
device time taken from launches captured in a CUDA graph. It prints, per case,
the two sides' times (the faster of each side's two runs) and their ratio, and
whether the outputs agree bitwise; it fails where a case marked bitwise differs.
It also prints the card's name and power limit and the ``-Xptxas -v`` lines
(registers, spills) of the kernels it names, for both checkouts.

The cases: K4/K5/K6's bf16 body at D = 128 (starcoder2-7b's decode, verify and
packed chunk over f32 and int8 pools) and D = 64 (zamba2-1.2b), bitwise; at D =
256 (gemma2-9b's local layers, window 4096, softcap 50, int8 pool), timed, since
that instantiation may sum in another order, and beside it the same case without
the softcap and at D = 128 (bitwise); K2 at starcoder2-7b's linears (M = 4,
128, 2048), bitwise; K2 at mamba2-130m's in_proj (K = 768, N = 3352, M = 4 and
2048) served as each checkout serves it (``models.quantize.prepare_served`` where
the checkout has it, else the contiguous weight), bitwise; K7 at the up
projection with every other k-tile empty, bitwise; K8 at the up projection and
the tp=2 down shard (M = 4, 128, 2048) and its group-acc mode at the shard (M = 4,
128), bitwise; K3 at starcoder2's admission (D = 128, bf16 and f32), zamba2's (D =
64) and hubert's (D = 80), bitwise, and at gemma2's local and global prefill (D =
256), timed; the dense decode / verify kernel at starcoder2's decode (int8 and f32
cache). A case the base checkout cannot run prints as missing.

    python3 kernel_ab.py --base DIR --only K2,K7

runs only the cases whose names start so (here the GEMM cases).

    python3 kernel_ab.py --run ROOT --out FILE

is one of the four processes: the cases on ROOT's kernels, saved to FILE.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
L2_BYTES = 50 * 2 ** 20
PTXAS_KERNELS = ("paged_mma_kernel", "qgemm_decode_kernel", "qgemm_wgmma_kernel",
                 "qgemm_w4a8_wgmma_kernel", "fa_bf16_kernel", "fa_wgmma_kernel",
                 "dense_attention_kernel")


def cases(torch, dev, ops):
    """{name: (call, bitwise)}: each call runs the kernel once (``i`` picks a weight
    copy where the inputs exceed the L2 cache)."""
    from repro_torch.models import quantize as MQ
    g = torch.Generator(device=dev)
    out = {}

    def pools(P, ps, Hkv, D, dtype, seed):
        g.manual_seed(seed)
        if dtype == torch.int8:
            kp, vp = (torch.randint(-127, 128, (P, ps, Hkv, D), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand((P, ps, Hkv, 1), generator=g, device=dev) * 0.05 + 2e-3
                      for _ in range(2))
            return kp, vp, dict(k_scale_pages=ks, v_scale_pages=vs)
        kp, vp = (torch.randn((P, ps, Hkv, D), generator=g, device=dev).to(dtype)
                  for _ in range(2))
        return kp, vp, {}

    def table(kv_lens, ps, maxP, P):
        tab = torch.full((len(kv_lens), maxP), P, dtype=torch.int32, device=dev)
        perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
        off = 0
        for b, n in enumerate(kv_lens):
            n = -(-n // ps)
            tab[b, :n] = perm[off:off + n]
            off += n
        return tab, torch.tensor(kv_lens, dtype=torch.int32, device=dev)

    paged = [("starcoder2 D=128 f32 pool", 4, 9, 128, 8, 128, torch.float32, None, None,
              [700, 517, 130, 1], [1, 1, 1, 125], [700, 517, 130, 514], True),
             ("starcoder2 D=128 int8 pool", 4, 9, 128, 8, 128, torch.int8, None, None,
              [700, 517, 130, 1], [1, 1, 1, 125], [700, 517, 130, 514], True),
             ("zamba2 D=64 int8 pool", 32, 1, 64, 8, 128, torch.int8, None, None,
              [700, 517, 130, 1], [1, 1, 1, 125], [700, 517, 130, 514], True),
             ("gemma2 D=256 int8 pool", 8, 2, 256, 16, 512, torch.int8, 4096, 50.0,
              [4616, 317], [200, 1], [4616, 317], False),
             # the same case without the softcap, and at D = 128: what the softcap's
             # tanh and the head size each cost
             ("gemma2 D=256 int8 pool no softcap", 8, 2, 256, 16, 512, torch.int8, 4096, None,
              [4616, 317], [200, 1], [4616, 317], False),
             ("gemma2 shape at D=128 int8 pool", 8, 2, 128, 16, 512, torch.int8, 4096, 50.0,
              [4616, 317], [200, 1], [4616, 317], True)]
    for label, Hkv, G, D, ps, maxP, pdt, window, softcap, kvl, qln, rkvl, bitwise in paged:
        P = sum(-(-n // ps) for n in set(kvl) | set(rkvl)) * 2 + 8
        kp, vp, sc = pools(P, ps, Hkv, D, pdt, D + Hkv)
        kw = dict(sc, window=window, softcap=softcap)
        tab, kv = table(kvl, ps, maxP, P)
        B = len(kvl)
        q = torch.randn(B, 1, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
        out[f"K4 {label}"] = (lambda i=0, q=q, tab=tab, kv=kv, kp=kp, vp=vp, kw=kw:
                              ops.paged_decode_attention(q, kp, vp, tab, kv, **kw), bitwise)
        W = 4
        qw = torch.randn(B, W, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
        qlw = torch.tensor([4, 1, 3, 2][:B], dtype=torch.int32, device=dev)
        out[f"K5 {label}"] = (lambda i=0, qw=qw, tab=tab, kv=kv, kp=kp, vp=vp, kw=kw, qlw=qlw:
                              ops.paged_verify_attention(qw, kp, vp, tab, kv, qlw, **kw), bitwise)
        rtab, rkv = table(rkvl, ps, maxP, P)
        Nt = sum(qln)
        qr = torch.randn(Nt, Hkv * G, D, generator=g, device=dev).to(torch.bfloat16)
        kn, vn = (torch.randn(Nt, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        qs = torch.tensor([sum(qln[:b]) for b in range(len(qln))], dtype=torch.int32, device=dev)
        ql_ = torch.tensor(qln, dtype=torch.int32, device=dev)
        out[f"K6 {label}"] = (lambda i=0, qr=qr, kn=kn, vn=vn, rtab=rtab, rkv=rkv, kp=kp, vp=vp,
                              kw=kw, qs=qs, ql_=ql_, Nt=Nt:
                              ops.ragged_prefill_attention(qr, kn, vn, kp, vp, rtab, qs, ql_, rkv,
                                                           chunk_cap=Nt, **kw), bitwise)

    # K3 at starcoder2's admission (D = 128, bf16 and f32), zamba2's shared attention
    # (D = 64) and hubert's encoder (D = 80, not causal), bitwise; at gemma2's local
    # and global prefill (D = 256: the wgmma body where the checkout has it), timed
    flash = [("starcoder2 S=512 D=128 bf16", 4, 36, 4, 512, 128, torch.bfloat16, True, None,
              None, [512, 475, 256, 171], True),
             ("starcoder2 S=512 D=128 f32", 4, 36, 4, 512, 128, torch.float32, True, None,
              None, [512, 475, 256, 171], True),
             ("zamba2 S=512 D=64 bf16", 4, 32, 32, 512, 64, torch.bfloat16, True, None, None,
              [512, 475, 256, 171], True),
             ("hubert S=512 D=80 bf16", 4, 16, 16, 512, 80, torch.bfloat16, False, None, None,
              [512, 400, 130, 1], True),
             ("gemma2 local D=256", 2, 16, 8, 4608, 256, torch.bfloat16, True, 4096, 50.0,
              [4608, 300], False),
             ("gemma2 global D=256", 2, 16, 8, 4608, 256, torch.bfloat16, True, None, 50.0,
              [4608, 300], False)]
    for label, B, H, Hkv, S, D, dt, causal, window, softcap, kvl, bitwise in flash:
        g.manual_seed(S + D + H)
        q, k, v = (torch.randn(B, h, S, D, generator=g, device=dev).to(dt)
                   for h in (H, Hkv, Hkv))
        kv = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out[f"K3 {label}"] = (lambda i=0, q=q, k=k, v=v, kv=kv, kw=dict(
            causal=causal, window=window, softcap=softcap): ops.flash_attention(
            q, k, v, kv, **kw), bitwise)
    # the dense decode / verify kernel (this checkout's, where it has one) at
    # starcoder2's decode (B = 4, 36 / 4 heads of 128, T = 1024; int8 and f32 cache)
    dense = getattr(ops, "dense_decode_attention", None)
    for cdt in ((torch.int8, torch.float32) if dense is not None else ()):
        B, T, H, Hkv, D = 4, 1024, 36, 4, 128
        g.manual_seed(T + (cdt == torch.int8))
        q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
        qw = torch.randn(B, 4, H, D, generator=g, device=dev).to(torch.bfloat16)
        if cdt == torch.int8:
            kc, vc = (torch.randint(-127, 128, (B, T, Hkv, D), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            sc = {n: torch.rand(B, T, Hkv, 1, generator=g, device=dev) * 0.02 + 1e-3
                  for n in ("k_scale", "v_scale")}
        else:
            kc, vc = (torch.randn(B, T, Hkv, D, generator=g, device=dev) for _ in range(2))
            sc = {}
        cl = torch.tensor([T, T - 3, T // 2 + 1, 1], device=dev)
        ql = torch.tensor([4, 1, 3, 2], device=dev)
        name = "int8" if cdt == torch.int8 else "f32"
        out[f"DA decode {name} cache"] = (lambda i=0, q=q, kc=kc, vc=vc, cl=cl, sc=sc:
                                          dense(q, kc, vc, cl, **sc), True)
        out[f"DA verify q_win=4 {name} cache"] = (
            lambda i=0, qw=qw, kc=kc, vc=vc, cl=cl, ql=ql, sc=sc:
            ops.dense_verify_attention(qw, kc, vc, cl, ql, **sc), True)

    prepare = getattr(MQ, "prepare_served", None)
    gemms = [(m, k, n) for m in (4, 128, 2048) for k, n in ((4608, 4608), (4608, 512),
                                                         (4608, 18432), (18432, 4608))]
    gemms += [(4, 768, 3352), (2048, 768, 3352)]
    for M, K, N in gemms:
        g.manual_seed(M + K + N)
        qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N))))
        qws = [torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
               for _ in range(n_copies)]
        if prepare is not None:
            qws = [prepare({"qw": w})["qw"] for w in qws]
        a = torch.rand(M, 1, generator=g, device=dev) + 0.01
        sw = torch.rand(N, generator=g, device=dev) + 0.01
        out[f"K2 M={M} K={K} N={N}"] = (lambda i=0, qx=qx, qws=qws, a=a, sw=sw:
                                         ops.qgemm_w8a8(qx, qws[i % len(qws)], a, sw), True)
    from repro_torch.core import packing
    for M in (4, 2048):
        K, N = 4608, 18432
        g.manual_seed(M)
        qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        keep = torch.ones(K // 64, N // 64, dtype=torch.bool, device=dev)
        keep[1::2] = False
        keep = keep.repeat_interleave(64, 0).repeat_interleave(64, 1).to(torch.uint8)
        qws = [torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
               * keep.to(torch.int8) for _ in range(2)]
        mask = packing.pack_mask(keep, axis=0)
        occ = ops.tile_occupancy(mask, K)
        a = torch.rand(M, 1, generator=g, device=dev) + 0.01
        sw = torch.rand(N, generator=g, device=dev) + 0.01
        out[f"K7 M={M} K={K} N={N} alt"] = (
            lambda i=0, qx=qx, qws=qws, a=a, sw=sw, mask=mask, occ=occ:
            ops.qgemm_w8a8_sparse(qx, qws[i % 2], a, sw, mask, occ), True)
    # K8 (W4A8 g128) at chip_smoke's shapes, the up projection and the down shard of
    # tp=2, and its group-acc mode at the shard
    for M in (4, 128, 2048):
        for K, N in ((4608, 18432), (9216, 4608)):
            g.manual_seed(M + K)
            qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
            n_copies = max(1, min(32, math.ceil(3 * L2_BYTES / (K * N // 2))))
            qws = [torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                                 dtype=torch.int8) for _ in range(n_copies)]
            a = torch.rand(M, 1, generator=g, device=dev) + 0.01
            sw = torch.rand(K // 128, N, generator=g, device=dev) * 0.01 + 1e-4
            out[f"K8 M={M} K={K} N={N}"] = (lambda i=0, qx=qx, qws=qws, a=a, sw=sw:
                                             ops.qgemm_w4a8(qx, qws[i % len(qws)], a, sw),
                                             True)
            if M <= 128 and K == 9216:          # its (M, K/128, N) int32 output is kept
                out[f"K8 group-acc M={M} K={K} N={N}"] = (
                    lambda i=0, qx=qx, qws=qws: ops.qgemm_w4a8_group_acc(
                        qx, qws[i % len(qws)]), True)
    return out


def run(root: Path, out_file: Path, only: tuple = ()) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    _, log = build.build(verbose=True)
    build.library()
    sys.path.insert(1, str(HERE))
    from chip_smoke import graph_ms, ptxas_summary
    ptxas = [line for line in ptxas_summary(log) if line.startswith(PTXAS_KERNELS)]
    dev = torch.device("cuda", 0)
    res = {}
    with torch.no_grad():
        for name, (call, bitwise) in cases(torch, dev, ops).items():
            if only and not name.startswith(only):
                continue
            before = dict(ops.BODY_LAUNCHES)
            o = call()
            torch.cuda.synchronize()
            ran = sorted(k for k, v in ops.BODY_LAUNCHES.items() if v != before[k])
            ms = graph_ms(call, 20 if "M=2048" in name or name.startswith(("K6", "K3"))
                          else 50)
            res[name] = dict(out=o.cpu(), ms=ms, bitwise=bitwise, bodies=ran)
    torch.save(dict(results=res, ptxas=ptxas, root=str(root)), out_file)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="the other checkout's root")
    ap.add_argument("--json", type=Path, help="also write the rows to this file")
    ap.add_argument("--only", default="", help="comma-separated case-name prefixes "
                    "(K2,K7: the GEMM cases); every case where empty")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run is not None:
        run(args.run.resolve(), args.out, tuple(p for p in args.only.split(",") if p))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"kernel_ab: {smi}")
    base = args.base.resolve()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (side, root) in enumerate((("base", base), ("change", HERE), ("change", HERE),
                                          ("base", base))):
            f = Path(tmp) / f"{i}.pt"
            env = dict(os.environ, PYTHONPATH=str(root / "src"))
            subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--run", str(root),
                            "--out", str(f), "--only", args.only], check=True, env=env)
            runs.setdefault(side, []).append(torch.load(f))
    for side in ("base", "change"):
        for line in runs[side][0]["ptxas"]:
            print(f"kernel_ab: ptxas {side}: {line}")
    rows, bad = [], []
    for name, new in runs["change"][0]["results"].items():
        old = runs["base"][0]["results"].get(name)
        ms_new = min(r["results"][name]["ms"] for r in runs["change"])
        if old is None:
            print(f"kernel_ab: {name}: base missing; change {ms_new:.4f} ms {new['bodies']}")
            continue
        ms_old = min(r["results"][name]["ms"] for r in runs["base"])
        same = torch.equal(old["out"], new["out"])
        diff = float((old["out"].float() - new["out"].float()).abs().max())
        if new["bitwise"] and not same:
            bad.append(name)
        rows.append(dict(case=name, base_ms=ms_old, change_ms=ms_new, ratio=ms_new / ms_old,
                         bitwise=same, max_diff=diff, base_bodies=old["bodies"],
                         change_bodies=new["bodies"]))
        print(f"kernel_ab: {name}: base {ms_old:.4f} ms {old['bodies']} change {ms_new:.4f} ms "
              f"{new['bodies']} ratio {ms_new / ms_old:.3f} bitwise={same} max|diff|={diff:.3e}")
    if args.json is not None:
        args.json.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    if bad:
        print(f"kernel_ab: not bitwise: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

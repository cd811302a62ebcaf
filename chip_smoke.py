#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold each of its
hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. torch/CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a), one line
   per kernel with its registers, spill bytes and whether ptxas serialized its
   wgmma.
3. Each kernel against its plain version on the card, at the main path's shapes,
   with its time, the plain version's, a one-call library yardstick where one
   exists, and the bound the card's data-sheet peaks allow. Times are device
   times: many calls captured in a CUDA graph and replayed. ``call_ms`` is the
   time of back-to-back calls from Python, host dispatch included. K1 at M=4 and
   2048 x K=4608 and 18432: its split, rows and sweep bodies each held against the
   plain version (codes off by one on <= 1e-5 of them, a within one ulp) eagerly
   and under graph replay, and timed side by side. K2 at the linears' shapes: each
   of its bodies that takes a shape (split-K decode body for M <= 128, wgmma body
   for M > 32, 64 x 64 tile body) held bitwise and timed side by side at M=4, 20,
   33, 64, 128, 512 and 2048, with torch._int_mm (qx zero-padded to 32 rows below
   that) and the GB/s reached; wherever the plan routes to the wgmma body it must
   have beaten the tile body;
   K3 at S=128/512, its bf16 tensor-core body against SDPA and its f32 body;
   K4/K5 over f32, bf16 and int8 pools, bf16 q on the split tensor-core body
   timed beside the f32-q body on the same values;
   K6 (ragged prefill) on the packed blocks of a chunked step with f32 and int8
   pools (both bodies timed), a dead slot, an all-sentinel row and q_len = 1
   rows bitwise equal to K4, and a fixed case whose outputs all lie in [4, 8)
   with plain values near bf16 midpoints; K7 (block-sparse W8A8) on its decode
   and wgmma bodies at the up and down projections, M=4, 32, 64, 128 and 2048,
   over alternating empty k-tiles, a random half of the tiles empty, an empty
   128-column block, an empty split range and an all-ones table, bitwise equal to
   the plain version and to K2 eagerly and under graph replay, timed beside K2's
   body on the same weights (it must beat K2 wherever a tile is empty, and stay
   within 5 % of it on the all-ones table, 10 % at M=64), and its tile body at
   M=4 and 2048 beside them, bitwise and timed, also reached through the
   wrapper; K8 (W4A8 g128) at M=4, 33, 128 and
   2048 x the four linears, its decode, wgmma and tile bodies f32-close eagerly
   and under graph replay and timed side by side; a body the plan routes to
   must have beaten the tile body.
   The dense zoo's shapes: K3 at gemma2-9b's local layers (S=4608, D=256, window
   4096, softcap 50) and at hubert-xlarge's encoder (D=80, not causal, both bodies,
   SDPA with a boolean mask beside it); K4, K5 and K6 at gemma2's local layers over
   an int8 pool where the leading split partitions lie wholly behind the window;
   K2 at nemotron-4-15b's untied head (K=6144, N=256000, M=4 and 128) on weights
   prepared on the fly, with torch._int_mm beside it.
   The MoE slice's expert-batched modes ([3m]): K1's rows body over granite's 40
   experts x 8 decode rows (K=1536, per-expert column factors; bitwise at α=1,
   the dense bar at α=0.15), K2's decode body at granite's up/gate and down and
   llama4-scout's up (E=16, K=5120, N=8192), its wgmma body at granite's C=512
   and C=128 dispatch buffers, and the tile body beside them, each bitwise
   against the per-expert plain version eagerly and under graph replay.
   The SSM and hybrid slice's shapes ([3s]): K1 at K=768, 1536, 2048 and 4096
   (the in/out projections of mamba2-130m and zamba2-1.2b), M=4 and 2048; K2's
   tile body at mamba2's in_proj (K=768, N=3352, off the 16-column grid), M=4
   and 2048, bitwise eagerly and under graph replay, beside torch._int_mm and
   the decode or wgmma body on the weight padded to N=3360; K2's routed bodies
   at zamba2's in_proj (N=8384) and out_proj and mamba2's out_proj; K3 bf16 at
   B=4, H=Hkv=32, D=64, S=512 beside SDPA; K4 with bf16 q over an int8 and an
   f32 pool at group size 1.
   The tensor-parallel slice's modes ([3t]) at starcoder2-7b's row-parallel shard
   shapes at tp=2 (wo K=2304, down K=9216, N=4608; M=4, 128, 2048): K1's given-max
   mode on a row's column shard, bitwise the whole row's codes and scales sliced,
   against its plain version bitwise at α=1 and within K1's bar at α=0.15, timed
   beside K1's own body on the same shape; K2's int32-out mode on every body,
   bitwise against the plain product and torch._int_mm (the library column), its
   accumulator dequantized in the epilogue order bitwise K2's output, timed beside
   K2's f32 body; K7's int32-out mode over alternating empty k-tiles; eager and
   under graph replay. Data-parallel, W4A8, expert_tp and SSM sharding ([3u]):
   K8's group-acc mode (the (M, G, N) int32 per-group partials) at starcoder2-7b's
   wo and down shards
   at tp=2 (K=2304 and 9216, g128, N=4608; M=4, 128, 2048) on every body, bitwise
   against the plain per-group product and timed beside K8's own mode; the
   expert-batched K1 in its given-max mode and K2 in its int32-out mode at
   granite-moe's down shard under expert_tp (E=40, K=256, N=1536; C=8 and 512),
   bitwise (K1 against the whole rows sliced, and its plain version at α=1; within
   K1's bar at α=0.15), timed beside their own modes; eager and under graph
   replay.
   bf16 outputs (K3, K4-K6 with bf16 q) pass where within 2e-2 of the plain
   version or within one bf16 ulp of it rounded to bf16.
4. The main path at full width and depth: starcoder2-7b (32 layers) initialised
   from a seeded generator, calibrated (2 batches), quantized to W8A8 static-c
   CrossQuant (and, from the same tables, to W4A8 g128), and served through
   ``ServeEngine(path="fused-int8")``: on the dense continuous layout with fp and
   int8 KV; on the paged layout with radix prefix reuse, fp and int8 KV, over
   traffic that shares a 389-token system prefix; paged with ``speculate=4``
   over motif-tiled prompts; chunked (token budget 128) over the shared-prefix
   traffic, fp and int8 KV; with ``sparsity="2:4"`` (K2 serves it), then with
   every other 64-row k-tile of those masks emptied (K7 serves it, 4 requests);
   and the W4A8 tree (K8). The paper's own paths (no kernel of their own): on the
   f32 tree, before it is freed, ``make_sparsity_plan`` over the launcher's
   calibration traffic (every linear's §4.1 CrossQuant kernel fraction beside its
   per-token one, min / median / max per kind, ``table1_stats`` of layer 0's wq
   and down inputs, whose kernel count on the card must equal the CPU's under the
   same scale tensor), fake W8A8 CrossQuant serving (dense fp KV; paged int8 KV
   behind the shared prefix) and the W8-Remove-Kernel ablation over one admission
   whose down-projection input exceeds 2^24 elements; then ``path="dequant-fp"``
   on the W8A8 tree (dense fp KV, paged int8 KV), the fake twin
   (``dequantize_tree``, static c, prequantized weights) served, twin and
   dequant-fp logits held against fused-int8's (d on the first decode step within
   5 % of max|logit|, greedy choices equal where fused-int8's top-1/top-2 margin
   exceeds 2d), 2:4 restricted to the plan's layers (``sparsity_plan=``) and the
   grouped scheduler. The fake and dequant-fp runs launch no K1, K2, K7, K8 or
   flash kernel; their paged decode steps launch K4. Each run's kernel launch
   counts must equal what its schedule implies, per body too: K1's split body
   serves the steps of at most 32 token rows, its rows body the rest; K2's, K7's
   and K8's decode bodies serve
   the steps of at most DECODE_MAX_M token rows, their wgmma bodies the rest, K3's
   bf16 body every flash launch, the paged bf16 body every K4/K5/K6 launch.
   Between the runs, torch.profiler windows over a few decode steps of the dense
   fp-KV engine, a few packed steps of the chunked one and a few decode steps of
   the block-sparse and of the W4A8 one print the device-busy share, the longest
   device ops, K1's, K2's, K7's and K8's device time per step, the host ops with
   the most self time, and kernel launches and host syncs per step.
   Then the rest of the dense zoo, each model's trees freed before the next, with
   its peak device memory: gemma2-9b FULL (42 layers, local/global attention with
   softcaps) calibrated, quantized and served fused-int8 dense (fp KV), paged with
   int8 KV over a 4600- and a 300-token prompt at max_len 8192 (the window binds in
   K3 and K4) and chunked (int8 KV, budget 512, K6 past the window);
   nemotron-4-15b at full width cut to 8 of its 32 layers (calibration needs the f32
   tree), whose untied head is prepared on the fly every step (one more K1 and K2
   per model step; its cost printed beside a tied twin); hubert-xlarge FULL through
   ``make_prefill_step`` over 4 x 512 seeded frames (K3 at D=80, not causal), its
   logits held against dequant-fp's. Each with launch counts per body.
   The MoE slice ([4m]): granite-moe-3b-a800m FULL (32 layers, 40 experts top-8)
   calibrated, quantized and served fused-int8 dense (fp and int8 KV), paged
   behind the shared prefix (int8 KV), paged speculate=4 and chunked (int8 KV,
   budget 512), 224 K1 and 224 K2 launches per model call (96 of them
   expert-batched, one per stacked linear); llama4-scout-17b-a16e at full width
   cut to 2 of 48 layers, dense fp KV (10 K1 and 10 K2 a layer).
   The SSM and hybrid slice ([4s]): mamba2-130m FULL (24 layers) and zamba2-1.2b
   FULL (38 Mamba2 layers, the shared attention + MLP block after each of 6
   super-blocks, a 2-layer tail) calibrated, quantized and served fused-int8
   dense (fp and int8 KV) and paged without prefix reuse (fp and int8 KV; one
   state page per slot), fake and dequant-fp dense: 48 and 118 K1/K2 launches
   per model call (mamba2's in_proj on K2's tile body), 6 K3 per zamba2
   admission and 6 K4 per paged decode step; tok/s, model call, peak memory
   and state bytes per slot; speculate=4, paged prefix reuse and chunked
   refused with the reference's typed errors. [4t] profiler windows over 3
   dense and 3 paged decode steps of each (launches, syncs, busy share, the
   Mamba2 block's plain ops under ``record_function`` ranges) and one 4 x 512
   admission (the SSD scan's device time).
5. The same width cut to 2 layers (float32): one admission prefill through the
   flash path and 8 greedy decode steps on the dense and on the paged layout,
   the same prompts through packed chunked steps (K6, fp and int8 KV), and the
   paged run on a block-sparse tree (K7) and on the W4A8 tree (K8), kernels on
   the card against the plain versions on the CPU (flash on its f32 body): equal
   greedy tokens, logits
   within 5e-2 of max|logit| (beside what a one-ulp input nudge does on the CPU
   alone); chunked fp KV gives the bucketed tokens. The paged run again in
   bf16 (flash's and the paged bf16 bodies): card logits within e of the CPU's,
   greedy choices equal wherever the CPU's top-1/top-2 margin exceeds 2e, where e
   is what bf16 instead of f32 moves the card's first decode step. Then the
   engine on the card: paged ≡ dense, speculate=4 ≡ speculate=1 and chunked ≡
   bucketed in greedy tokens. The paper's paths at that size, card vs CPU with
   equal greedy tokens: fake W8A8 CrossQuant (dense fp KV), dequant-fp (paged
   int8 KV) and the grouped scheduler through the engine; and
   ``make_sparsity_plan``'s per-linear fractions within 1e-6 of the CPU's over
   the same activations (the card's observer pass replayed into the CPU's plan;
   the CPU's own forward pass printed beside). The zoo at 2 layers (deepseek,
   pixtral and hubert at 1), card against CPU: gemma2-9b with its window cut to 48 (dense, paged ≡ dense, chunked fp and
   int8 KV, chunked fp ≡ bucketed, bf16 paged under the self-calibrated bar, and
   speculate=4 ≡ 1 on the card), deepseek-coder-33b (a prefill and 8 decode steps,
   and a chunked engine on the card whose packed steps launch all token_budget rows
   into the on-the-fly head), pixtral-12b (a 320-token prefill whose first 256
   positions are bf16 patch embeddings, 4 decode steps) and hubert-xlarge (encoder
   logits). The untied heads' runs feed the CPU the card's tokens and hubert's
   compare position by position: greedy choices equal wherever the CPU's top-1/
   top-2 margin exceeds twice the largest logit gap. The MoE models ([5m]):
   granite at 1 layer (dense; paged ≡ dense on the card; capacity_factor 0.25,
   an admission that drops (token, k) pairs) and llama4-scout at 1 layer, each
   held three ways, since an int8 code one step apart swaps a near-tied expert:
   every routing the card met equals the CPU's on the same inputs, the card's
   kernels give its plain path's greedy tokens, and the CPU fed the card's
   tokens stays within twice what a one-ulp nudge of the embedding moves it.
   The SSM and hybrid models ([5s]): mamba2 at 1 of 24 layers and zamba2 at 8
   of 38 (a super-block, the shared block, the 2-layer tail), card against
   CPU: equal free-running greedy tokens and logits within 5e-2 of max|logit|,
   or, where a near tie parts the tokens, [5m]'s three-way bar; the paged
   layout (state_table, page table, K4) against the dense one on the card.
6. The async replica server (``serving.server.AsyncServer``) on phase 4's
   calibrated starcoder2-7b FULL W8A8 tree (rebuilt from the same seed and
   calibration, since phase 4 frees it before the zoo): fused-int8, paged, int8 KV, batch 4
   per replica, max_len 1024, 16 requests in two prefix families (a 256-token
   shared prefix each, suffixes of 32-192 tokens, 16 new tokens each), affinity
   routing, with 2 replicas sharing the card (a thread and a CUDA stream each)
   and with 1: aggregate tok/s, TTFT and TPOT p50/p95, affinity hits, the prefix
   hit rate per replica, peak memory. Every stream equals the engine alone fed
   the same prompts in the same per-replica order (held with ``pause()`` until
   each replica's share is in its inbox); launch counts per body equal the
   schedule of both threads' model calls and join phase 4's totals. Then replica
   0 fails at its step 3 (``FailureInjector``): every request completes on the
   survivor, its tokens before the failure equal the engine alone's and the
   survivor's continuation equals the engine alone fed the continuations in
   requeue order; replica 0 is live again and serves; the peak across the
   failure and restart stays within one engine's caches of the 2-replica run's.
   Last, a one-slot server rejects with ``pool_pressure`` and ``queue_full``.
7. Training on the card (the port's training half; no hand-written kernel runs
   while training, as the reference trains with ``use_pallas=False``), after
   phase 6's tree is freed. [7a] one f32 ``make_train_step`` step of
   starcoder2-7b at full width cut to 1 layer, B = 1, S = 64, on the card and
   on the CPU from the same seeded params and batch, TF32 off: the loss, the grad
   norm and the first Adam moment per leaf within ``LOSS_RTOL``, ``GNORM_RTOL``
   and ``MOMENT_RTOL``. [7b] starcoder2-7b at full width cut to 2 of 32 layers
   (f32 params, grads and both moments; bf16 activations), batch 4 x 512,
   n_micro 2, remat, Markov batches: 2 warm-up and 6 measured steps (step ms,
   training tok/s, the 6·N·tokens model-FLOPs share of the bf16 peak, peak
   memory over what is held), finite losses, the last below the first; one
   step under the profiler (launches, syncs, busy share); 2 steps with int8
   CrossQuant gradient compression (finite losses, a nonzero error state).
   [7c] the trained params through a blocking ``CheckpointManager`` round trip
   (bitwise), ``calibrate_and_quantize`` to W8A8 static-c CrossQuant, served
   fused-int8, paged, int8 KV (4 requests x 16 new tokens) with K1-K4 launch
   counts per body equal to the schedule and the tokens equal to those of the
   in-memory trained tree; the §4.1 kernel fractions of the trained linears.
   [7d] ``launch.train.run`` on mamba2-130m FULL: 12 steps of 4 x 256, a
   checkpoint every 4, a failure at step 6, against the same run
   uninterrupted: one restart, the history truncated at the restore point,
   final params bitwise equal; the ops of one train step without a
   deterministic implementation
   (``torch.use_deterministic_algorithms(True, warn_only=True)``) are printed.

8. Tensor- and expert-parallel serving: two ranks spawned on the one card in
   processes of their own, a gloo process group over CUDA tensors (NCCL refuses
   two ranks on one device). The parent builds each FULL W8A8 tree once and serves
   it single-device; the ranks take it by CUDA IPC and copy only their shards.
   starcoder2-7b FULL at tp=2 (tp_full, 18/2 heads a rank; row-parallel wo and
   down through K1's given-max and K2's int32-out modes), dense and paged with
   int8 KV, 4 requests x 16 tokens; granite-moe-3b-a800m FULL at ep=2 (20 of 40
   experts a rank), dense int8 KV. On both ranks: tokens equal the single-device
   engine's, every logits row the sampler saw bitwise, launches per body and
   collectives per model call equal the schedule (starcoder2: 64 int32 SUMs, 64
   MAXes, the embedding's SUM and the logits' gather; granite: 32 expert
   gathers), a starcoder2 rank holding about half the weights; tok/s and model
   call ms printed beside the single-device engine's (2 ranks sharing one H100
   over gloo; nothing claimed). Where a rank's decode call goes: each collective
   is timed between two device syncs (the gloo CUDA path waits for the card
   before it stages a tensor anyway), which splits the call into the wait for
   the card before each collective, the collectives themselves (the peer rank's
   arrival included) and the host's remainder; then the same collectives alone,
   both ranks in step after a barrier, 20 times each. A failing rank fails the
   run. Data-parallel, W4A8, expert_tp and SSM sharding, each against the
   single-device engine in this call: starcoder2-7b FULL at data 2 (paged, int8
   KV, the shared-prefix traffic: each rank runs its own 2 slots against a whole
   page pool, one allocator and radix index; one gather of the final hidden rows
   and one K/V-row exchange a model call; a rank holds all the weights);
   starcoder2-7b FULL W4A8 g128 at tp=2 over short prompts (the row-parallel wo
   and down through K1's given-max mode and K8's group-acc mode,
   the per-group products gathered in chunks of at most 256 MiB); granite-moe FULL
   with its plan forced to expert_tp at tp=2 (every expert's d_ff_expert halved;
   down through the expert-batched K1 given-max and K2 int32-out modes); mamba2-130m
   and zamba2-1.2b FULL at tp=2 on the paged layout (the state heads over the two
   ranks, in_proj's output and the scan's output gathered). Each: the single
   engine's number of sampler calls; logits bitwise where the kernels carry every
   product of both engines the same way (data 2, expert_tp, mamba2, zamba2), and
   where they do not (W4A8: the group products summed after the gather, not in
   K8's fold) every call's max|d logit| within 5e-2 of max|logit| up to the first
   call whose greedy tokens part; a parting only at a near tie inside that bar
   (the single engine's top-1/top-2 margin at most twice the call's max|d
   logit|), else tokens equal; launches per body and collectives per call equal
   the schedule; a rank's weight share printed and held near its expectation
   (0.5 at tp=2, 1.0 at data 2). The norms' row statistics of 2 rows against the
   same rows among 4 are counted (torch's mean, and the norms as served).
   mamba2-130m FULL at data 2 (paged: each rank its own 2 slots and their state
   pages; the gated norm served through ``F.rms_norm``): bitwise every call.
9. Sharded training (``make_train_step(layout=)``): two ranks spawned on the one
   card over gloo, as [8]; the parent runs the one-device step on the card and
   hands the ranks the initial params, the batches and its first moment after
   each step by CUDA IPC. starcoder2-7b full width cut to 2 of 32 layers (f32
   params and moments, TF32 off) at data 2 (FSDP) and at model 2 (tp_full), and
   granite-moe-3b-a800m full width cut to 2 layers at data 2 against the
   one-device step at G = 2 (the grouped dispatch): batch 4 x 512, n_micro 2, 2
   steps, each step's loss, grad norm and every rank's shard of the first
   moment within phase 7's bars; step ms of a rank beside one device's, the
   collectives of a step by kind and their ms, a rank's bytes of params + m + v
   over one device's and its peak memory (2 ranks on one card over gloo: no
   multi-card speed is claimed).

The last line is ``{"ok": true, "device": {...}}``; the line before it is the card's
nvidia-smi name and power limit, and the one before that the kernels' JSON.
Exits non-zero without printing a result when no CUDA card is visible.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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
SERVER_PREFIX, SERVER_SUFFIX, SERVER_REQUESTS = 256, (32, 193), 16   # phase 6's traffic
SUFFIXES = [20, 150, 60, 300, 40, 200, 90, 10]
MOTIF = 16                                         # speculative traffic: tiled motifs
CHUNK_BUDGET = 128                                 # tokens per packed chunked step
# phase 7's card-against-CPU bars on one f32 train step (measured on the H100:
# 1.6e-7, 0 and 3.8e-6)
LOSS_RTOL, GNORM_RTOL, MOMENT_RTOL = 1e-5, 1e-5, 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v``'s log: its name with
    its mangled template arguments (``qgemm_wgmma_kernel<Li128ELb1E>``), registers,
    spill bytes, and whether ptxas serialized its wgmma (C7520); then any line
    that names an error or a warning."""
    kernels, other, serial, name = {}, [], [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            n = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if n:
                start = n.end()
                name = mangled[start:start + int(n.group(1))]
                args = re.match(r"I(\w*?E)E", mangled[start + int(n.group(1)):])
                name += f"<{args.group(1)}>" if args else ""
            else:
                name = mangled
            kernels[name] = {}
        elif name is not None and (n := re.search(r"(\d+) bytes spill stores", line)):
            kernels[name]["spill"] = int(n.group(1))
        elif name is not None and (n := re.search(r"Used (\d+) registers", line)):
            kernels[name]["regs"] = int(n.group(1))
        elif "C7520" in line:
            serial.append(line)
        elif "error" in line or "warning" in line:
            other.append(line.strip())
    for line in serial:                        # ptxas prints these before the kernels
        for k, v in kernels.items():
            if k.split("<")[0] in line and k.split("<")[-1].rstrip(">") in line:
                v["serialized"] = True
    return [f"{k}: {v.get('regs')} registers, {v.get('spill', 0)} bytes spill"
            + ("; wgmma serialized (C7520)" if v.get("serialized") else "")
            for k, v in kernels.items()] + other


def bound(bytes_moved: float, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops over peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_bar(out, plain, atol: float = 2e-2):
    """The bar on a bf16 kernel output against its plain version: an element passes
    where |out - plain| <= atol, or where out lies within one bf16 ulp of plain
    rounded to bf16, the ulp taken at |bf16(plain)|: 2^(floor(log2|x|) - 7). Below
    |plain| = 2 the second arm admits nothing the first does not; above it, it
    admits the one rounding a bf16 output can take across a midpoint, which atol
    alone refuses from |plain| = 4 on (one ulp there is 0.031), so the bar does not
    depend on where the draw puts the plain values. Returns (every element passes,
    the number that only the ulp arm passed)."""
    import torch

    o, p = out.float(), plain.float()
    near = (o - p).abs() <= atol
    pb = p.to(torch.bfloat16).float()
    by_ulp = (o - pb).abs() <= torch.exp2(torch.floor(torch.log2(pb.abs())) - 7)
    return bool((near | by_ulp).all()), int((by_ulp & ~near).sum())


def empty_odd_k_tiles(tree) -> None:
    """Empty every other 64-row k-tile of every masked linear of a stacked tree, in
    place (codes and packed mask): a block-structured mask whose empty tiles the
    sparse GEMM (K7) skips."""
    for node in (tree["blocks"][0]["attn"], tree["blocks"][0]["mlp"]):
        for leaf in node.values():
            L, K = leaf["qw"].shape[:2]
            leaf["qw"].view(L, K // 64, 64, -1)[:, 1::2] = 0
            leaf["mask"].view(L, K // 64, 8, -1)[:, 1::2] = 0


#: the quantizable linears of a starcoder2 layer, in the order a forward pass calls them
KINDS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/up", "mlp/down")


def linear_shapes(cfg):
    """(K, N) of a layer's quantized linears in the order a forward pass calls them:
    wq, wk, wv, wo, up, gate (GLU activations only), down."""
    d, hd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    glu = [(d, cfg.d_ff)] if cfg.act.endswith("_glu") else []
    return [(d, hd), (d, kvd), (d, kvd), (hd, d), (d, cfg.d_ff)] + glu + [(cfg.d_ff, d)]


def recorded_plan(make_plan, KA, cfg, params, batches, **kw):
    """``make_plan(cfg, params, batches, **kw)`` (``make_sparsity_plan``) with every
    activation its observer pass measures recorded: ``KA.crossquant_kernel_fraction``
    is wrapped for the call. Returns (plan, records), one record per measured
    linear input in call order (batch, layer, KINDS): the 2-D f32 input, its
    CrossQuant kernel fraction and its per-token (α = 1) one."""
    import torch

    records = []
    measure = KA.crossquant_kernel_fraction

    def recording(x2, bits=8, alpha=0.15):
        frac = measure(x2, bits=bits, alpha=alpha)
        records.append((x2, float(frac), float(KA.per_token_kernel_fraction(x2, bits))))
        return frac

    KA.crossquant_kernel_fraction = recording
    try:
        with torch.no_grad():
            plan = make_plan(cfg, params, batches, **kw)
    finally:
        KA.crossquant_kernel_fraction = measure
    L = cfg.n_layers
    check(len(records) == len(batches) * L * len(KINDS), f"plan pass measured {len(records)} "
          f"linear inputs, not {len(batches)} x {L} x {len(KINDS)}")
    d_in = {"attn/wo": cfg.n_heads * cfg.head_dim, "mlp/down": cfg.d_ff}
    for i, (x2, _, _) in enumerate(records):
        kind = KINDS[i % len(KINDS)]
        check(x2.shape[-1] == d_in.get(kind, cfg.d_model), f"record {i} ({kind}) has "
              f"width {x2.shape[-1]}")
    return plan, records


def tp_rank(rank: int, port: int, job: dict, queue) -> None:
    """One rank of phase [8], in a process of its own on the one card: join the
    gloo world of two, then for each of ``job["runs"]`` build the sharded engine
    from the parent's full prepared tree (CUDA IPC: the rank copies only its
    shard), serve the run's requests and check every launch per body and every
    collective against the schedule, timing the collectives of its decode calls
    and then the same collectives alone. Puts (rank, "ok", results) on
    ``queue``, or the traceback and re-raises: a failing rank exits non-zero."""
    import datetime
    import traceback
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import numpy as np
        import torch
        import torch.distributed as dist

        from repro_torch.core.qlinear import W4_GATHER_BYTES
        from repro_torch.kernels import ops
        from repro_torch.kernels.act_quantize import act_quantize_plan
        from repro_torch.kernels.qgemm import DECODE_MAX_M, qgemm_w4a8_plan, qgemm_w8a8_plan
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.sharding import planner as SP
        from repro_torch.models import model as M
        from repro_torch.models.moe import capacity
        from repro_torch.models.quantize import quantized_bytes
        from repro_torch.serving import engine as E
        from repro_torch.serving.config import EngineConfig
        from repro_torch.sharding import collectives as SC

        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=180))
        # Each collective of a decode call, timed between two device syncs: the
        # wait for the card before it, then the collective (the peer's arrival
        # included). The first of each (op, shape, dtype) is kept to replay alone.
        raw = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "broadcast")}
        timed_calls, protos, in_decode = [], {}, [False]

        def timed(name):
            def call(*a, **kw):
                if not in_decode[0]:
                    return raw[name](*a, **kw)
                t = a[1] if name == "all_gather" else a[0]
                key = (name, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                if key not in protos:
                    protos[key] = (t.clone(), len(a[0]) if name == "all_gather" else 0, kw)
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                r = raw[name](*a, **kw)
                torch.cuda.synchronize()
                timed_calls.append((key, t1 - t0, time.perf_counter() - t1))
                return r
            return call

        def alone(key, reps=20):
            """Median ms of ``key``'s collective with both ranks in step."""
            name, _, _ = key
            t, n, kw = protos[key]
            ts = []
            for i in range(reps + 3):
                buf = t.clone()
                args = ([torch.empty_like(buf) for _ in range(n)], buf) if n else (buf,)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                raw[name](*args, **kw)
                torch.cuda.synchronize()
                if i >= 3:
                    ts.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(ts))

        for n in raw:
            setattr(dist, n, timed(n))
        out = {}
        for run in job["runs"]:
            label, cfg = run["label"], run["cfg"]
            mesh = make_debug_mesh(*run["mesh"])
            plan = None
            if run.get("moe_mode"):
                plan = dataclasses.replace(SP.make_serve_plan(cfg, mesh),
                                           moe_mode=run["moe_mode"])
            seen = []
            make = E._make_sampler

            def recording(temperature, top_k):
                inner = make(temperature, top_k)

                def sample(logits, gen):
                    seen.append(logits.cpu().numpy())
                    return inner(logits, gen)
                return sample

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            E._make_sampler = recording
            try:
                engine = E.ServeEngine(cfg, job["trees"][run["tree"]], quant=run["quant"],
                                       device=dev, mesh=mesh, plan=plan,
                                       config=EngineConfig(**run["config"]))
            finally:
                E._make_sampler = make
            shard_bytes = quantized_bytes(engine.params)
            attr = "_admit_cold" if engine.paged else "_admit_step"
            admit, buckets = getattr(engine, attr), []

            def counted(p, tokens, *rest, **kw):
                buckets.append(tokens.shape[1])
                return admit(p, tokens, *rest, **kw)

            setattr(engine, attr, counted)
            rows, ms, split = [], [], []
            apply = M.apply
            timed_calls.clear()
            protos.clear()

            def apply_counted(p, inputs, *rest, **kw):
                in_decode[0] = inputs["tokens"].numel() <= DECODE_MAX_M
                n0 = len(timed_calls)
                t0 = time.perf_counter()
                try:
                    o = apply(p, inputs, *rest, **kw)
                    torch.cuda.synchronize()
                finally:
                    in_decode[0] = False
                rows.append(inputs["tokens"].numel())
                ms.append((time.perf_counter() - t0) * 1e3)
                mine = timed_calls[n0:]
                split.append((sum(w for _, w, _ in mine) * 1e3,
                              sum(c for _, _, c in mine) * 1e3, len(mine)))
                return o

            engine.submit([np.asarray(r, np.int32) for r in run["reqs"]],
                          max_new=run["max_new"])
            torch.cuda.synchronize()
            dist.barrier()
            ops.reset_launches()
            SC.reset_counts()
            M.apply = apply_counted
            t0 = time.perf_counter()
            try:
                done = engine.run()
                torch.cuda.synchronize()
            finally:
                M.apply = apply
            dt = time.perf_counter() - t0
            bodies, counts = dict(ops.BODY_LAUNCHES), dict(SC.COUNTS)
            c = engine.counters
            calls = c["prefill_calls"] + c["decode_steps"]
            if len(rows) != calls:
                raise RuntimeError(f"[8] {label}: {len(rows)} model calls != {calls} steps")
            # the schedule: each (K, N, n) linear n times a model call, on the rows
            # this rank runs (its own slots' under data-parallel slots)
            L = cfg.n_layers
            want = {name: 0 for name in ops.BODY_LAUNCHES}
            want_c = {name: 0 for name in SC.COUNTS}
            for name, n in run["collectives_per_call"].items():
                want_c[name] = n * calls
            for m in rows:
                for K, N, n in run["linears"]:
                    want[f"act_quantize/{act_quantize_plan(m, K)[0]}"] += n
                    want[f"qgemm_w8a8/{qgemm_w8a8_plan(m, K, N)[0]}"] += n
                for K, N, n in run["row_linears"]:
                    want[f"act_quantize/given_{act_quantize_plan(m, K)[0]}"] += n
                    want[f"qgemm_w8a8/i32_{qgemm_w8a8_plan(m, K, N)[0]}"] += n
                for K, N, n in run.get("w4_linears", ()):
                    want[f"act_quantize/{act_quantize_plan(m, K)[0]}"] += n
                    want[f"qgemm_w4a8/{qgemm_w4a8_plan(m, K, N, 128)[0]}"] += n
                for K, N, n in run.get("w4_row_linears", ()):
                    # K1 once on all rows; K8's group-acc and the gather per chunk of
                    # rows whose gathered (rows, G, N) f32 block fits W4_GATHER_BYTES
                    want[f"act_quantize/given_{act_quantize_plan(m, K)[0]}"] += n
                    chunk = max(1, W4_GATHER_BYTES // (K * mesh.axis_size("model") // 128
                                                       * N * 4))
                    for m0 in range(0, m, chunk):
                        mc = min(chunk, m - m0)
                        want[f"qgemm_w4a8/gacc_{qgemm_w4a8_plan(mc, K, N, 128)[0]}"] += n
                        want_c["gather_groups"] += n
                El, C = run["experts_local"], capacity(m, cfg) if run["experts"] else 0
                for K, N in run["experts"]:
                    want[f"act_quantize/experts_{act_quantize_plan(El * C, K)[0]}"] += L
                    want[f"qgemm_w8a8/experts_{qgemm_w8a8_plan(C, K, N, experts=El)[0]}"] += L
                for K, N in run.get("experts_row", ()):
                    want[f"act_quantize/experts_given_{act_quantize_plan(El * C, K)[0]}"] += L
                    want[f"qgemm_w8a8/experts_i32_{qgemm_w8a8_plan(C, K, N, experts=El)[0]}"] \
                        += L
            La = run.get("attn_layers", L)            # attention applications a call
            want["flash_attention/bf16_mma"] = La * sum(b >= 128 for b in buckets)
            want["paged_attention/bf16_mma"] = La * c["decode_steps"] if engine.paged else 0
            if bodies != want:
                raise RuntimeError(f"[8] {label} rank {rank}: body launches "
                                   f"{ {k: v for k, v in bodies.items() if v} } != schedule "
                                   f"{ {k: v for k, v in want.items() if v} } (rows {rows}, "
                                   f"cold buckets {buckets})")
            if counts != want_c:
                raise RuntimeError(f"[8] {label} rank {rank}: collectives {counts} != "
                                   f"schedule {want_c} over {calls} model calls")
            small = [t for m, t in zip(rows, ms) if m <= DECODE_MAX_M]
            dec = [sp for m, sp in zip(rows, split) if m <= DECODE_MAX_M]
            per_call = {}                # collectives of one decode call, by key
            for key, _, _ in timed_calls:
                per_call[key] = per_call.get(key, 0) + 1 / len(dec)
            solo = {key: alone(key) for key in protos}
            out[label] = dict(
                wait_ms=float(np.median([w for w, _, _ in dec])),
                coll_ms=float(np.median([c for _, c, _ in dec])),
                coll_n=int(np.median([n for _, _, n in dec])),
                solo={f"{k[0]} {k[2]}{list(k[1])}": (round(per_call[k], 2), v)
                      for k, v in solo.items()},
                solo_ms=sum(per_call[k] * v for k, v in solo.items()),
                tokens={r.rid: r.out for r in done}, logits=seen, bodies=bodies,
                collectives=counts, calls=calls, prefill_calls=c["prefill_calls"],
                tok_s=sum(len(r.out) for r in done) / dt,
                call_ms=float(np.median(small)) if small else None,
                shard_bytes=shard_bytes, peak=torch.cuda.max_memory_allocated() - mem0,
                plan=engine.plan.describe(), slot_groups=engine.dp,
                prefix_hits=c["prefix_hits"], peak_pages=c["peak_pages_in_use"])
            del engine, done
            torch.cuda.empty_cache()
        for n in raw:
            setattr(dist, n, raw[n])
        queue.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def train_rank(rank: int, port: int, job: dict, queue) -> None:
    """One rank of phase [9], in a process of its own on the one card: join the
    gloo world of two, then for each of ``job["runs"]`` cut its shards of the
    parent's initial params (CUDA IPC), take ``job["steps"]`` sharded train steps
    on the parent's global batches, time each step and each collective, and hold
    every step's loss, grad norm and the rank's shard of the first moment against
    the parent's one-device run. Puts (rank, "ok", results) on ``queue``, or the
    traceback and re-raises: a failing rank exits non-zero."""
    import datetime
    import traceback
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import model as M
        from repro_torch.sharding import collectives as SC
        from repro_torch.training import optimizer as opt_lib, trainer

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=300))
        raw = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
        spent = []                       # (op, ms) of each collective, between two syncs

        def timed(name):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = raw[name](*a, **kw)
                torch.cuda.synchronize()
                spent.append((name, (time.perf_counter() - t0) * 1e3))
                return r
            return call

        for n in raw:
            setattr(dist, n, timed(n))
        out = {}
        for run in job["runs"]:
            label, cfg = run["label"], run["cfg"]
            mesh = make_debug_mesh(*run["mesh"])
            step = trainer.make_train_step(cfg, job["opt"], n_micro=job["n_micro"], mesh=mesh)
            layout = step.layout
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            init = job["inits"][run["tree"]]
            # a leaf no axis splits comes back as the parent's tensor itself: copy it,
            # since the step updates its params in place
            params = M.map_tensors(layout.shard(init), lambda t, f: t.clone() if t is f else t,
                                   init)
            opt = opt_lib.init(params)
            held = sum(t.numel() * t.element_size()
                       for t in M.leaves(params) + M.leaves(opt.m) + M.leaves(opt.v))
            steps = []
            for s, batch in enumerate(job["batches"][run["tree"]]):
                SC.reset_counts()
                spent.clear()
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                loss, gnorm = float(met["loss"]), float(met["grad_norm"])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                ref = job["ref"][run["tree"]][s]
                ref_m = ref["m"]
                mine = layout.shard(ref_m)
                errs = [float((a - b).abs().max() / (f.abs().max() + 1e-30))
                        for a, b, f in zip(M.leaves(opt.m), M.leaves(mine), M.leaves(ref_m))]
                by_op = {}
                for name, t in spent:
                    n_, ms_ = by_op.get(name, (0, 0.0))
                    by_op[name] = (n_ + 1, ms_ + t)
                steps.append(dict(ms=ms, loss=loss, gnorm=gnorm, loss_rel=abs(loss - ref["loss"])
                                  / abs(ref["loss"]), gn_rel=abs(gnorm - ref["gnorm"])
                                  / ref["gnorm"], m_err=max(errs),
                                  counts={k: v for k, v in SC.COUNTS.items() if v},
                                  by_op=by_op))
                del mine
            out[label] = dict(steps=steps, held=held, peak=torch.cuda.max_memory_allocated() - mem0,
                              plan=layout.plan.describe())
            del params, opt, step, layout
            torch.cuda.empty_cache()
        for n in raw:
            setattr(dist, n, raw[n])
        queue.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


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
    from repro_torch.core import packing, qlinear as ql
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.paged_attention import BODIES as paged_bodies
    from repro_torch.kernels.qgemm import (
        DECODE_MAX_M, decode_splits, qgemm_w4a8_cuda, qgemm_w4a8_decode_cuda, qgemm_w4a8_plan,
        qgemm_w4a8_wgmma_cuda, qgemm_w8a8_cuda, qgemm_w8a8_decode_cuda, qgemm_w8a8_plan,
        qgemm_w8a8_sparse_cuda, qgemm_w8a8_sparse_plan, qgemm_w8a8_wgmma_cuda,
        sparse_stage_ranges, w4a8_decode_splits,
        w4a8_wgmma_splits, wgmma_splits,
    )
    from repro_torch.kernels.act_quantize import act_quantize_cuda, act_quantize_plan
    from repro_torch.core import kernel_analysis as KA, quantizers as Q
    from repro_torch.launch.serve import calibrate, calibration_batches, make_prompts
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import QuantContext
    from repro_torch.models.moe import capacity as moe_capacity
    from repro_torch.models.quantize import (
        SparsityPlan, dequantize_tree, make_sparsity_plan, quantize_tree, quantized_bytes,
        sparsify_tree, sparsity_summary, with_tile_occupancy,
    )
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving import engine as serving_engine
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
    for line in ptxas_summary(log):
        print(f"[2]   {line}")

    # ---------------------------------------------------------------- phase 3
    print(f"[3] start at {time.perf_counter() - t_start:.1f}s")
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

    def replay(fn):
        """``fn``'s outputs from one call captured in a CUDA graph, after a replay
        over outputs that were overwritten first."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fn()
        outs = outs if isinstance(outs, tuple) else (outs,)
        for o in outs:
            o.fill_(float("nan") if o.is_floating_point() else 0)
        graph.replay()
        torch.cuda.synchronize()
        return outs

    # K1 act_quantize: every quantized linear's input; bf16 activations (FULL dtype).
    # Each body held against the plain version (codes off by one on <= 1e-5 of the
    # elements, a within one ulp: torch's pow and powf part by an ulp on a few
    # inputs), eagerly and under graph replay, and timed: the split body (cluster
    # of S ranks per row), the rows body (row in registers) and the sweep body (the
    # first design, x read twice) beside them
    k1_shapes = [(m, k) for m in (4, 2048) for k in (4608, 18432)]
    for (Mr, K) in k1_shapes:
        x = (torch.randn(Mr, K, generator=gen, device=dev) * 2).to(torch.bfloat16)
        x[:, torch.randperm(K, generator=gen, device=dev)[:8]] *= 30   # outlier channels
        bcol = torch.rand(K, generator=gen, device=dev) * 3 + 0.25
        alpha = torch.tensor(0.15, device=dev)
        routed, splits = act_quantize_plan(Mr, K)
        bodies = {"split": splits if routed == "split" else 8, "rows": 1, "sweep": 1}
        before = dict(ops.BODY_LAUNCHES)
        q, a = ops.act_quantize(x, bcol, alpha)
        check(ops.BODY_LAUNCHES[f"act_quantize/{routed}"]
              == before[f"act_quantize/{routed}"] + 1,
              f"act_quantize M={Mr} K={K} did not run the {routed} body")
        qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
        torch.cuda.synchronize()
        worst = (0, 0, 0)                            # max |dq|, off-by-one count, a ulps
        for b in [routed] + [b for b in bodies if b != routed]:
            call = (lambda b=b: act_quantize_cuda(x, bcol, alpha, 0.0, 8, b, bodies[b]))
            for qb, ab in (call(), replay(call)):
                torch.cuda.synchronize()
                d = (qb.int() - qr.int()).abs()
                n_off = int((d > 0).sum())
                a_ulps = int((ab.view(torch.int32) - ar.view(torch.int32)).abs().max())
                check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel(),
                      f"act_quantize {b} body M={Mr} K={K}: max |dq|={int(d.max())}, "
                      f"off={n_off}")
                check(a_ulps <= 1, f"act_quantize {b} body scale M={Mr} K={K}: {a_ulps} ulp")
                worst = max(worst, (int(d.max()), n_off, a_ulps))
        check(torch.equal(q, act_quantize_cuda(x, bcol, alpha, 0.0, 8, routed, splits)[0]),
              f"act_quantize M={Mr} K={K}: ops launch differs from the {routed} body")
        body_ms = {}
        for b in [routed] + [b for b in bodies if b != routed] + [routed]:
            t = graph_ms(once(lambda b=b: act_quantize_cuda(x, bcol, alpha, 0.0, 8, b,
                                                            bodies[b])), 200)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        ms = body_ms[routed]
        cms = time_ms(once(lambda: ops.act_quantize(x, bcol, alpha)), 200)
        pms = graph_ms(once(lambda: ref.act_quantize_ref(x, bcol, 8, alpha)), 20)
        nbytes = Mr * K * 2 + K * 4 + Mr * K + Mr * 4
        bms, by = bound(nbytes, 6 * Mr * K, PEAK_OPS["f32"])
        for b, t in body_ms.items():
            results[(f"act_quantize/{b}", Mr, K)] = dict(
                ms=t, call_ms=cms if b == routed else None, plain_ms=pms, library_ms=None,
                bound_ms=bms, bound_by=by, max_abs_err=float(worst[0]))
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3] act_quantize M={Mr} K={K} bf16: routed to the {routed} body (split "
              f"body at {bodies['split']} ranks) "
              f"kernel_ms={ms:.4f} ({times}) call_ms={cms:.4f} plain_ms={pms:.4f} "
              f"library_ms=None bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f} "
              f"max|dq|={worst[0]} off_by_one<={worst[1]}/{q.numel()} a_max_ulp={worst[2]} "
              f"(every body, eager and graph replay)")

    # K2 qgemm_w8a8: wq/wo/down (N=4608), wk/wv (N=512), up (N=18432). The wrapper
    # routes M <= DECODE_MAX_M to the split-K decode body, larger M to the wgmma body
    # and shapes neither takes to the 64 x 64 tile body. Every body that takes a
    # shape is held bitwise and timed side by side (in the order routed, others,
    # routed again; the lower of the routed body's two times is kept) at the decode
    # shapes (M=4), a verify window (M=20), packed chunked steps (M=33, 64, 128) and
    # prefills (M=512, 2048); at every M the plan sends to the wgmma body, it must
    # have beaten the tile body in this call. torch._int_mm (int32 product only)
    # takes M > 16: smaller qx is zero-padded to 32 rows for it.
    # The first ten shapes draw their inputs from ``gen``, in this order; the rest
    # from a generator of their own, so adding K2 shapes leaves every later
    # kernel's inputs (K3..K8) as they were.
    k2_linears = ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608))
    gen_k2 = torch.Generator(device=dev)
    gen_k2.manual_seed(4321)
    k2_shapes = ([((m, k, n), gen) for m in (4, 2048) for (k, n) in k2_linears]
                 + [((20, 4608, 18432), gen), ((128, 4608, 18432), gen)]
                 + [((m, k, n), gen_k2) for m in (33, 64, 128, 512) for (k, n) in k2_linears
                    if (m, k, n) != (128, 4608, 18432)])
    for (Mr, K, N), g2 in k2_shapes:
        qx = torch.randint(-127, 128, (Mr, K), generator=g2, device=dev, dtype=torch.int8)
        # the main path reads each layer's weight once per step, from device memory:
        # rotate through enough copies that the timed loop cannot serve it from L2
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N))))
        qws = [torch.randint(-127, 128, (K, N), generator=g2, device=dev, dtype=torch.int8)
               for _ in range(n_copies)]
        qw = qws[0]
        a = torch.rand(Mr, 1, generator=g2, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N, generator=g2, device=dev) * 0.1 + 1e-3
        routed, _ = qgemm_w8a8_plan(Mr, K, N)
        splits = decode_splits(K, N)              # the decode body's, wherever it is timed
        wsplits = wgmma_splits(Mr, K, N)          # the wgmma body's
        bodies = {"tile": lambda i=0: qgemm_w8a8_cuda(qx, qws[i % n_copies], a, sw)}
        if Mr <= 128:
            bodies["decode"] = lambda i=0: qgemm_w8a8_decode_cuda(qx, qws[i % n_copies], a, sw,
                                                                  splits)
        if Mr > DECODE_MAX_M:
            bodies["wgmma"] = lambda i=0: qgemm_w8a8_wgmma_cuda(qx, qws[i % n_copies], a, sw,
                                                                wsplits)
        before = dict(ops.BODY_LAUNCHES)
        out = ops.qgemm_w8a8(qx, qw, a, sw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/{routed}"] == before[f"qgemm_w8a8/{routed}"] + 1,
              f"qgemm_w8a8 M={Mr} K={K} N={N} did not run the {routed} body")
        want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
        outs = {b: fn() for b, fn in bodies.items()}
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"qgemm_w8a8 M={Mr} K={K} N={N} not bitwise: {err}")
        for b, o in outs.items():
            check(torch.equal(o, want), f"qgemm_w8a8 {b} body M={Mr} K={K} N={N} not bitwise")
        body_ms = {}
        for b in [routed] + [b for b in bodies if b != routed] + [routed]:
            t = graph_ms(bodies[b], 20 if Mr >= 512 else 50)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        if routed == "wgmma":
            check(body_ms["wgmma"] < body_ms["tile"],
                  f"qgemm_w8a8 M={Mr} K={K} N={N}: the plan routes to the wgmma body, which "
                  f"took {body_ms['wgmma']:.4f} ms against the tile body's {body_ms['tile']:.4f}")
        ms = body_ms[routed]
        cms = time_ms(lambda i=0: ops.qgemm_w8a8(qx, qws[i % n_copies], a, sw), 50)
        pms = graph_ms(lambda i=0: ref.qgemm_w8a8_ref(qx, qws[i % n_copies], a, sw), 3)
        Mp = max(Mr, 32)
        qxp = torch.zeros(Mp, K, dtype=torch.int8, device=dev)
        qxp[:Mr] = qx
        lms = graph_ms(lambda i=0: torch._int_mm(qxp, qws[i % n_copies]), 20)
        lib = "torch._int_mm" + (f", M padded to {Mp}" if Mp != Mr else "")
        nbytes = Mr * K + K * N + Mr * 4 + N * 4 + Mr * N * 4
        bms, by = bound(nbytes, 2 * Mr * N * K, PEAK_OPS["int8"])
        results[("qgemm_w8a8", Mr, K, N)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, library=lib, bound_ms=bms,
            bound_by=by, max_abs_err=err, body=routed, body_ms=body_ms, gb_s=nbytes / ms / 1e6)
        for b, t in body_ms.items():
            results[(f"qgemm_w8a8/{b}", Mr, K, N)] = dict(
                ms=t, call_ms=cms if b == routed else None, plain_ms=pms, library_ms=lms,
                library=lib, bound_ms=bms, bound_by=by, max_abs_err=err)
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3] qgemm_w8a8 M={Mr} K={K} N={N}: routed to the {routed} body (decode splits "
              f"{splits}, wgmma splits {wsplits}) "
              f"kernel_ms={ms:.4f} ({times}) call_ms={cms:.4f} plain_ms={pms:.4f} "
              f"library_ms={lms:.4f} ({lib}) bound_ms={bms:.4f} ({by}) bitwise=True "
              f"GB/s={nbytes / ms / 1e6:.0f} tops={2 * Mr * N * K / ms / 1e9:.1f}")
        del qws, qw, qxp

    # K3 flash_attention: admission prefill, B=4 rows, 36 heads over 4 kv heads, D=128
    B3, H3, Hkv3, D3 = 4, 36, 4, 128
    for S in (128, 512):
        kv_len = torch.tensor([S, S - 37, S // 2, S // 3 + 1], device=dev, dtype=torch.int32)
        for dtype, atol, pk in ((torch.bfloat16, 2e-2, "bf16"), (torch.float32, 1e-4, "f32")):
            q = torch.randn(B3, H3, S, D3, generator=gen, device=dev).to(dtype)
            k = torch.randn(B3, Hkv3, S, D3, generator=gen, device=dev).to(dtype)
            v = torch.randn(B3, Hkv3, S, D3, generator=gen, device=dev).to(dtype)
            body = f"flash_attention/{'bf16_mma' if dtype == torch.bfloat16 else 'f32'}"
            before = ops.BODY_LAUNCHES[body]
            out = ops.flash_attention(q, k, v, kv_len)
            check(ops.BODY_LAUNCHES[body] == before + 1, f"flash_attention {pk} ran {body}")
            want = ref.flash_attention_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            if dtype == torch.bfloat16:
                ok, n_ulp = bf16_bar(out, want, atol)
                check(ok, f"flash_attention S={S} bf16: max err {err} beyond {atol} or one "
                          f"bf16 ulp of the plain version")
            else:
                n_ulp = 0
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
            print(f"[3] flash_attention ({body}) B={B3} H={H3}/{Hkv3} S={S} D={D3} {pk} kv_len="
                  f"{kvl.tolist()}: kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} "
                  f"library_ms={lms:.4f} "
                  f"(sdpa) bound_ms={bms:.4f} ({by}) max_abs_err={err:.2e} tol={atol}"
                  + (f" or one bf16 ulp ({n_ulp} by the ulp)" if pk == "bf16" else ""))

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
        # bf16 q runs the tensor-core body (bf16 products), f32 q the CUDA-core body
        peak = PEAK_OPS["bf16" if q_dt == torch.bfloat16 else "f32"]
        body = paged_bodies[q_dt]
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
            if q_dt == torch.bfloat16:
                ok, n_ulp = bf16_bar(out[valid], want[valid], atol)
                check(ok, f"paged {mode} {tag}: max err {err} beyond {atol} or one bf16 ulp")
            else:
                n_ulp = 0
                check(err <= atol, f"paged {mode} {tag}: max err {err} > {atol}")
            ms = graph_ms(once(call), 50)
            cms = time_ms(once(call), 50)
            pms = graph_ms(once(plain), 5)
            f32_ms = None
            if q_dt == torch.bfloat16:          # the f32-q body on the same values, beside it
                qf = q.float()
                f32_ms = graph_ms(once(
                    (lambda: ops.paged_decode_attention(qf, kp, vp, tab, kv_len4, **sc))
                    if mode == "decode" else
                    (lambda: ops.paged_verify_attention(qf, kp, vp, tab, kv_len4, q_len5, **sc))),
                    50)
            nbytes = (live * row_bytes + 2 * q.numel() * q.element_size() + tab.numel() * 4
                      + 4 * B4 * (1 if mode == "decode" else 2))
            bms, by = bound(nbytes, flops, peak)
            name = "paged_decode_attention" if mode == "decode" else "paged_verify_attention"
            results[(name, dt_name[q_dt], dt_name[pool_dt], ps)] = dict(
                ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms,
                bound_by=by, max_abs_err=err, body=body, f32_body_ms=f32_ms)
            f32s = "" if f32_ms is None else f" f32_body_ms={f32_ms:.4f}"
            print(f"[3] {name} ({body} body) B={B4} H={Hkv4 * G4}/{Hkv4} D={D4} q_win={W} {tag} "
                  f"kv_len={kvl_np.tolist()}{'' if W == 1 else f' q_len={qln_np.tolist()}'}: "
                  f"kernel_ms={ms:.4f}{f32s} call_ms={cms:.4f} plain_ms={pms:.4f} "
                  f"library_ms=None bound_ms={bms:.5f} ({by}) max_abs_err={err:.2e} tol={atol}"
                  + (f" or one bf16 ulp ({n_ulp} by the ulp)" if q_dt == torch.bfloat16 else ""))
        del kp, vp, ks, vs

    # K6 ragged_prefill_attention: packed blocks of a chunked step, over the kv_len
    # the K4 rows hold; q and the packed k/v bf16 (the serving activations), f32
    # pool (the engine's fp pool) and int8 pool + scales, ps=8. "128 mixed" is the
    # full-width chunked run's typical step at token_budget 128: three decode rows
    # and a 125-token prefill chunk behind the 389-token shared prefix (it starts
    # mid-page and its own tokens fill whole 32-position chunks); "128 one slot" a
    # whole budget of one slot's chunk; "64 = 4 x 16" four 16-token chunks (684,
    # 501 and 114 are not page multiples either).
    ps6, maxP6 = 8, MAX_LEN // 8
    P6 = B4 * maxP6
    dt6 = torch.bfloat16
    ragged_cases = [
        ("128 mixed", [1, 1, 1, 125], [700, 517, 130, SYSTEM_PREFIX + 125]),
        ("128 one slot", [128, 0, 0, 0], [SYSTEM_PREFIX + 128, 0, 0, 0]),
        ("64 = 4 x 16", [16] * 4, [700, 517, 130, 16]),
    ]

    def ragged_inputs(q_lens, kv_lens, pool_dt, sentinel=(), gen=gen):
        kvl = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
        qln = torch.tensor(q_lens, device=dev, dtype=torch.int32)
        qs = torch.cumsum(qln, 0, dtype=torch.int32) - qln
        tab = torch.full((B4, maxP6), P6, dtype=torch.int32, device=dev)
        perm = torch.randperm(P6, generator=gen, device=dev).to(torch.int32)
        off = 0
        for b, n in enumerate(kv_lens):
            if b in sentinel:
                continue
            n = -(-n // ps6)
            tab[b, :n] = perm[off: off + n]
            off += n
        shape = (P6, ps6, Hkv4, D4)
        if pool_dt == torch.int8:
            kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            ks = torch.rand(shape[:3] + (1,), generator=gen, device=dev) * 0.05 + 2e-3
            vs = torch.rand(shape[:3] + (1,), generator=gen, device=dev) * 0.05 + 2e-3
        else:
            kp = torch.randn(shape, generator=gen, device=dev).to(pool_dt)
            vp = torch.randn(shape, generator=gen, device=dev).to(pool_dt)
            ks = vs = None
        Nt = max(sum(q_lens), 64)        # the dead-slot case keeps unowned rows
        q = torch.randn(Nt, Hkv4 * G4, D4, generator=gen, device=dev).to(dt6)
        kn = torch.randn(Nt, Hkv4, D4, generator=gen, device=dev).to(dt6)
        vn = torch.randn(Nt, Hkv4, D4, generator=gen, device=dev).to(dt6)
        return dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, ks=ks, vs=vs, tab=tab, qs=qs, qln=qln,
                    kvl=kvl)

    def ragged_call(c, C):
        return lambda: ops.ragged_prefill_attention(  # noqa: E731
            c["q"], c["kn"], c["vn"], c["kp"], c["vp"], c["tab"], c["qs"], c["qln"],
            c["kvl"], chunk_cap=C, k_scale_pages=c["ks"], v_scale_pages=c["vs"])

    def ragged_plain(c, C):
        Nt = c["q"].shape[0]
        return lambda: ref.ragged_prefill_attention_ref(  # noqa: E731
            c["q"].reshape(Nt, Hkv4, G4, D4), c["kn"], c["vn"], c["kp"], c["vp"], c["tab"],
            c["qs"], c["qln"], c["kvl"], chunk_cap=C, k_scale_pages=c["ks"],
            v_scale_pages=c["vs"]).reshape(Nt, Hkv4 * G4, D4)

    for label, q_lens, kv_lens in ragged_cases:
        for pool_dt in (torch.float32, torch.int8):
            c = ragged_inputs(q_lens, kv_lens, pool_dt)
            Nt = c["q"].shape[0]                 # the engine launches chunk_cap = Nt
            out, want = ragged_call(c, Nt)(), ragged_plain(c, Nt)()
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            ok, n_ulp = bf16_bar(out, want)
            check(ok, f"ragged_prefill {label} pool {dt_name[pool_dt]}: max err {err} beyond "
                      f"2e-2 or one bf16 ulp")
            ms = graph_ms(once(ragged_call(c, Nt)), 50)
            cms = time_ms(once(ragged_call(c, Nt)), 50)
            pms = graph_ms(once(ragged_plain(c, Nt)), 5)
            # the f32-q body on the same values (q, k_new, v_new as f32), beside it
            c32 = {**c, **{k: c[k].float() for k in ("q", "kn", "vn")}}
            f32_ms = graph_ms(once(ragged_call(c32, Nt)), 50)
            # bytes: each pool row before the chunk once (positions < cs), the packed
            # q/k/v once, the output once, scales, table and extents; operations: row
            # i of a chunk starting at cs meets cs + i + 1 keys, 4 flops per key and
            # dimension (QK and PV) for each of the H heads
            pool_rows = sum(k - n for k, n in zip(kv_lens, q_lens))
            row_bytes = Hkv4 * D4 * pool_dt.itemsize * 2 + (8 * Hkv4 if c["ks"] is not None
                                                             else 0)
            nbytes = (pool_rows * row_bytes + (2 * c["q"].numel() + 2 * c["kn"].numel()) * 2
                      + c["tab"].numel() * 4 + 12 * B4)
            keys = sum(n * (k - n) + n * (n + 1) // 2 for k, n in zip(kv_lens, q_lens))
            bms, by = bound(nbytes, 4 * D4 * Hkv4 * G4 * keys, PEAK_OPS["bf16"])
            results[("ragged_prefill_attention", dt_name[pool_dt], label)] = dict(
                ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
                max_abs_err=err, body="bf16_mma", f32_body_ms=f32_ms)
            print(f"[3] ragged_prefill_attention (bf16_mma body) {label}: Nt={Nt} chunk_cap={Nt} "
                  f"B={B4} H={Hkv4 * G4}/{Hkv4} D={D4} ps={ps6} q bf16 pool {dt_name[pool_dt]} "
                  f"q_len={q_lens} kv_len={kv_lens}: kernel_ms={ms:.4f} f32_body_ms={f32_ms:.4f} "
                  f"call_ms={cms:.4f} "
                  f"plain_ms={pms:.4f} library_ms=None bound_ms={bms:.5f} ({by}) "
                  f"max_abs_err={err:.2e} tol=2e-2 or one bf16 ulp ({n_ulp} by the ulp)")
    # a dead slot (it owns no rows: rows past the owned 33 must read 0) and an
    # all-sentinel table row whose one-token chunk reads only its own packed k/v
    c = ragged_inputs([16, 0, 16, 1], [700, 0, 130, 1], torch.int8, sentinel=(3,))
    out, want = ragged_call(c, 16)(), ragged_plain(c, 16)()
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    check(bf16_bar(out, want)[0] and float(out[33:].float().abs().max()) == 0.0,
          f"ragged_prefill dead slot / sentinel row: err {err}, unowned rows nonzero")
    # q_len == 1 rows over an fp pool holding the packed k/v at the newest position
    # are bitwise the decode launch (K4)
    kv1 = [700, 517, 130, 1]
    for pool_dt in (torch.float32, torch.bfloat16):
        c = ragged_inputs([1] * 4, kv1, pool_dt)
        kn, vn = c["kn"][:4], c["vn"][:4]
        for b, n in enumerate(kv1):
            page, row = int(c["tab"][b, (n - 1) // ps6]), (n - 1) % ps6
            c["kp"][page, row], c["vp"][page, row] = kn[b].to(pool_dt), vn[b].to(pool_dt)
            kn[b], vn[b] = c["kp"][page, row].to(dt6), c["vp"][page, row].to(dt6)
        q1 = c["q"][:4].contiguous()
        rag = ops.ragged_prefill_attention(q1, kn.contiguous(), vn.contiguous(), c["kp"],
                                           c["vp"], c["tab"], c["qs"][:4], c["qln"], c["kvl"],
                                           chunk_cap=1)
        dec = ops.paged_decode_attention(q1[:, None], c["kp"], c["vp"], c["tab"], c["kvl"])
        torch.cuda.synchronize()
        check(torch.equal(rag, dec[:, 0]),
              f"ragged q_len=1 != decode launch (pool {dt_name[pool_dt]}): "
              f"{float((rag.float() - dec[:, 0].float()).abs().max())}")
    print("[3] ragged_prefill_attention: dead slot rows 0, all-sentinel row exact; q_len=1 rows "
          "bitwise = paged_decode_attention (f32 and bf16 pools)")
    # The fixed case of the bf16 bar: the "128 mixed" step over an int8 pool, from a
    # generator of its own, with every V value (center_d + noise) / 16 for a center
    # per head dimension in [72, 119]: every output lies in [4, 8), where one bf16
    # ulp (0.031) exceeds 2e-2, and some plain values lie within 1e-5 of a bf16
    # midpoint, where the kernel and the plain version may round apart
    g6 = torch.Generator(device=dev)
    g6.manual_seed(1606)
    c = ragged_inputs([1, 1, 1, 125], [700, 517, 130, SYSTEM_PREFIX + 125], torch.int8, gen=g6)
    center = torch.randint(72, 120, (Hkv4, D4), generator=g6, device=dev)
    c["vp"].copy_(center + torch.randint(-8, 9, c["vp"].shape, generator=g6, device=dev))
    c["vs"].fill_(1 / 16)
    c["vn"].copy_((center + torch.randint(-8, 9, c["vn"].shape, generator=g6, device=dev)) / 16)
    out, want = ragged_call(c, 128)(), ragged_plain(c, 128)()
    p6 = ragged_plain({**c, "q": c["q"].float()}, 128)()   # its f32 values, before the bf16 cast
    torch.cuda.synchronize()
    ulp6 = torch.exp2(torch.floor(torch.log2(p6.abs())) - 7)
    frac6 = p6.abs() / ulp6
    n_mid = int(((frac6 - frac6.floor() - 0.5).abs() * ulp6 < 1e-5).sum())
    ok, n_ulp = bf16_bar(out, want)
    ok32, _ = bf16_bar(out, p6)
    n_flip = int((out.float() != want.float()).sum())
    err = float((out.float() - want.float()).abs().max())
    check(4 <= float(p6.min()) and float(p6.max()) < 8, "near-midpoint case: outputs in [4, 8)")
    check(n_mid > 0, "near-midpoint case: no plain value within 1e-5 of a bf16 midpoint")
    check(ok and ok32, f"ragged_prefill near-midpoint case: max err {err} beyond 2e-2 or one "
          f"bf16 ulp")
    print(f"[3] ragged_prefill_attention near-midpoint case (int8 pool, plain f32 values in "
          f"[{float(p6.min()):.3f}, {float(p6.max()):.3f}]): {n_mid} of {p6.numel()} within 1e-5 "
          f"of a bf16 midpoint; {n_flip} outputs differ from the bf16 plain version, max_abs_err="
          f"{err:.3e}; {n_ulp} passed by the one-ulp arm of the bar only (2e-2 < one ulp = 0.031)")
    del c, out, want, p6, ulp6, frac6

    # K7 qgemm_w8a8_sparse: K2's decode and wgmma bodies with a tile skip, routed by
    # qgemm_w8a8_sparse_plan, at the up (K=4608, N=18432) and down (K=18432, N=4608)
    # projections over occupancy patterns of 64 x 64 weight tiles: every other
    # 64-row k-tile empty ("alt", the block-sparse serving tree's pattern), a seeded
    # half of the tiles empty ("random"), "alt" with one 128-column block fully
    # empty and the next holding a single tile ("block_empty": fewer occupied
    # stages than splits), "alt" with the k-range of K2's second decode split empty
    # ("split_empty"), and every tile occupied ("ones"). Each is held bitwise
    # against the plain version and against K2's routed body on the same weights,
    # eagerly and under graph replay, and K7 and K2 are timed in turns (K7, K2, K2,
    # K7; the lower time of each kept): K7 must beat K2 wherever a tile is empty and
    # stay within 5 % of it on "ones" (10 % at M=64). M=32 is the decode body's
    # largest tile (DECODE_MAX_M), M=64 a small token tile of the wgmma body. The
    # 64 x 64 tile body, which the plan keeps for unaligned operands and K or N not
    # a multiple of 16, is held at M=4 and 2048 on "alt" and "ones" beside the
    # routed body: bitwise against the plain version and K2, eagerly and replayed,
    # timed, and reached through the wrapper with a misaligned qx. The bound counts
    # the bytes K7 must move (qx, the occupied tiles' weights, the table, a, sw,
    # out) and the occupied tiles' products. From a generator of its own.
    gen_k7 = torch.Generator(device=dev)
    gen_k7.manual_seed(7777)
    k7_cases = {(4608, 18432): [("alt", (4, 32, 64, 128, 2048)), ("random", (4, 32, 64, 2048)),
                                ("ones", (4, 32, 64, 128, 2048)), ("block_empty", (4, 128)),
                                ("split_empty", (4,))],
                (18432, 4608): [("alt", (4, 32, 128)), ("random", (32, 128)),
                                ("split_empty", (4, 128)), ("ones", (4, 32, 128))]}

    def k7_tiles(pattern, K, N):
        """The (KT, NT) bool table of occupied tiles of a pattern."""
        KT, NT = -(-K // 64), -(-N // 64)
        t = torch.ones(KT, NT, dtype=torch.bool, device=dev)
        if pattern in ("alt", "block_empty", "split_empty"):
            t[1::2] = False
        if pattern == "random":
            t = torch.rand(KT, NT, generator=gen_k7, device=dev) < 0.5
        elif pattern == "block_empty":
            t[:, :4] = False
            t[KT - 1, 2] = True
        elif pattern == "split_empty":
            S = decode_splits(K, N)
            t[KT // S: 2 * KT // S] = False
        return t

    for (K, N), patterns in k7_cases.items():
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N))))
        for pattern, m_list in patterns:
            tiles = k7_tiles(pattern, K, N)
            keep = tiles.repeat_interleave(64, 0).repeat_interleave(64, 1)[:K, :N]
            qws = [torch.randint(-127, 128, (K, N), generator=gen_k7, device=dev,
                                 dtype=torch.int8) * keep.to(torch.int8)
                   for _ in range(n_copies)]
            mask7 = packing.pack_mask(keep.to(torch.uint8), axis=0)
            occ7 = ops.tile_occupancy(mask7, K)
            check(torch.equal(occ7.bool(), tiles), f"K7 {pattern}: occupancy table")
            occ_w = int(keep.sum())                   # weights in occupied tiles
            del keep
            for Mr in m_list:
                qx = torch.randint(-127, 128, (Mr, K), generator=gen_k7, device=dev,
                                   dtype=torch.int8)
                a = torch.rand(Mr, 1, generator=gen_k7, device=dev) * 0.1 + 1e-3
                sw = torch.rand(N, generator=gen_k7, device=dev) * 0.1 + 1e-3
                routed, splits = qgemm_w8a8_sparse_plan(Mr, K, N)
                k2_routed = qgemm_w8a8_plan(Mr, K, N)[0]
                k7 = lambda i=0: ops.qgemm_w8a8_sparse(qx, qws[i % n_copies], a, sw,  # noqa: E731
                                                       mask7, occ7)
                k2 = lambda i=0: ops.qgemm_w8a8(qx, qws[i % n_copies], a, sw)  # noqa: E731
                before = dict(ops.BODY_LAUNCHES)
                out = k7()
                check(ops.BODY_LAUNCHES[f"qgemm_w8a8_sparse/{routed}"]
                      == before[f"qgemm_w8a8_sparse/{routed}"] + 1
                      and routed == k2_routed and routed != "tile",
                      f"qgemm_w8a8_sparse M={Mr} K={K} N={N} {pattern}: did not run the "
                      f"{routed} body (K2: {k2_routed})")
                want = ref.qgemm_w8a8_sparse_ref(qx, qws[0], a, sw, mask7)
                outs = [out, replay(k7)[0], k2(), replay(k2)[0]]
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                for o, what in zip(outs, ("K7", "K7 graph replay", "K2", "K2 graph replay")):
                    check(torch.equal(o, want), f"qgemm_w8a8_sparse M={Mr} K={K} N={N} "
                          f"{pattern}: {what} not bitwise the plain version")
                reps = 20 if Mr >= 512 else 50
                t7, t2 = [], []
                for fn, ts in ((k7, t7), (k2, t2), (k2, t2), (k7, t7)):
                    ts.append(graph_ms(fn, reps))
                ms, k2_ms = min(t7), min(t2)
                if pattern == "ones":
                    # at the wgmma body's small token tiles (33 <= M < 128) the table
                    # read and the list cost 3-5 % of K2's time on an all-ones table
                    # (PERF.md section 7): a looser bound that still catches a regression
                    lim = 1.10 if DECODE_MAX_M < Mr < 128 else 1.05
                    check(ms <= lim * k2_ms, f"qgemm_w8a8_sparse M={Mr} K={K} N={N} all-ones "
                          f"table: {ms:.4f} ms, beyond {lim - 1:.0%} of K2's {k2_ms:.4f}")
                else:
                    check(ms < k2_ms, f"qgemm_w8a8_sparse M={Mr} K={K} N={N} {pattern}: "
                          f"{ms:.4f} ms, not faster than K2's {k2_ms:.4f}")
                cms = time_ms(k7, 50)
                tile_s = ""
                if (K, N) == (4608, 18432) and pattern in ("alt", "ones") and Mr in (4, 2048):
                    tile = lambda i=0: qgemm_w8a8_sparse_cuda(  # noqa: E731
                        qx, qws[i % n_copies], a, sw, occ7)
                    for o, what in ((tile(), "eager"), (replay(tile)[0], "graph replay")):
                        check(torch.equal(o, want) and torch.equal(o, outs[2]),
                              f"qgemm_w8a8_sparse tile body M={Mr} {pattern} ({what}): not "
                              f"bitwise the plain version and K2")
                    # a qx one byte off 16-byte alignment: the wrapper routes to the tile body
                    qxu = torch.empty(Mr * K + 1, dtype=torch.int8, device=dev)[1:].view(Mr, K)
                    qxu.copy_(qx)
                    before = ops.BODY_LAUNCHES["qgemm_w8a8_sparse/tile"]
                    ou = ops.qgemm_w8a8_sparse(qxu, qws[0], a, sw, mask7, occ7)
                    check(ops.BODY_LAUNCHES["qgemm_w8a8_sparse/tile"] == before + 1
                          and torch.equal(ou, want), f"qgemm_w8a8_sparse M={Mr} {pattern}: "
                          f"misaligned qx did not run the tile body bitwise")
                    del qxu, ou
                    tms = graph_ms(tile, reps)
                    tile_s = (f" tile_body_ms={tms:.4f} (bitwise; a misaligned qx routes "
                              f"there)")
                pms = lms = None
                if pattern == "alt":
                    pms = graph_ms(lambda i=0: ref.qgemm_w8a8_sparse_ref(
                        qx, qws[i % n_copies], a, sw, mask7), 3)
                    # the dense product, qx zero-padded to 32 rows below that (as for K2)
                    qxp = torch.zeros(max(Mr, 32), K, dtype=torch.int8, device=dev)
                    qxp[:Mr] = qx
                    lms = graph_ms(lambda i=0: torch._int_mm(qxp, qws[i % n_copies]), 20)
                    del qxp
                nbytes = Mr * K + occ_w + occ7.numel() * 4 + Mr * 4 + N * 4 + Mr * N * 4
                bms, by = bound(nbytes, 2 * Mr * occ_w, PEAK_OPS["int8"])
                stages = sparse_stage_ranges(occ7.cpu(), K, N, routed, splits)
                n_st = sum(len(sh) for blk in stages for sh in blk)
                full_st = len(stages) * -(-K // (64 if routed == "decode" else 128))
                results[("qgemm_w8a8_sparse", Mr, K, N, pattern)] = dict(
                    ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms,
                    library=None if lms is None else "torch._int_mm, dense"
                    + (", M padded to 32" if Mr < 32 else ""),
                    bound_ms=bms, bound_by=by, max_abs_err=err, body=routed, k2_ms=k2_ms)
                extra = ("" if pms is None else f" plain_ms={pms:.4f} library_ms={lms:.4f} "
                         f"(torch._int_mm, dense{', M padded to 32' if Mr < 32 else ''})")
                print(f"[3] qgemm_w8a8_sparse M={Mr} K={K} N={N} {pattern}: "
                      f"{int(occ7.sum())}/{occ7.numel()} tiles occupied, {n_st}/{full_st} "
                      f"stages streamed; routed to the {routed} body ({splits} splits) "
                      f"kernel_ms={ms:.4f} k2_ms={k2_ms:.4f} (K2's {k2_routed} body, same "
                      f"weights) ratio={ms / k2_ms:.3f} call_ms={cms:.4f}{extra} "
                      f"bound_ms={bms:.4f} ({by}) bitwise=True (K7 and K2, eager and graph "
                      f"replay){tile_s}")
            del qws, mask7, occ7

    # K8 qgemm_w4a8 (g128) at the four linears' shapes: the decode body (split-K
    # weight stream, M <= 128), the wgmma body (M > DECODE_MAX_M) and the tile body,
    # each that takes a shape held against the plain version (f32-close: the plain
    # version sums the group partials in PyTorch's order), eagerly and under graph
    # replay, and timed side by side (routed, others, routed again; the lower of the
    # routed body's two times is kept); wherever the plan routes to a new body it
    # must have beaten the tile body in this call. From a generator of its own.
    gen_k8 = torch.Generator(device=dev)
    gen_k8.manual_seed(8888)
    for Mr in (4, 33, 128, 2048):
        for K, N in k2_linears:
            qx = torch.randint(-127, 128, (Mr, K), generator=gen_k8, device=dev,
                               dtype=torch.int8)
            a = torch.rand(Mr, 1, generator=gen_k8, device=dev) * 0.1 + 1e-3
            sw = torch.rand(K // 128, N, generator=gen_k8, device=dev) * 0.01 + 1e-4
            n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N // 2))))
            qws = [torch.randint(-128, 128, (K // 2, N), generator=gen_k8, device=dev,
                                 dtype=torch.int8) for _ in range(n_copies)]
            routed, rsplits = qgemm_w4a8_plan(Mr, K, N, 128)
            dsplits, wsplits = w4a8_decode_splits(K, N, 128), w4a8_wgmma_splits(Mr, K, N, 128)
            bodies = {"tile": lambda i=0: qgemm_w4a8_cuda(qx, qws[i % n_copies], a, sw, 128)}
            if Mr <= 128:
                bodies["decode"] = lambda i=0: qgemm_w4a8_decode_cuda(qx, qws[i % n_copies], a,
                                                                      sw, 128, dsplits)
            if Mr > DECODE_MAX_M:
                bodies["wgmma"] = lambda i=0: qgemm_w4a8_wgmma_cuda(qx, qws[i % n_copies], a,
                                                                    sw, 128, wsplits)
            before = dict(ops.BODY_LAUNCHES)
            out = ops.qgemm_w4a8(qx, qws[0], a, sw, group=128)
            check(ops.BODY_LAUNCHES[f"qgemm_w4a8/{routed}"]
                  == before[f"qgemm_w4a8/{routed}"] + 1,
                  f"qgemm_w4a8 M={Mr} K={K} N={N} did not run the {routed} body")
            want = ref.qgemm_w4a8_ref(qx, qws[0], a, sw, 128)
            tol = 2e-4 * want.abs() + 1e-5 * float(want.abs().max())
            err = float((out - want).abs().max())
            for b, fn in bodies.items():
                for o in ((fn(),) if b == "tile" else (fn(), replay(fn)[0])):
                    torch.cuda.synchronize()
                    d = (o - want).abs()
                    check(bool((d <= tol).all()), f"qgemm_w4a8 {b} body M={Mr} K={K} N={N}: "
                          f"max err {float(d.max())}")
                    err = max(err, float(d.max()))
            body_ms = {}
            for b in [routed] + [b for b in bodies if b != routed] + [routed]:
                t = graph_ms(bodies[b], 20 if Mr >= 512 else 50)
                body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
            if routed != "tile":
                check(body_ms[routed] < body_ms["tile"],
                      f"qgemm_w4a8 M={Mr} K={K} N={N}: the plan routes to the {routed} body, "
                      f"which took {body_ms[routed]:.4f} ms against the tile body's "
                      f"{body_ms['tile']:.4f}")
            ms = body_ms[routed]
            cms = time_ms(lambda i=0: ops.qgemm_w4a8(qx, qws[i % n_copies], a, sw, group=128), 50)
            pms = graph_ms(lambda i=0: ref.qgemm_w4a8_ref(qx, qws[i % n_copies], a, sw, 128), 3)
            nbytes = Mr * K + K * N // 2 + sw.numel() * 4 + Mr * 4 + Mr * N * 4
            bms, by = bound(nbytes, 2 * Mr * N * K, PEAK_OPS["int8"])
            for b, t in body_ms.items():
                results[(f"qgemm_w4a8/{b}", Mr, K, N)] = dict(
                    ms=t, call_ms=cms if b == routed else None, plain_ms=pms, library_ms=None,
                    bound_ms=bms, bound_by=by, max_abs_err=err, gb_s=nbytes / t / 1e6)
            times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
            print(f"[3] qgemm_w4a8 M={Mr} K={K} N={N} g128: routed to the {routed} body "
                  f"({rsplits} splits; decode splits {dsplits}, wgmma splits {wsplits}) "
                  f"kernel_ms={ms:.4f} ({times}) call_ms={cms:.4f} plain_ms={pms:.4f} "
                  f"library_ms=None bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f} "
                  f"tops={2 * Mr * N * K / ms / 1e9:.1f} max_abs_err={err:.3e} "
                  f"(tol 2e-4*|plain| + 1e-5*max|plain|, every body, eager and graph replay)")
            del qws

    # The dense zoo's new shapes, from a generator of their own so every case above
    # keeps its inputs. K3 at gemma2-9b's local layers (D = 256, window 4096, softcap
    # 50; no PyTorch call computes a softcap) and at hubert-xlarge's encoder (D = 80,
    # not causal; SDPA with a boolean mask beside it); K4, K5 and K6 at gemma2's
    # local layers over an int8 pool, where the leading split partitions of the long
    # slot lie wholly behind the window; K2 at nemotron-4-15b's untied head (K =
    # 6144, N = 256000) on weights prepared on the fly from a seeded f32 head, as
    # ``mode="int8"`` serves it. Bounds count the keys each row can see.
    gz = torch.Generator(device=dev)
    gz.manual_seed(1909)

    def visible_keys(S, kv_lens, causal, window):
        """(per-(batch, row) visible key counts (B, S), whether each row has one)."""
        i = np.arange(S)[None, :]
        kv = np.asarray(kv_lens)[:, None]
        if not causal:
            n = np.broadcast_to(kv, (len(kv_lens), S))
        else:
            lo = np.zeros_like(i) if window is None else np.maximum(i - window + 1, 0)
            n = np.maximum(np.minimum(i, kv - 1) - lo + 1, 0)
        return n, n > 0

    zoo_flash = [("gemma2 local", torch.bfloat16, 2, 16, 8, 4608, 256, [4608, 300], True, 4096,
                  50.0),
                 ("hubert", torch.bfloat16, 4, 16, 16, 512, 80, [512, 400, 130, 1], False, None,
                  None),
                 ("hubert", torch.float32, 4, 16, 16, 512, 80, [512, 400, 130, 1], False, None,
                  None)]
    for label, dtype, B, H, Hkv, S, D, kvl_list, causal, window, softcap in zoo_flash:
        pk = "bf16" if dtype == torch.bfloat16 else "f32"
        q = torch.randn(B, H, S, D, generator=gz, device=dev).to(dtype)
        k = torch.randn(B, Hkv, S, D, generator=gz, device=dev).to(dtype)
        v = torch.randn(B, Hkv, S, D, generator=gz, device=dev).to(dtype)
        kv_len = torch.tensor(kvl_list, device=dev, dtype=torch.int32)
        kw = dict(causal=causal, window=window, softcap=softcap)
        body = f"flash_attention/{'bf16_mma' if dtype == torch.bfloat16 else 'f32'}"
        before = ops.BODY_LAUNCHES[body]
        out = ops.flash_attention(q, k, v, kv_len, **kw)
        check(ops.BODY_LAUNCHES[body] == before + 1, f"flash_attention {label} {pk} ran {body}")
        want = ref.flash_attention_ref(q, k, v, kv_len, **kw)
        torch.cuda.synchronize()
        n_vis, has = visible_keys(S, kvl_list, causal, window)
        rows = torch.as_tensor(has, device=dev)[:, None, :, None].expand_as(out)
        check(bool(torch.isfinite(out.float()).all()), f"flash_attention {label}: non-finite")
        err = float((out.float() - want.float()).abs()[rows].max())
        if dtype == torch.bfloat16:
            ok, n_ulp = bf16_bar(out[rows], want[rows])
            check(ok, f"flash_attention {label} bf16: max err {err} beyond 2e-2 or one bf16 ulp")
        else:
            n_ulp = 0
            check(err <= 1e-4, f"flash_attention {label} f32: max err {err} > 1e-4")
        fa = once(lambda: ops.flash_attention(q, k, v, kv_len, **kw))
        ms = graph_ms(fa, 10)
        cms = time_ms(fa, 10)
        pms = time_ms(once(lambda: ref.flash_attention_ref(q, k, v, kv_len, **kw)), 2)
        lms = None
        if softcap is None and window is None and not causal:
            mask = (torch.arange(S, device=dev)[None, None, None, :]
                    < kv_len.view(-1, 1, 1, 1)).expand(B, 1, S, S)
            lms = graph_ms(lambda i=0: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 10)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * B
        bms, by = bound(nbytes, 4 * D * H * float(n_vis.sum()), PEAK_OPS[pk])
        results[("flash_attention", label, pk)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by,
            max_abs_err=err)
        lib = "None" if lms is None else f"{lms:.4f} (sdpa, boolean mask)"
        print(f"[3] flash_attention ({body}) {label}: B={B} H={H}/{Hkv} S={S} D={D} {pk} "
              f"causal={causal} window={window} softcap={softcap} kv_len={kvl_list}: "
              f"kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} library_ms={lib} "
              f"bound_ms={bms:.4f} ({by}) max_abs_err={err:.2e} (rows with a visible key)"
              + (f" tol 2e-2 or one bf16 ulp ({n_ulp} by the ulp)" if pk == "bf16"
                 else " tol 1e-4"))
        del q, k, v, out, want

    # K4 / K5 / K6 at gemma2-9b's local layers: bf16 q, int8 pool + f32 scales, ps 16,
    # a max_len 8192 table; slot 0 holds 4616 positions, of which the first 520 are
    # behind the window
    from repro_torch.kernels.paged_attention import split_plan
    Hkv_g, G_g, D_g, ps_g, W_g = 8, 2, 256, 16, 4
    kv_g = [4616, 317]
    maxP_g = 8192 // ps_g
    n_parts_g, part_len_g = split_plan(maxP_g, ps_g)
    behind = sum((p + 1) * part_len_g <= kv_g[0] - 4096 for p in range(n_parts_g))
    check(behind >= 1, f"gemma2 paged case: no split partition ({n_parts_g} of {part_len_g}) "
          f"lies wholly behind the window")
    P_g = sum(-(-n // ps_g) for n in kv_g) + 8
    tab_g = torch.full((2, maxP_g), P_g, dtype=torch.int32, device=dev)
    perm_g = torch.randperm(P_g, generator=gz, device=dev).to(torch.int32)
    off = 0
    for b, n in enumerate(kv_g):
        n = -(-n // ps_g)
        tab_g[b, :n] = perm_g[off: off + n]
        off += n
    shape_g = (P_g, ps_g, Hkv_g, D_g)
    kp_g = torch.randint(-127, 128, shape_g, generator=gz, device=dev, dtype=torch.int8)
    vp_g = torch.randint(-127, 128, shape_g, generator=gz, device=dev, dtype=torch.int8)
    ks_g = torch.rand(shape_g[:3] + (1,), generator=gz, device=dev) * 0.05 + 2e-3
    vs_g = torch.rand(shape_g[:3] + (1,), generator=gz, device=dev) * 0.05 + 2e-3
    kv_len_g = torch.tensor(kv_g, device=dev, dtype=torch.int32)
    kw_g = dict(k_scale_pages=ks_g, v_scale_pages=vs_g, window=4096, softcap=50.0)
    row_bytes_g = Hkv_g * D_g * 2 + 8 * Hkv_g          # int8 K and V rows, two f32 scales
    q_g = torch.randn(2, 1, Hkv_g * G_g, D_g, generator=gz, device=dev).to(torch.bfloat16)
    qw_g = torch.randn(2, W_g, Hkv_g * G_g, D_g, generator=gz, device=dev).to(torch.bfloat16)
    qln_g = torch.tensor([4, 3], device=dev, dtype=torch.int32)
    # K6: the long slot's 200-row chunk ending at 4616 beside the short slot's decode row
    rq_g, rkv_g = [200, 1], [4616, 317]
    Nt_g = sum(rq_g)
    qr_g = torch.randn(Nt_g, Hkv_g * G_g, D_g, generator=gz, device=dev).to(torch.bfloat16)
    kn_g = torch.randn(Nt_g, Hkv_g, D_g, generator=gz, device=dev).to(torch.bfloat16)
    vn_g = torch.randn(Nt_g, Hkv_g, D_g, generator=gz, device=dev).to(torch.bfloat16)
    rqs_g = torch.tensor([0, rq_g[0]], device=dev, dtype=torch.int32)
    rql_g = torch.tensor(rq_g, device=dev, dtype=torch.int32)
    rkl_g = torch.tensor(rkv_g, device=dev, dtype=torch.int32)

    def win_keys(pos):                      # keys a query at ``pos`` sees: window 4096
        return min(pos + 1, 4096)

    # per case: (wrapper, id, kernel call, plain call, query positions, pool rows some
    # query sees: a decode row at p sees (p - 4096, p], a window of w rows ending at
    # kv_len - 1 the union of theirs; a K6 chunk reads only positions before it)

    zoo_paged = [
        ("paged_decode_attention", "K4",
         lambda: ops.paged_decode_attention(q_g, kp_g, vp_g, tab_g, kv_len_g, **kw_g),
         lambda: ref.paged_decode_attention_ref(q_g.reshape(2, Hkv_g, G_g, D_g), kp_g, vp_g,
                                                tab_g, kv_len_g, **kw_g).reshape(q_g.shape),
         [n - 1 for n in kv_g], sum(min(n, 4096) for n in kv_g)),
        ("paged_verify_attention", "K5",
         lambda: ops.paged_verify_attention(qw_g, kp_g, vp_g, tab_g, kv_len_g, qln_g, **kw_g),
         lambda: ref.paged_verify_attention_ref(
             qw_g.reshape(2, W_g, Hkv_g, G_g, D_g).permute(0, 2, 1, 3, 4), kp_g, vp_g, tab_g,
             kv_len_g, qln_g, **kw_g).permute(0, 2, 1, 3, 4).reshape(qw_g.shape),
         [n - w + i for n, w in zip(kv_g, (4, 3)) for i in range(w)],
         sum(min(n, 4095 + w) for n, w in zip(kv_g, (4, 3)))),
        ("ragged_prefill_attention", "K6",
         lambda: ops.ragged_prefill_attention(qr_g, kn_g, vn_g, kp_g, vp_g, tab_g, rqs_g, rql_g,
                                              rkl_g, chunk_cap=Nt_g, **kw_g),
         lambda: ref.ragged_prefill_attention_ref(
             qr_g.reshape(Nt_g, Hkv_g, G_g, D_g), kn_g, vn_g, kp_g, vp_g, tab_g, rqs_g, rql_g,
             rkl_g, chunk_cap=Nt_g, **kw_g).reshape(qr_g.shape),
         [n - w + i for n, w in zip(rkv_g, rq_g) for i in range(w)],
         sum(min(n - w, 4095) for n, w in zip(rkv_g, rq_g))),
    ]
    for name, kid, call, plain, q_pos, pool_rows in zoo_paged:
        before = ops.BODY_LAUNCHES["paged_attention/bf16_mma"]
        out = call()
        want = plain()
        torch.cuda.synchronize()
        check(ops.BODY_LAUNCHES["paged_attention/bf16_mma"] > before,
              f"{name} gemma2: did not run the split bf16 body")
        check(bool(torch.isfinite(out.float()).all()), f"{name} gemma2: non-finite output")
        if name == "paged_verify_attention":
            valid = (torch.arange(W_g, device=dev)[None, :] < qln_g[:, None])
            o, w = out[valid], want[valid]
        else:
            o, w = out, want
        err = float((o.float() - w.float()).abs().max())
        ok, n_ulp = bf16_bar(o, w)
        check(ok, f"{name} gemma2 window case: max err {err} beyond 2e-2 or one bf16 ulp")
        ms = graph_ms(once(call), 20)
        cms = time_ms(once(call), 20)
        pms = graph_ms(once(plain), 2)
        q_rows = out.numel() // (Hkv_g * G_g * D_g)
        flops = 4 * G_g * D_g * Hkv_g * sum(win_keys(p) for p in q_pos)
        nbytes = (pool_rows * row_bytes_g + 2 * out.numel() * 2 + tab_g.numel() * 4 + 16
                  + (2 * kn_g.numel() * 2 if kid == "K6" else 0))
        bms, by = bound(nbytes, flops, PEAK_OPS["bf16"])
        results[(name, "gemma2 local")] = dict(ms=ms, call_ms=cms, plain_ms=pms, library_ms=None,
                                              bound_ms=bms, bound_by=by, max_abs_err=err)
        print(f"[3] {name} ({kid}, bf16_mma body) gemma2 local: H={Hkv_g * G_g}/{Hkv_g} D={D_g} "
              f"ps={ps_g} q bf16 pool int8 window=4096 softcap=50 kv_len={kv_g} ({q_rows} query "
              f"rows; split {n_parts_g} x {part_len_g}, {behind} partitions wholly behind the "
              f"window): kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None "
              f"bound_ms={bms:.5f} ({by}) max_abs_err={err:.2e} tol 2e-2 or one bf16 ulp "
              f"({n_ulp} by the ulp)")
    del kp_g, vp_g, ks_g, vs_g

    # K2 at nemotron-4-15b's untied head: the fp head prepared on the fly from the
    # column max of the step's rows (bf16 activations), then K1 and K2, as
    # ``mode="int8"`` runs it every step
    Kh, Nh = 6144, 256000
    w_head = torch.randn(Kh, Nh, generator=gz, device=dev) * Kh ** -0.5
    for Mr in (4, 128):
        xh = (torch.randn(Mr, Kh, generator=gz, device=dev) * 2).to(torch.bfloat16)
        prep = ql.prepare_int8({"w": w_head}, ql.W8A8_INT8, cmax=ql._col_absmax(xh),
                               jitted=True)
        qx, a = ops.act_quantize(xh, prep["bcol"], prep["qalpha"])
        qw, sw = prep["qw"], prep["sw"]
        del prep
        routed, _ = qgemm_w8a8_plan(Mr, Kh, Nh)
        before = ops.BODY_LAUNCHES[f"qgemm_w8a8/{routed}"]
        out = ops.qgemm_w8a8(qx, qw, a, sw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/{routed}"] == before + 1,
              f"qgemm_w8a8 head M={Mr}: did not run the {routed} body")
        errs = []
        for n0 in range(0, Nh, 32000):
            want = ref.qgemm_w8a8_ref(qx, qw[:, n0:n0 + 32000], a, sw[n0:n0 + 32000])
            errs.append(float((out[:, n0:n0 + 32000] - want).abs().max()))
            check(torch.equal(out[:, n0:n0 + 32000], want),
                  f"qgemm_w8a8 head M={Mr} columns {n0}+: not bitwise ({errs[-1]})")
        del want
        ms = graph_ms(once(lambda: ops.qgemm_w8a8(qx, qw, a, sw)), 10)
        cms = time_ms(once(lambda: ops.qgemm_w8a8(qx, qw, a, sw)), 10)
        pms = time_ms(once(lambda: ref.qgemm_w8a8_ref(qx, qw, a, sw)), 1)
        Mp = max(Mr, 32)
        qxp = torch.zeros(Mp, Kh, dtype=torch.int8, device=dev)
        qxp[:Mr] = qx
        lms = graph_ms(lambda i=0: torch._int_mm(qxp, qw), 10)
        nbytes = Mr * Kh + Kh * Nh + Mr * 4 + Nh * 4 + Mr * Nh * 4
        bms, by = bound(nbytes, 2 * Mr * Nh * Kh, PEAK_OPS["int8"])
        results[("qgemm_w8a8", "head", Mr)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by,
            max_abs_err=max(errs))
        print(f"[3] qgemm_w8a8 nemotron head M={Mr} K={Kh} N={Nh} (weights prepared on the fly, "
              f"{-(-Nh // 128)} column tiles): routed to the {routed} body kernel_ms={ms:.4f} "
              f"call_ms={cms:.4f} plain_ms={pms:.4f} library_ms={lms:.4f} (torch._int_mm"
              f"{f', M padded to {Mp}' if Mp != Mr else ''}) bound_ms={bms:.4f} ({by}) "
              f"bitwise=True GB/s={nbytes / ms / 1e6:.0f}")
        del qx, a, qw, sw, out, qxp
    del w_head
    torch.cuda.empty_cache()

    # [3m] The MoE slice's expert-batched K1 and K2 (one launch per stacked-expert
    # linear, all E experts on the grid), at the shapes granite-moe-3b-a800m and
    # llama4-scout-17b-a16e give them: K1's rows body over E=40 experts' C=8 decode
    # rows, K=1536 bf16, per-expert column factors, at α=1 (bitwise) and the
    # calibrated α=0.15 (the dense linears' bar: torch's pow and powf part by an ulp
    # on a few inputs); K2's decode body at C=8 for granite's up/gate (K=1536,
    # N=512) and down (K=512, N=1536) and llama4's up (E=16, K=5120, N=8192); its
    # wgmma body at granite's admission (C=512, the 4 x 512 bucket) and chunked
    # (C=128, budget 512) dispatch buffers; its tile body beside them. Each bitwise
    # against the per-expert plain version, eagerly and under graph replay. Empty
    # capacity rows (zeros) are part of every buffer. Inputs from a generator of
    # their own. No single PyTorch call computes a batched int8 product, so
    # library_ms is null.
    gen_e = torch.Generator(device=dev)
    gen_e.manual_seed(2020)
    E1, C1, K1 = 40, 8, 1536
    xe = (torch.randn(E1, C1, K1, generator=gen_e, device=dev) * 2).to(torch.bfloat16)
    xe[:, :, torch.randperm(K1, generator=gen_e, device=dev)[:8]] *= 30
    xe[3, 5:] = 0                                   # empty capacity rows
    bcol_e = torch.rand(E1, K1, generator=gen_e, device=dev) * 3 + 0.25
    for alpha_v in (1.0, 0.15):
        alpha_e = torch.full((E1,), alpha_v, device=dev)
        routed, splits = act_quantize_plan(E1 * C1, K1)
        before = dict(ops.BODY_LAUNCHES)
        q, a = ops.act_quantize_experts(xe, bcol_e, alpha_e)
        check(ops.BODY_LAUNCHES[f"act_quantize/experts_{routed}"]
              == before[f"act_quantize/experts_{routed}"] + 1,
              f"act_quantize_experts did not run the {routed} body")
        qr, ar = ref.act_quantize_experts_ref(xe, bcol_e, 8, alpha_e)
        call = (lambda: act_quantize_cuda(xe.reshape(E1 * C1, K1), bcol_e, alpha_e, 0.0, 8,
                                          routed, splits, rows_per_expert=C1))
        worst = (0, 0, 0)
        for qb, ab in ((q, a), replay(call)):
            torch.cuda.synchronize()
            qb, ab = qb.reshape(qr.shape), ab.reshape(ar.shape)
            d = (qb.int() - qr.int()).abs()
            n_off = int((d > 0).sum())
            a_ulps = int((ab.view(torch.int32) - ar.view(torch.int32)).abs().max())
            if alpha_v == 1.0:
                check(n_off == 0 and a_ulps == 0, f"act_quantize_experts α=1: {n_off} codes "
                      f"and {a_ulps}-ulp scales differ from the plain version")
            else:
                check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel() and a_ulps <= 1,
                      f"act_quantize_experts α={alpha_v}: max |dq|={int(d.max())}, off="
                      f"{n_off}, a {a_ulps} ulp")
            worst = max(worst, (int(d.max()), n_off, a_ulps))
        ms = graph_ms(once(call), 200)
        cms = time_ms(once(lambda: ops.act_quantize_experts(xe, bcol_e, alpha_e)), 200)
        pms = time_ms(once(lambda: ref.act_quantize_experts_ref(xe, bcol_e, 8, alpha_e)), 5)
        nbytes = E1 * C1 * K1 * 2 + E1 * K1 * 4 + E1 * 4 + E1 * C1 * K1 + E1 * C1 * 4
        bms, by = bound(nbytes, 6 * E1 * C1 * K1, PEAK_OPS["f32"])
        results[(f"act_quantize/experts_{routed}", E1, C1, K1, alpha_v)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=float(worst[0]))
        print(f"[3m] act_quantize_experts E={E1} C={C1} K={K1} bf16 α={alpha_v}: routed to the "
              f"{routed} body (E·C={E1 * C1} rows) kernel_ms={ms:.4f} call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} library_ms=None bound_ms={bms:.4f} ({by}) "
              f"GB/s={nbytes / ms / 1e6:.0f} max|dq|={worst[0]} off_by_one<={worst[1]}/"
              f"{q.numel()} a_max_ulp={worst[2]} (eager and graph replay)")
    del xe, bcol_e, q, a, qr, ar

    k2e_shapes = [(40, 8, 1536, 512), (40, 8, 512, 1536), (16, 8, 5120, 8192),
                  (40, 512, 1536, 512), (40, 512, 512, 1536), (40, 128, 1536, 512),
                  (40, 128, 512, 1536)]
    for (E2, C2, K2, N2) in k2e_shapes:
        qx = torch.randint(-127, 128, (E2, C2, K2), generator=gen_e, device=dev,
                           dtype=torch.int8)
        qx[1, C2 // 2:] = 0                         # empty capacity rows
        # rotate through copies of the expert weights so the timed loop reads them
        # from device memory, as a serving step does
        n_copies = max(1, min(8, math.ceil(3 * L2_BYTES / (E2 * K2 * N2))))
        qws = [torch.randint(-127, 128, (E2, K2, N2), generator=gen_e, device=dev,
                             dtype=torch.int8) for _ in range(n_copies)]
        qw = qws[0]
        a = torch.rand(E2, C2, 1, generator=gen_e, device=dev) * 0.1 + 1e-3
        sw = torch.rand(E2, N2, generator=gen_e, device=dev) * 0.1 + 1e-3
        routed, splits = qgemm_w8a8_plan(C2, K2, N2, experts=E2)
        bodies = {"tile": lambda i=0: qgemm_w8a8_cuda(qx, qws[i % n_copies], a, sw,
                                                       experts=E2)}
        if routed == "decode":
            bodies["decode"] = lambda i=0: qgemm_w8a8_decode_cuda(
                qx, qws[i % n_copies], a, sw, splits, experts=E2)
        else:
            bodies["wgmma"] = lambda i=0: qgemm_w8a8_wgmma_cuda(
                qx, qws[i % n_copies], a, sw, splits, experts=E2)
        before = dict(ops.BODY_LAUNCHES)
        out = ops.qgemm_w8a8_experts(qx, qw, a, sw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/experts_{routed}"]
              == before[f"qgemm_w8a8/experts_{routed}"] + 1,
              f"qgemm_w8a8_experts E={E2} C={C2} K={K2} N={N2} did not run the {routed} body")
        want = ref.qgemm_w8a8_experts_ref(qx, qw, a, sw)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"qgemm_w8a8_experts E={E2} C={C2} K={K2} N={N2} not "
              f"bitwise: {err}")
        for b, fn in bodies.items():
            for o in (fn(), replay(once(fn))[0]):
                torch.cuda.synchronize()
                check(torch.equal(o, want), f"qgemm_w8a8_experts {b} body E={E2} C={C2} K={K2} "
                      f"N={N2} not bitwise (eager or graph replay)")
        body_ms = {}
        for b in [routed, "tile", routed]:
            t = graph_ms(bodies[b], 10 if C2 >= 128 else 30)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        ms = body_ms[routed]
        cms = time_ms(lambda i=0: ops.qgemm_w8a8_experts(qx, qws[i % n_copies], a, sw), 20)
        pms = time_ms(lambda i=0: ref.qgemm_w8a8_experts_ref(qx, qws[i % n_copies], a, sw), 2)
        nbytes = E2 * (C2 * K2 + K2 * N2 + C2 * 4 + N2 * 4 + C2 * N2 * 4)
        bms, by = bound(nbytes, 2 * E2 * C2 * N2 * K2, PEAK_OPS["int8"])
        for b, t in body_ms.items():
            results[(f"qgemm_w8a8/experts_{b}", E2, C2, K2, N2)] = dict(
                ms=t, call_ms=cms if b == routed else None, plain_ms=pms, library_ms=None,
                bound_ms=bms, bound_by=by, max_abs_err=err)
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3m] qgemm_w8a8_experts E={E2} C={C2} K={K2} N={N2}: routed to the {routed} "
              f"body ({splits} splits) kernel_ms={ms:.4f} ({times}) call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} library_ms=None bound_ms={bms:.4f} ({by}) bitwise=True "
              f"GB/s={nbytes / ms / 1e6:.0f} tops={2 * E2 * C2 * N2 * K2 / ms / 1e9:.1f}")
        del qx, qws, qw, a, sw, out, want
    torch.cuda.empty_cache()
    # [3m] end

    # [3s] The SSM and hybrid slice's shapes (mamba2-130m and zamba2-1.2b), inputs from
    # a generator of their own. K1 at the in/out projections' K (768 and 1536 for
    # mamba2, 2048 and 4096 for zamba2), M=4 and 2048, bf16 rows with outlier
    # channels: held as at the main path's shapes (codes off by one on <= 1e-5 of
    # them, a within one ulp), eagerly and under graph replay, and timed. K2's tile
    # body at mamba2's in_proj (K=768, N=2·1536 + 2·128 + 24 = 3352, off the
    # 16-column grid, so every M routes there), M=4 and 2048, bitwise eagerly and
    # under graph replay, with torch._int_mm on the same operands and the decode or
    # wgmma body on the weight padded to N=3360 beside it, to size a later fix. K2's
    # routed bodies at zamba2's in_proj (K=2048, N=8384) and out_proj (K=4096,
    # N=2048) and mamba2's out_proj (K=1536, N=768), bitwise eagerly and under
    # graph replay. K3 bf16 at zamba2's shared attention (B=4, H=Hkv=32, D=64,
    # S=512) with SDPA beside it, and K4 with bf16 q over an int8 and an f32 pool
    # at the same heads (group size 1), both within the bf16 bar.
    print(f"[3s] start at {time.perf_counter() - t_start:.1f}s")
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(2121)
    for Mr in (4, 2048):
        for K in (768, 1536, 2048, 4096):
            x = (torch.randn(Mr, K, generator=gen_s, device=dev) * 2).to(torch.bfloat16)
            x[:, torch.randperm(K, generator=gen_s, device=dev)[:8]] *= 30
            bcol = torch.rand(K, generator=gen_s, device=dev) * 3 + 0.25
            alpha = torch.tensor(0.15, device=dev)
            routed, splits = act_quantize_plan(Mr, K)
            before = dict(ops.BODY_LAUNCHES)
            q, a = ops.act_quantize(x, bcol, alpha)
            check(ops.BODY_LAUNCHES[f"act_quantize/{routed}"]
                  == before[f"act_quantize/{routed}"] + 1,
                  f"act_quantize M={Mr} K={K} did not run the {routed} body")
            qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
            call = (lambda: act_quantize_cuda(x, bcol, alpha, 0.0, 8, routed, splits))
            worst = (0, 0, 0)
            for qb, ab in ((q, a), replay(call)):
                torch.cuda.synchronize()
                d = (qb.int() - qr.int()).abs()
                n_off = int((d > 0).sum())
                a_ulps = int((ab.view(torch.int32) - ar.view(torch.int32)).abs().max())
                check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel() and a_ulps <= 1,
                      f"act_quantize M={Mr} K={K}: max |dq|={int(d.max())}, off={n_off}, "
                      f"a {a_ulps} ulp")
                worst = max(worst, (int(d.max()), n_off, a_ulps))
            ms = graph_ms(once(call), 200)
            cms = time_ms(once(lambda: ops.act_quantize(x, bcol, alpha)), 200)
            pms = graph_ms(once(lambda: ref.act_quantize_ref(x, bcol, 8, alpha)), 20)
            nbytes = Mr * K * 2 + K * 4 + Mr * K + Mr * 4
            bms, by = bound(nbytes, 6 * Mr * K, PEAK_OPS["f32"])
            results[(f"act_quantize/{routed}", Mr, K)] = dict(
                ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
                max_abs_err=float(worst[0]))
            print(f"[3s] act_quantize M={Mr} K={K} bf16: routed to the {routed} body "
                  f"({splits} ranks) kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} "
                  f"library_ms=None bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f} "
                  f"max|dq|={worst[0]} off_by_one<={worst[1]}/{q.numel()} "
                  f"a_max_ulp={worst[2]} (eager and graph replay)")
    del x, bcol, q, a, qr, ar

    k2s_shapes = [(m, k, n) for m in (4, 2048)
                  for (k, n) in ((768, 3352), (1536, 768), (2048, 8384), (4096, 2048))]
    for (Mr, K, N) in k2s_shapes:
        qx = torch.randint(-127, 128, (Mr, K), generator=gen_s, device=dev, dtype=torch.int8)
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N))))
        qws = [torch.randint(-127, 128, (K, N), generator=gen_s, device=dev, dtype=torch.int8)
               for _ in range(n_copies)]
        qw = qws[0]
        a = torch.rand(Mr, 1, generator=gen_s, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N, generator=gen_s, device=dev) * 0.1 + 1e-3
        routed, splits = qgemm_w8a8_plan(Mr, K, N)
        bodies = {"tile": lambda i=0: qgemm_w8a8_cuda(qx, qws[i % n_copies], a, sw)}
        if routed == "decode":
            bodies["decode"] = lambda i=0: qgemm_w8a8_decode_cuda(qx, qws[i % n_copies], a, sw,
                                                                  splits)
        elif routed == "wgmma":
            bodies["wgmma"] = lambda i=0: qgemm_w8a8_wgmma_cuda(qx, qws[i % n_copies], a, sw,
                                                                splits)
        check((routed == "tile") == (N % 16 != 0), f"qgemm_w8a8 M={Mr} K={K} N={N} routes to "
              f"the {routed} body")
        before = dict(ops.BODY_LAUNCHES)
        out = ops.qgemm_w8a8(qx, qw, a, sw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/{routed}"] == before[f"qgemm_w8a8/{routed}"] + 1,
              f"qgemm_w8a8 M={Mr} K={K} N={N} did not run the {routed} body")
        want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"qgemm_w8a8 M={Mr} K={K} N={N} not bitwise: {err}")
        for b, fn in bodies.items():
            for o in (fn(), replay(once(fn))[0]):
                torch.cuda.synchronize()
                check(torch.equal(o, want), f"qgemm_w8a8 {b} body M={Mr} K={K} N={N} not "
                      f"bitwise (eager or graph replay)")
        body_ms = {}
        for b in [routed] + [b for b in bodies if b != routed] + [routed]:
            t = graph_ms(bodies[b], 20 if Mr >= 512 else 50)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        extra = {}
        if routed == "tile":
            # the same product on the weight padded to the next multiple of 16 columns,
            # where the decode or wgmma body takes it: what padding N would buy
            Np = -(-N // 16) * 16
            qwps = [torch.nn.functional.pad(w_, (0, Np - N)) for w_ in qws]
            swp = torch.nn.functional.pad(sw, (0, Np - N))
            pbody, psplits = qgemm_w8a8_plan(Mr, K, Np)
            pfn = {"decode": qgemm_w8a8_decode_cuda, "wgmma": qgemm_w8a8_wgmma_cuda}[pbody]
            pout = pfn(qx, qwps[0], a, swp, psplits)
            torch.cuda.synchronize()
            check(torch.equal(pout[:, :N], want), f"qgemm_w8a8 {pbody} body at N={Np} (padded) "
                  f"differs from the tile body's bits on the first {N} columns")
            extra = {f"n{Np}_{pbody}_ms": graph_ms(
                lambda i=0: pfn(qx, qwps[i % n_copies], a, swp, psplits),
                20 if Mr >= 512 else 50)}
            del qwps
        ms = body_ms[routed]
        cms = time_ms(lambda i=0: ops.qgemm_w8a8(qx, qws[i % n_copies], a, sw), 50)
        pms = graph_ms(lambda i=0: ref.qgemm_w8a8_ref(qx, qws[i % n_copies], a, sw), 3)
        Mp = max(Mr, 32)
        qxp = torch.zeros(Mp, K, dtype=torch.int8, device=dev)
        qxp[:Mr] = qx
        lms = graph_ms(lambda i=0: torch._int_mm(qxp, qws[i % n_copies]), 20)
        lib = "torch._int_mm" + (f", M padded to {Mp}" if Mp != Mr else "")
        nbytes = Mr * K + K * N + Mr * 4 + N * 4 + Mr * N * 4
        bms, by = bound(nbytes, 2 * Mr * N * K, PEAK_OPS["int8"])
        for b, t in body_ms.items():
            results[(f"qgemm_w8a8/{b}", Mr, K, N)] = dict(
                ms=t, call_ms=cms if b == routed else None, plain_ms=pms, library_ms=lms,
                library=lib, bound_ms=bms, bound_by=by, max_abs_err=err,
                gb_s=nbytes / t / 1e6, **extra)
        times = " ".join([f"{b}_ms={t:.4f}" for b, t in body_ms.items()]
                         + [f"{b}={t:.4f}" for b, t in extra.items()])
        print(f"[3s] qgemm_w8a8 M={Mr} K={K} N={N}: routed to the {routed} body ({splits} "
              f"splits) kernel_ms={ms:.4f} ({times}) call_ms={cms:.4f} plain_ms={pms:.4f} "
              f"library_ms={lms:.4f} ({lib}) bound_ms={bms:.4f} ({by}) bitwise=True "
              f"GB/s={nbytes / ms / 1e6:.0f} tops={2 * Mr * N * K / ms / 1e9:.1f}")
        del qx, qws, qw, a, sw, out, want, qxp

    B3s, H3s, D3s, S3s = 4, 32, 64, 512
    kv_len = torch.tensor([S3s, S3s - 37, S3s // 2, S3s // 3 + 1], device=dev, dtype=torch.int32)
    q, k, v = (torch.randn(B3s, H3s, S3s, D3s, generator=gen_s, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = ops.BODY_LAUNCHES["flash_attention/bf16_mma"]
    out = ops.flash_attention(q, k, v, kv_len)
    check(ops.BODY_LAUNCHES["flash_attention/bf16_mma"] == before + 1,
          "flash_attention H=Hkv=32 did not run the bf16 body")
    want = ref.flash_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    ok, n_ulp = bf16_bar(out, want)
    check(ok, f"flash_attention H=Hkv=32 D=64 bf16: max err {err} beyond 2e-2 or one bf16 ulp")
    ms = graph_ms(once(lambda: ops.flash_attention(q, k, v, kv_len)), 20)
    cms = time_ms(once(lambda: ops.flash_attention(q, k, v, kv_len)), 20)
    pms = graph_ms(once(lambda: ref.flash_attention_ref(q, k, v, kv_len)), 5)
    pos = torch.arange(S3s, device=dev)
    mask = ((pos[:, None] >= pos[None, :])[None, None]
            & (pos[None, None, None, :] < kv_len.view(-1, 1, 1, 1)))
    lms = graph_ms(lambda i=0: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20)
    kvl = kv_len.cpu().numpy()
    live = sum(int(np.minimum(np.arange(1, S3s + 1), n).sum()) for n in kvl)
    nbytes = 4 * q.numel() * 2 + 4 * B3s
    bms, by = bound(nbytes, 4 * D3s * H3s * live, PEAK_OPS["bf16"])
    results[("flash_attention", S3s, "bf16", "mha32")] = dict(
        ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by,
        max_abs_err=err)
    print(f"[3s] flash_attention (bf16_mma) B={B3s} H={H3s}/{H3s} S={S3s} D={D3s} bf16 kv_len="
          f"{kvl.tolist()}: kernel_ms={ms:.4f} call_ms={cms:.4f} plain_ms={pms:.4f} "
          f"library_ms={lms:.4f} (sdpa) bound_ms={bms:.4f} ({by}) max_abs_err={err:.2e} "
          f"tol=2e-2 or one bf16 ulp ({n_ulp} by the ulp)")
    del q, k, v, out, want, mask

    ps4, Hkv4s = 8, 32
    maxP4 = MAX_LEN // ps4
    P4 = B4 * maxP4
    tab = torch.full((B4, maxP4), P4, dtype=torch.int32, device=dev)
    perm = torch.randperm(P4, generator=gen_s, device=dev).to(torch.int32)
    off = 0
    for b in range(B4 - 1):                         # slot 3 keeps an all-sentinel row
        n = -(-int(kvl_np[b]) // ps4)
        tab[b, :n] = perm[off: off + n]
        off += n
    live = int(kvl_np.sum())
    for pool_dt in (torch.int8, torch.float32):
        shape = (P4, ps4, Hkv4s, D3s)
        if pool_dt == torch.int8:
            kp, vp = (torch.randint(-127, 128, shape, generator=gen_s, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(shape[:3] + (1,), generator=gen_s, device=dev) * 0.05 + 2e-3
                      for _ in range(2))
        else:
            kp, vp = (torch.randn(shape, generator=gen_s, device=dev) for _ in range(2))
            ks = vs = None
        sc = dict(k_scale_pages=ks, v_scale_pages=vs)
        q = torch.randn(B4, 1, Hkv4s, D3s, generator=gen_s, device=dev).to(torch.bfloat16)
        call = lambda: ops.paged_decode_attention(q, kp, vp, tab, kv_len4, **sc)  # noqa: E731
        plain = lambda: ref.paged_decode_attention_ref(  # noqa: E731
            q.reshape(B4, Hkv4s, 1, D3s), kp, vp, tab, kv_len4, **sc)
        before = ops.BODY_LAUNCHES["paged_attention/bf16_mma"]
        out = call()
        check(ops.BODY_LAUNCHES["paged_attention/bf16_mma"] == before + 1,
              "paged decode H=Hkv=32 did not run the split bf16 body")
        want = plain().reshape(out.shape)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), "paged decode H=Hkv=32: non-finite")
        err = float((out[:B4 - 1].float() - want[:B4 - 1].float()).abs().max())
        ok, n_ulp = bf16_bar(out[:B4 - 1], want[:B4 - 1])
        check(ok, f"paged decode H=Hkv=32 pool {dt_name[pool_dt]}: max err {err} beyond 2e-2 "
                  f"or one bf16 ulp")
        check(torch.equal(replay(call)[0], out), "paged decode H=Hkv=32: graph replay differs "
              "from the eager launch")
        ms = graph_ms(once(call), 50)
        cms = time_ms(once(call), 50)
        pms = graph_ms(once(plain), 5)
        row_bytes = Hkv4s * D3s * pool_dt.itemsize * 2 + (8 * Hkv4s if ks is not None else 0)
        nbytes = live * row_bytes + 2 * q.numel() * 2 + tab.numel() * 4 + 4 * B4
        bms, by = bound(nbytes, 4 * D3s * Hkv4s * live, PEAK_OPS["bf16"])
        results[("paged_decode_attention", "bf16", dt_name[pool_dt], ps4, "mha32")] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=err)
        print(f"[3s] paged_decode_attention (bf16_mma) B={B4} H={Hkv4s}/{Hkv4s} D={D3s} ps={ps4} "
              f"q bf16 pool {dt_name[pool_dt]} kv_len={kvl_np.tolist()}: kernel_ms={ms:.4f} "
              f"call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None bound_ms={bms:.5f} ({by}) "
              f"max_abs_err={err:.2e} tol=2e-2 or one bf16 ulp ({n_ulp} by the ulp); graph "
              f"replay bitwise")
        del kp, vp, ks, vs, q, out, want
    torch.cuda.empty_cache()
    # [3s] end

    # [3t] The tensor-parallel slice's two kernel modes at starcoder2-7b's row-parallel
    # shard shapes at tp=2: wo (K = 4608/2 = 2304, N = 4608) and down (K = 18432/2 =
    # 9216, N = 4608), M = 4 (decode), 128 and 2048 (admissions). K1's given-max mode
    # (the row max from outside: the MAX all-reduce of the ranks' maxima) on each of
    # a row's two column shards: bitwise the same kernel's codes and scales on the
    # whole row, sliced (the tensor-parallel contract); against its plain version
    # bitwise at α = 1 (no pow) and within K1's bar at α = 0.15; eager and under
    # graph replay; timed beside K1's own body on the same (M, K). K2's int32-out
    # mode on every body that takes the shape: bitwise against the plain int32
    # product and torch._int_mm (the library column; qx padded to 32 rows at M = 4),
    # its accumulator dequantized in the epilogue order bitwise K2's output, eager and
    # under graph replay, timed beside K2's f32 body. K7's int32-out mode (the SKIP
    # instantiations) at the down shape over alternating empty k-tiles, M = 4 and
    # 128, bitwise against the plain masked product, beside K7's f32 body. Inputs
    # from a generator of their own.
    print(f"[3t] start at {time.perf_counter() - t_start:.1f}s")
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(2424)
    tp_shapes = [(m, k) for m in (4, 128, 2048) for k in (2304, 9216)]
    for Mr, K in tp_shapes:
        x = (torch.randn(Mr, 2 * K, generator=gen_t, device=dev) * 2).to(torch.bfloat16)
        x[:, torch.randperm(2 * K, generator=gen_t, device=dev)[:8]] *= 30
        bcol = torch.rand(2 * K, generator=gen_t, device=dev) * 3 + 0.25
        gmax = x.float().abs().amax(dim=-1)
        xs, bs = x[:, :K].contiguous(), bcol[:K].contiguous()
        routed, splits = act_quantize_plan(Mr, K)
        worst = (0, 0, 0)
        for alpha_v in (1.0, 0.15):
            alpha = torch.tensor(alpha_v, device=dev)
            qf, af = ops.act_quantize(x, bcol, alpha)
            before = dict(ops.BODY_LAUNCHES)
            q, a = ops.act_quantize(xs, bs, alpha, row_max=gmax)
            check(ops.BODY_LAUNCHES[f"act_quantize/given_{routed}"]
                  == before[f"act_quantize/given_{routed}"] + 1,
                  f"[3t] act_quantize given-max M={Mr} K={K} did not run the {routed} body")
            qr, ar = ref.act_quantize_ref(xs, bs, 8, alpha, row_max=gmax)
            call = (lambda: act_quantize_cuda(xs, bs, alpha, 0.0, 8, routed, splits,
                                              row_max=gmax))
            for qb, ab in ((q, a), replay(call)):
                torch.cuda.synchronize()
                check(torch.equal(qb, qf[:, :K]) and torch.equal(ab, af),
                      f"[3t] given-max M={Mr} K={K} α={alpha_v}: not bitwise the whole row's "
                      f"codes and scales, sliced")
                d = (qb.int() - qr.int()).abs()
                n_off = int((d > 0).sum())
                a_ulps = int((ab.view(torch.int32) - ar.view(torch.int32)).abs().max())
                if alpha_v == 1.0:
                    check(n_off == 0 and a_ulps == 0, f"[3t] given-max α=1 M={Mr} K={K}: "
                          f"{n_off} codes, {a_ulps}-ulp scales differ from the plain version")
                else:
                    check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel() and a_ulps <= 1,
                          f"[3t] given-max α=0.15 M={Mr} K={K}: max |dq|={int(d.max())}, "
                          f"off={n_off}, a {a_ulps} ulp")
                worst = max(worst, (int(d.max()), n_off, a_ulps))
        ms = graph_ms(once(call), 200)
        own_ms = graph_ms(once(lambda: act_quantize_cuda(xs, bs, alpha, 0.0, 8, routed,
                                                         splits)), 200)
        ms = min(ms, graph_ms(once(call), 200))
        cms = time_ms(once(lambda: ops.act_quantize(xs, bs, alpha, row_max=gmax)), 200)
        pms = graph_ms(once(lambda: ref.act_quantize_ref(xs, bs, 8, alpha, row_max=gmax)), 20)
        nbytes = Mr * K * 2 + K * 4 + Mr * 4 + Mr * K + Mr * 4
        bms, by = bound(nbytes, 6 * Mr * K, PEAK_OPS["f32"])
        results[(f"act_quantize/given_{routed}", Mr, K)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=float(worst[0]), own_body_ms=own_ms)
        print(f"[3t] act_quantize given-max M={Mr} K={K} bf16 (one of two column shards): "
              f"{routed} body kernel_ms={ms:.4f} (the body computing its own max on the same "
              f"shape {own_ms:.4f}) call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None "
              f"bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f}; bitwise the whole "
              f"row's, sliced; vs plain max|dq|={worst[0]} off_by_one<={worst[1]}/{q.numel()} "
              f"a_max_ulp={worst[2]} (bitwise at α=1; eager and graph replay)")
        del x, xs, qf, q, qr
    N_t = 4608
    for Mr, K in tp_shapes:
        qx = torch.randint(-127, 128, (Mr, K), generator=gen_t, device=dev, dtype=torch.int8)
        n_copies = max(1, min(64, math.ceil(3 * L2_BYTES / (K * N_t))))
        qws = [torch.randint(-127, 128, (K, N_t), generator=gen_t, device=dev,
                             dtype=torch.int8) for _ in range(n_copies)]
        qw = qws[0]
        a = torch.rand(Mr, 1, generator=gen_t, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N_t, generator=gen_t, device=dev) * 0.1 + 1e-3
        routed, _ = qgemm_w8a8_plan(Mr, K, N_t)
        splits, wsplits = decode_splits(K, N_t), wgmma_splits(Mr, K, N_t)
        bodies = {"tile": lambda i=0: qgemm_w8a8_cuda(qx, qws[i % n_copies], None, None)}
        if Mr <= 128:
            bodies["decode"] = lambda i=0: qgemm_w8a8_decode_cuda(qx, qws[i % n_copies], None,
                                                                  None, splits)
        if Mr > DECODE_MAX_M:
            bodies["wgmma"] = lambda i=0: qgemm_w8a8_wgmma_cuda(qx, qws[i % n_copies], None,
                                                                None, wsplits)
        before = dict(ops.BODY_LAUNCHES)
        acc = ops.qgemm_w8a8_acc(qx, qw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/i32_{routed}"]
              == before[f"qgemm_w8a8/i32_{routed}"] + 1,
              f"[3t] qgemm_w8a8 int32-out M={Mr} K={K} did not run the {routed} body")
        want = ref.qgemm_w8a8_acc_ref(qx, qw)
        Mp = max(Mr, 32)
        qxp = torch.zeros(Mp, K, dtype=torch.int8, device=dev)
        qxp[:Mr] = qx
        lib_acc = torch._int_mm(qxp, qw)[:Mr]
        torch.cuda.synchronize()
        check(acc.dtype == torch.int32 and torch.equal(acc, want) and torch.equal(acc, lib_acc),
              f"[3t] int32-out M={Mr} K={K}: not bitwise the plain product and torch._int_mm")
        check(torch.equal((acc.float() * a) * sw, ops.qgemm_w8a8(qx, qw, a, sw)),
              f"[3t] int32-out M={Mr} K={K}: dequantized in the epilogue order != K2's output")
        for b, fn in bodies.items():
            check(torch.equal(fn(), want) and torch.equal(replay(fn)[0], want),
                  f"[3t] int32-out {b} body M={Mr} K={K} not bitwise (eager or graph replay)")
        body_ms = {}
        for b in [routed] + [b for b in bodies if b != routed] + [routed]:
            t = graph_ms(bodies[b], 20 if Mr >= 512 else 50)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        ms = body_ms[routed]
        f32_fn = {"tile": lambda i=0: qgemm_w8a8_cuda(qx, qws[i % n_copies], a, sw),
                  "decode": lambda i=0: qgemm_w8a8_decode_cuda(qx, qws[i % n_copies], a, sw,
                                                               splits),
                  "wgmma": lambda i=0: qgemm_w8a8_wgmma_cuda(qx, qws[i % n_copies], a, sw,
                                                             wsplits)}[routed]
        f32_ms = graph_ms(f32_fn, 20 if Mr >= 512 else 50)
        cms = time_ms(lambda i=0: ops.qgemm_w8a8_acc(qx, qws[i % n_copies]), 50)
        pms = graph_ms(lambda i=0: ref.qgemm_w8a8_acc_ref(qx, qws[i % n_copies]), 3)
        lms = graph_ms(lambda i=0: torch._int_mm(qxp, qws[i % n_copies]), 20)
        lib = "torch._int_mm" + (f", M padded to {Mp}" if Mp != Mr else "")
        nbytes = Mr * K + K * N_t + Mr * N_t * 4
        bms, by = bound(nbytes, 2 * Mr * N_t * K, PEAK_OPS["int8"])
        results[(f"qgemm_w8a8/i32_{routed}", Mr, K, N_t)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms, library=lib, bound_ms=bms,
            bound_by=by, max_abs_err=0.0, body_ms=body_ms, f32_body_ms=f32_ms,
            gb_s=nbytes / ms / 1e6)
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3t] qgemm_w8a8 int32-out M={Mr} K={K} N={N_t}: routed to the {routed} body "
              f"(decode splits {splits}, wgmma splits {wsplits}) kernel_ms={ms:.4f} ({times}; "
              f"K2's f32 {routed} body on the same shape {f32_ms:.4f}) call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} library_ms={lms:.4f} ({lib}) bound_ms={bms:.4f} ({by}) "
              f"bitwise=True (plain, torch._int_mm, every body eager and graph replay) "
              f"GB/s={nbytes / ms / 1e6:.0f}")
        del qws, qw, qxp
    for Mr in (4, 128):
        K, N = 9216, N_t
        qx = torch.randint(-127, 128, (Mr, K), generator=gen_t, device=dev, dtype=torch.int8)
        qw = torch.randint(-127, 128, (K, N), generator=gen_t, device=dev, dtype=torch.int8)
        tiles = (torch.arange(-(-K // 64), device=dev) % 2 == 0)[:, None].expand(-1, -(-N // 64))
        keep = tiles.repeat_interleave(64, 0).repeat_interleave(64, 1)[:K, :N].to(torch.uint8)
        qw = qw * keep.to(torch.int8)
        mask = packing.pack_mask(keep, axis=0)
        occ = ops.tile_occupancy(mask, K)
        a = torch.rand(Mr, 1, generator=gen_t, device=dev) * 0.1 + 1e-3
        sw = torch.rand(N, generator=gen_t, device=dev) * 0.1 + 1e-3
        routed, _ = qgemm_w8a8_sparse_plan(Mr, K, N)
        before = dict(ops.BODY_LAUNCHES)
        acc = ops.qgemm_w8a8_sparse_acc(qx, qw, mask, occ)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8_sparse/i32_{routed}"]
              == before[f"qgemm_w8a8_sparse/i32_{routed}"] + 1,
              f"[3t] K7 int32-out M={Mr} did not run the {routed} body")
        want = ref.qgemm_w8a8_sparse_acc_ref(qx, qw, mask)
        fn = lambda: ops.qgemm_w8a8_sparse_acc(qx, qw, mask, occ)  # noqa: E731
        check(torch.equal(acc, want) and torch.equal(replay(fn)[0], want),
              f"[3t] K7 int32-out M={Mr} K={K} N={N}: not bitwise (eager or graph replay)")
        ms = graph_ms(once(fn), 50)
        f32_ms = graph_ms(once(lambda: ops.qgemm_w8a8_sparse(qx, qw, a, sw, mask, occ)), 50)
        pms = graph_ms(once(lambda: ref.qgemm_w8a8_sparse_acc_ref(qx, qw, mask)), 3)
        qxp = torch.zeros(max(Mr, 32), K, dtype=torch.int8, device=dev)
        qxp[:Mr] = qx
        lms = graph_ms(once(lambda: torch._int_mm(qxp, qw)), 20)
        nbytes = Mr * K + K * N // 2 + occ.numel() * 4 + Mr * N * 4
        bms, by = bound(nbytes, Mr * N * K, PEAK_OPS["int8"])
        results[(f"qgemm_w8a8_sparse/i32_{routed}", Mr, K, N)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by, max_abs_err=0.0,
            f32_body_ms=f32_ms)
        print(f"[3t] qgemm_w8a8_sparse int32-out M={Mr} K={K} N={N}, every other 64-row "
              f"k-tile empty: {routed} body kernel_ms={ms:.4f} (K7's f32 output "
              f"{f32_ms:.4f}) plain_ms={pms:.4f} library_ms={lms:.4f} (torch._int_mm, dense"
              f"{', M padded to 32' if Mr < 32 else ''}) bound_ms={bms:.4f} ({by}) "
              f"bitwise=True (eager and graph replay)")
        del qx, qw, qxp
    # [3t] end

    # [3u] Data-parallel, W4A8, expert_tp and SSM sharding: three kernel modes at
    # their shard shapes.
    # K8's group-acc mode (a row-parallel W4A8 linear: each group's int32 partial
    # written as out[m, g, n], gathered across the ranks before the group dequant) at
    # starcoder2-7b's wo and down shards at tp=2 (K = 2304 and 9216, g128: 18 and 72
    # groups; N = 4608), M = 4, 128 and 2048: every body that takes the shape bitwise
    # against the plain per-group product, eager and under graph replay, timed beside
    # K8's own (f32, group-folded) mode on the same body and shape. The expert-batched
    # K1 in its given-max mode and the expert-batched K2 in its int32-out mode at
    # granite-moe's down shard under expert_tp at tp=2 (E = 40, d_ff_expert 512 / 2 =
    # 256 input columns, N = 1536), C = 8 (decode) and 512 (a 4 x 512 admission): K1
    # bitwise the whole rows' codes and scales, sliced, and against its plain version
    # bitwise at α = 1, within K1's bar at α = 0.15, timed beside its own-max mode; K2
    # bitwise the plain int32 einsum on the routed and tile bodies, its accumulators
    # dequantized in K2's epilogue order bitwise the expert-batched K2, timed beside
    # that f32 mode. No single PyTorch call computes any of the three (library None).
    print(f"[3u] start at {time.perf_counter() - t_start:.1f}s")
    gen_u = torch.Generator(device=dev)
    gen_u.manual_seed(2525)
    N_u, G_u = 4608, 128
    for Mr, K in [(m, k) for m in (4, 128, 2048) for k in (2304, 9216)]:
        G = K // G_u
        qx = torch.randint(-127, 128, (Mr, K), generator=gen_u, device=dev, dtype=torch.int8)
        n_copies = max(1, min(32, math.ceil(3 * L2_BYTES / (K * N_u // 2))))
        qws = [torch.randint(-128, 128, (K // 2, N_u), generator=gen_u, device=dev,
                             dtype=torch.int8) for _ in range(n_copies)]
        qw4 = qws[0]
        a = torch.rand(Mr, 1, generator=gen_u, device=dev) * 0.1 + 1e-3
        sw = torch.rand(G, N_u, generator=gen_u, device=dev) * 0.01 + 1e-4
        routed, _ = qgemm_w4a8_plan(Mr, K, N_u, G_u)
        splits, wsplits = w4a8_decode_splits(K, N_u, G_u), w4a8_wgmma_splits(Mr, K, N_u, G_u)
        bodies = {"tile": lambda i=0: qgemm_w4a8_cuda(qx, qws[i % n_copies], None, None, G_u)}
        own = {"tile": lambda i=0: qgemm_w4a8_cuda(qx, qws[i % n_copies], a, sw, G_u)}
        if Mr <= 128:
            bodies["decode"] = lambda i=0: qgemm_w4a8_decode_cuda(
                qx, qws[i % n_copies], None, None, G_u, splits)
            own["decode"] = lambda i=0: qgemm_w4a8_decode_cuda(qx, qws[i % n_copies], a, sw,
                                                               G_u, splits)
        if Mr > DECODE_MAX_M:
            bodies["wgmma"] = lambda i=0: qgemm_w4a8_wgmma_cuda(
                qx, qws[i % n_copies], None, None, G_u, wsplits)
            own["wgmma"] = lambda i=0: qgemm_w4a8_wgmma_cuda(qx, qws[i % n_copies], a, sw, G_u,
                                                             wsplits)
        before = dict(ops.BODY_LAUNCHES)
        acc = ops.qgemm_w4a8_group_acc(qx, qw4, group=G_u)
        check(ops.BODY_LAUNCHES[f"qgemm_w4a8/gacc_{routed}"]
              == before[f"qgemm_w4a8/gacc_{routed}"] + 1,
              f"[3u] K8 group-acc M={Mr} K={K} did not run the {routed} body")
        want = ref.qgemm_w4a8_group_acc_ref(qx, qw4, G_u)
        torch.cuda.synchronize()
        check(acc.dtype == torch.int32 and acc.shape == (Mr, G, N_u) and torch.equal(acc, want),
              f"[3u] K8 group-acc M={Mr} K={K}: not bitwise the plain per-group product")
        for b, fn in bodies.items():
            check(torch.equal(fn(), want) and torch.equal(replay(fn)[0], want),
                  f"[3u] K8 group-acc {b} body M={Mr} K={K}: not bitwise (eager or replay)")
        folded = (acc.float() * sw).sum(dim=-2) * a
        k8 = ops.qgemm_w4a8(qx, qw4, a, sw, group=G_u)
        d_fold = float((folded - k8).abs().max() / k8.abs().max())
        body_ms = {}
        for b in [routed] + [b for b in bodies if b != routed] + [routed]:
            t = graph_ms(bodies[b], 20 if Mr >= 512 else 50)
            body_ms[b] = t if b not in body_ms else min(body_ms[b], t)
        ms = body_ms[routed]
        own_ms = graph_ms(own[routed], 20 if Mr >= 512 else 50)
        cms = time_ms(lambda i=0: ops.qgemm_w4a8_group_acc(qx, qws[i % n_copies], group=G_u), 50)
        pms = graph_ms(lambda i=0: ref.qgemm_w4a8_group_acc_ref(qx, qws[i % n_copies], G_u), 3)
        nbytes = Mr * K + K * N_u // 2 + Mr * G * N_u * 4
        bms, by = bound(nbytes, 2 * Mr * N_u * K, PEAK_OPS["int8"])
        results[(f"qgemm_w4a8/gacc_{routed}", Mr, K)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=0.0, body_ms=body_ms, own_body_ms=own_ms, gb_s=nbytes / ms / 1e6)
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3u] qgemm_w4a8 group-acc M={Mr} K={K} N={N_u} g{G_u} ({G} groups): routed to "
              f"the {routed} body (decode splits {splits}, wgmma splits {wsplits}) "
              f"kernel_ms={ms:.4f} ({times}; K8's own group-folded {routed} body on the same "
              f"shape {own_ms:.4f}) call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None "
              f"bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f}; bitwise=True (plain, "
              f"every body eager and graph replay); folded in the plain order vs K8 "
              f"{d_fold:.2e} of max|y|")
        del qws, qw4, acc, want, folded, k8
    E_u, K_u, Nd_u = 40, 256, 1536
    for C_u in (8, 512):
        x = (torch.randn(E_u, C_u, 2 * K_u, generator=gen_u, device=dev) * 2).to(torch.bfloat16)
        x[:, :, torch.randperm(2 * K_u, generator=gen_u, device=dev)[:4]] *= 30
        x[0, C_u // 2:] = 0
        bcol = torch.rand(E_u, 2 * K_u, generator=gen_u, device=dev) * 3 + 0.25
        gmax = x.float().abs().amax(dim=-1)
        xs, bs = x[..., :K_u].contiguous(), bcol[:, :K_u].contiguous()
        routed, splits = act_quantize_plan(E_u * C_u, K_u)
        worst = (0, 0, 0)
        for alpha_v in (1.0, 0.15):
            alpha = torch.full((E_u,), alpha_v, device=dev)
            qf, af = ops.act_quantize_experts(x, bcol, alpha)
            before = dict(ops.BODY_LAUNCHES)
            q, a = ops.act_quantize_experts(xs, bs, alpha, row_max=gmax)
            check(ops.BODY_LAUNCHES[f"act_quantize/experts_given_{routed}"]
                  == before[f"act_quantize/experts_given_{routed}"] + 1,
                  f"[3u] expert given-max C={C_u} did not run the {routed} body")
            qr, ar = ref.act_quantize_experts_ref(xs, bs, 8, alpha, row_max=gmax)
            call = (lambda: act_quantize_cuda(xs.reshape(E_u * C_u, K_u), bs, alpha, 0.0, 8,
                                              routed, splits, rows_per_expert=C_u,
                                              row_max=gmax.reshape(-1)))
            for qb, ab in ((q, a), tuple(t.reshape(s.shape) for t, s in zip(replay(call),
                                                                             (q, a)))):
                torch.cuda.synchronize()
                check(torch.equal(qb, qf[..., :K_u]) and torch.equal(ab, af),
                      f"[3u] expert given-max C={C_u} α={alpha_v}: not bitwise the whole "
                      f"rows' codes and scales, sliced")
                d = (qb.int() - qr.int()).abs()
                n_off = int((d > 0).sum())
                a_ulps = int((ab.view(torch.int32) - ar.view(torch.int32)).abs().max())
                if alpha_v == 1.0:
                    check(n_off == 0 and a_ulps == 0, f"[3u] expert given-max α=1 C={C_u}: "
                          f"{n_off} codes, {a_ulps}-ulp scales differ from the plain version")
                else:
                    check(int(d.max()) <= 1 and n_off <= 1e-5 * q.numel() and a_ulps <= 1,
                          f"[3u] expert given-max α=0.15 C={C_u}: max |dq|={int(d.max())}, "
                          f"off={n_off}, a {a_ulps} ulp")
                worst = max(worst, (int(d.max()), n_off, a_ulps))
        ms = min(graph_ms(once(call), 200), graph_ms(once(call), 200))
        own_ms = graph_ms(once(lambda: act_quantize_cuda(
            xs.reshape(E_u * C_u, K_u), bs, alpha, 0.0, 8, routed, splits,
            rows_per_expert=C_u)), 200)
        cms = time_ms(once(lambda: ops.act_quantize_experts(xs, bs, alpha, row_max=gmax)), 200)
        pms = graph_ms(once(lambda: ref.act_quantize_experts_ref(xs, bs, 8, alpha,
                                                                 row_max=gmax)), 3)
        rows_u = E_u * C_u
        nbytes = rows_u * K_u * 2 + E_u * K_u * 4 + E_u * 4 + rows_u * 4 + rows_u * K_u + rows_u * 4
        bms, by = bound(nbytes, 6 * rows_u * K_u, PEAK_OPS["f32"])
        results[(f"act_quantize/experts_given_{routed}", E_u, C_u, K_u)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=float(worst[0]), own_body_ms=own_ms)
        print(f"[3u] act_quantize experts given-max E={E_u} C={C_u} K={K_u} bf16 (one of two "
              f"column shards): {routed} body kernel_ms={ms:.4f} (its own-max mode on the "
              f"same shape {own_ms:.4f}) call_ms={cms:.4f} plain_ms={pms:.4f} library_ms=None "
              f"bound_ms={bms:.4f} ({by}) GB/s={nbytes / ms / 1e6:.0f}; bitwise the whole "
              f"rows', sliced; vs plain max|dq|={worst[0]} off_by_one<={worst[1]}/{q.numel()} "
              f"a_max_ulp={worst[2]} (bitwise at α=1; eager and graph replay)")
        qx = torch.randint(-127, 128, (E_u, C_u, K_u), generator=gen_u, device=dev,
                           dtype=torch.int8)
        qx[1, C_u // 2:] = 0
        qw = torch.randint(-127, 128, (E_u, K_u, Nd_u), generator=gen_u, device=dev,
                           dtype=torch.int8)
        a = torch.rand(E_u, C_u, 1, generator=gen_u, device=dev) + 0.01
        sw = torch.rand(E_u, Nd_u, generator=gen_u, device=dev) + 0.01
        routed, splits = qgemm_w8a8_plan(C_u, K_u, Nd_u, experts=E_u)
        before = dict(ops.BODY_LAUNCHES)
        acc = ops.qgemm_w8a8_experts_acc(qx, qw)
        check(ops.BODY_LAUNCHES[f"qgemm_w8a8/experts_i32_{routed}"]
              == before[f"qgemm_w8a8/experts_i32_{routed}"] + 1,
              f"[3u] expert int32-out C={C_u} did not run the {routed} body")
        want = ref.qgemm_w8a8_experts_acc_ref(qx, qw)
        bodies = {"tile": lambda: qgemm_w8a8_cuda(qx, qw, None, None, experts=E_u)}
        fn = {"decode": qgemm_w8a8_decode_cuda, "wgmma": qgemm_w8a8_wgmma_cuda}.get(routed)
        if fn is not None:
            bodies[routed] = lambda: fn(qx, qw, None, None, splits, experts=E_u)
        torch.cuda.synchronize()
        check(torch.equal(acc, want), f"[3u] expert int32-out C={C_u}: not bitwise the plain")
        check(torch.equal((acc.float() * a) * sw[:, None], ops.qgemm_w8a8_experts(qx, qw, a, sw)),
              f"[3u] expert int32-out C={C_u}: dequantized in the epilogue order != K2's")
        for b, f in bodies.items():
            check(torch.equal(f(), want) and torch.equal(replay(f)[0], want),
                  f"[3u] expert int32-out {b} body C={C_u}: not bitwise (eager or replay)")
        body_ms = {b: graph_ms(once(f), 50) for b, f in bodies.items()}
        ms = min(body_ms[routed], graph_ms(once(bodies[routed]), 50))
        own_ms = graph_ms(once(lambda: ops.qgemm_w8a8_experts(qx, qw, a, sw)), 50)
        cms = time_ms(once(lambda: ops.qgemm_w8a8_experts_acc(qx, qw)), 50)
        pms = graph_ms(once(lambda: ref.qgemm_w8a8_experts_acc_ref(qx, qw)), 3)
        nbytes = E_u * C_u * K_u + E_u * K_u * Nd_u + E_u * C_u * Nd_u * 4
        bms, by = bound(nbytes, 2 * E_u * C_u * K_u * Nd_u, PEAK_OPS["int8"])
        results[(f"qgemm_w8a8/experts_i32_{routed}", E_u, C_u, K_u, Nd_u)] = dict(
            ms=ms, call_ms=cms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by,
            max_abs_err=0.0, body_ms=body_ms, f32_body_ms=own_ms, gb_s=nbytes / ms / 1e6)
        times = " ".join(f"{b}_ms={t:.4f}" for b, t in body_ms.items())
        print(f"[3u] qgemm_w8a8 experts int32-out E={E_u} C={C_u} K={K_u} N={Nd_u}: routed to "
              f"the {routed} body (splits {splits}) kernel_ms={ms:.4f} ({times}; the "
              f"expert-batched K2's f32 mode on the same shape {own_ms:.4f}) call_ms={cms:.4f} "
              f"plain_ms={pms:.4f} library_ms=None bound_ms={bms:.4f} ({by}) "
              f"GB/s={nbytes / ms / 1e6:.0f}; bitwise=True (plain, routed and tile bodies "
              f"eager and graph replay)")
        del x, xs, qf, q, qr, qx, qw, acc, want
    # [3u] end

    # ---------------------------------------------------------------- phase 4
    print(f"[4] start at {time.perf_counter() - t_start:.1f}s")
    cfg = get("starcoder2-7b")
    quant = ql.W8A8_INT8
    quant4 = dataclasses.replace(ql.W4A8_G128, mode="int8")
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
    tables = calibrate(params, cfg, quant, calib_batches=2, seq_len=16, batch_size=BATCH, seed=0)
    qparams = quantize_tree(params, quant, tables=tables)
    q4params = quantize_tree(params, quant4, tables=tables)      # the same calibration
    torch.cuda.synchronize()
    q_bytes, q4_bytes = quantized_bytes(qparams), quantized_bytes(q4params)
    print(f"[4] {cfg.name} FULL: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e9:.2f}B init {t_init:.1f}s, calibrate+PTQ W8A8 and "
          f"W4A8-g128 {time.perf_counter() - t0:.1f}s, weights {fp_bytes / 2**30:.2f} GiB -> "
          f"W8A8 {q_bytes / 2**30:.2f} GiB, W4A8 {q4_bytes / 2**30:.2f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(min(LENS) >= 128, "every prompt's bucket reaches the flash kernel")
    prompts = make_prompts(cfg.vocab, LENS, len(LENS), seed=0)
    linears = linear_shapes(cfg)                    # wq wk wv wo up down
    launches = {name: 0 for name in ops.LAUNCHES}
    body_launches = {name: 0 for name in ops.BODY_LAUNCHES}
    e2e, call_ms = {}, {}

    def serve(label: str, reqs, tree=None, q=quant, gemm="qgemm_w8a8", path="fused-int8",
              plan=None, max_new=MAX_NEW, model=None, experts=(), layers=None, **kw):
        """One serving run of ``reqs`` at full width and depth. The kernel counts are
        zeroed just before the run and read just after, and must equal what its
        schedule implies. On the ``fake`` and ``dequant-fp`` paths the linears are
        plain torch and prefill attention the plain path: no act_quantize, GEMM or
        flash launch at all, 32 paged decode launches per decode step of a paged
        engine. On ``fused-int8``: per model step 192 act_quantize launches and 192 of the
        tree's GEMM (qgemm_w8a8, or qgemm_w4a8 for a W4A8 tree, or
        qgemm_w8a8_sparse for masks with empty tiles); an act_quantize launch on
        the body act_quantize_plan gives its step's token rows (the step's M) and
        the linear's K (the split body up to 32 rows, the rows body above), a
        qgemm_w8a8, qgemm_w8a8_sparse or qgemm_w4a8 launch on the body its plan
        gives: the decode body up to DECODE_MAX_M, the wgmma body above; the run's
        GEMM launches at least once; 32 flash launches (the bf16 body) per cold
        admission of 128 tokens or more; 32 paged decode launches per decode step of
        a paged engine; 32 verify launches per speculative step; on a chunked engine
        32 ragged launches per packed step and 32 paged decode launches per
        pure-decode step, and no flash launch. A chunked engine with fp KV and
        speculate=1 serves its decode-only steps (the traffic ends in a decode-only
        tail) through the decode step, one with int8 KV never does. ``plan``: the
        engine's ``sparsity_plan``. ``model``: (cfg, linears per layer, head, batch
        size, max_len) of another model than starcoder2-7b, whose prepared tree is
        ``tree``; every count above then scales with its layers and linears, and an
        untied head (``head``: its (K, N), prepared on the fly) adds one K1 and one
        K2 launch per model step, on the bodies its rows give (a prefill's last
        positions, every row of the other steps). ``experts``: the (K, N) of a
        mixture of experts' stacked linears (up, gate, down), each one expert-batched
        K1 and K2 launch per layer and model step, K1 on the body act_quantize_plan
        gives E·C rows and K2 on the body qgemm_w8a8_plan gives C rows per expert,
        C the capacity of the step's token rows; ``mlinears`` then lists the
        attention's linears and a shared expert's. ``layers``: (times ``mlinears``
        repeats per model call, attention layers per model call) where these are
        not (n_layers, n_layers): an SSM or hybrid stack, whose ``mlinears`` is then
        every linear of one model call, (1, 0) for mamba2 and (1, 6) for zamba2's
        shared attention."""
        kernels = path == "fused-int8"
        mcfg, mlinears, mhead, mbatch, mmax_len = model or (cfg, linears, None, BATCH,
                                                            MAX_LEN)
        engine = ServeEngine(mcfg, qparams if tree is None else tree, quant=q, device=dev,
                             config=EngineConfig(batch_size=mbatch, max_len=mmax_len,
                                                 path=path, **kw), sparsity_plan=plan)
        cold_buckets = []                      # flash serves cold prefills only
        attr = "_admit_cold" if engine.paged else "_admit_step"
        admit = getattr(engine, attr)

        def counted(p, tokens, *rest):
            cold_buckets.append(tokens.shape[1])
            return admit(p, tokens, *rest)

        setattr(engine, attr, counted)
        step_rows, step_ms = [], []            # every model step's token rows (GEMM M), wall ms
        head_rows = []                         # the rows the head sees: the last ones at prefill
        apply = M.apply

        def apply_counted(p, inputs, *rest, **kw):
            t0 = time.perf_counter()
            out = apply(p, inputs, *rest, **kw)
            torch.cuda.synchronize()               # the engine syncs each step for its tokens
            step_rows.append(inputs["tokens"].numel())
            head_rows.append(inputs["tokens"].shape[0] if kw.get("mode") == "prefill"
                             else inputs["tokens"].numel())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        engine.submit(reqs, max_new=max_new)
        torch.cuda.synchronize()
        ops.reset_launches()
        M.apply = apply_counted
        t0 = time.perf_counter()
        try:
            done = engine.run()
            torch.cuda.synchronize()
        finally:
            M.apply = apply
        dt = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        bodies = dict(ops.BODY_LAUNCHES)
        c = engine.counters
        L, L_attn = layers or (mcfg.n_layers, mcfg.n_layers)
        if engine.chunked:
            steps = c["chunk_steps"] + c["chunk_decode_only_steps"]
            k4_expected = engine.spec == 1 and not engine.kv_int8
            check((c["chunk_decode_only_steps"] > 0) == k4_expected,
                  f"{label}: {c['chunk_decode_only_steps']} decode-only steps took the "
                  f"decode launch (fp KV, speculate=1: some; int8 KV or speculative: none)")
        else:
            steps = c["prefill_calls"] + c["decode_steps"]
        n_tok = sum(len(r.out) for r in done)
        check(len(done) == len(reqs) and all(len(r.out) == max_new for r in done),
              f"{label}: every request gets {max_new} tokens")
        check(all(0 <= t < mcfg.vocab for r in done for t in r.out), f"{label}: token ids")
        want = {name: 0 for name in ops.LAUNCHES}
        per_step = (len(mlinears) + len(experts)) * L + (mhead is not None)
        if kernels:
            want.update({"act_quantize": per_step * steps, gemm: per_step * steps})
        if engine.chunked:
            want["ragged_prefill_attention"] = L_attn * c["chunk_steps"]
            want["paged_decode_attention"] = L_attn * c["chunk_decode_only_steps"]
        else:
            if kernels:
                want["flash_attention"] = L_attn * sum(b >= 128 for b in cold_buckets)
            if engine.paged:
                want["paged_decode_attention"] = (L_attn * c["decode_steps"] if engine.spec == 1
                                                  else 0)
                want["paged_verify_attention"] = L_attn * c["spec_steps"] if engine.spec > 1 else 0
        for name, n in want.items():
            check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n} "
                  f"(prefill_calls={c['prefill_calls']} decode_steps={c['decode_steps']} "
                  f"spec_steps={c['spec_steps']} chunk_steps={c['chunk_steps']} decode-only "
                  f"steps={c['chunk_decode_only_steps']} cold buckets={cold_buckets})")
        check(counts[gemm] > 0 or not kernels, f"{label}: no {gemm} launch")
        check(len(step_rows) == steps, f"{label}: {len(step_rows)} model calls != {steps} steps")
        want_bodies = {name: 0 for name in ops.BODY_LAUNCHES}
        for rows, hrows in zip(step_rows, head_rows) if kernels else ():
            if mhead is not None:
                K, N = mhead
                want_bodies[f"act_quantize/{act_quantize_plan(hrows, K)[0]}"] += 1
                want_bodies[f"qgemm_w8a8/{qgemm_w8a8_plan(hrows, K, N)[0]}"] += 1
            E, C = mcfg.n_experts, moe_capacity(rows, mcfg) if experts else 0
            for K, N in experts:
                want_bodies[f"act_quantize/experts_{act_quantize_plan(E * C, K)[0]}"] += L
                want_bodies[f"qgemm_w8a8/experts_{qgemm_w8a8_plan(C, K, N, experts=E)[0]}"] += L
            for K, N in mlinears:
                want_bodies[f"act_quantize/{act_quantize_plan(rows, K)[0]}"] += L
                if gemm == "qgemm_w8a8":
                    want_bodies[f"qgemm_w8a8/{qgemm_w8a8_plan(rows, K, N)[0]}"] += L
                elif gemm == "qgemm_w8a8_sparse":
                    body = qgemm_w8a8_sparse_plan(rows, K, N)[0]
                    want_bodies[f"qgemm_w8a8_sparse/{body}"] += L
                elif gemm == "qgemm_w4a8":
                    want_bodies[f"qgemm_w4a8/{qgemm_w4a8_plan(rows, K, N, q.w_group)[0]}"] += L
        want_bodies["flash_attention/bf16_mma"] = want["flash_attention"]
        # the serving q is bf16: every paged launch runs the split tensor-core body
        want_bodies["paged_attention/bf16_mma"] = (want["paged_decode_attention"]
                                                   + want["paged_verify_attention"]
                                                   + want["ragged_prefill_attention"])
        check(bodies == want_bodies, f"{label}: body launches {bodies} != {want_bodies} "
              f"(step rows {step_rows})")
        for name in launches:
            launches[name] += counts[name]
        for name in body_launches:
            body_launches[name] += bodies[name]
        e2e[label] = n_tok / dt
        small = [t for r, t in zip(step_rows, step_ms) if r <= DECODE_MAX_M]
        large = [t for r, t in zip(step_rows, step_ms) if r > DECODE_MAX_M]
        call_ms[label] = float(np.median(small)) if small else None
        med = lambda x: f"{float(np.median(x)):.1f}" if x else "-"  # noqa: E731
        print(f"[4]   {label}: model call wall ms (synchronised), median of {len(small)} "
              f"with <= {DECODE_MAX_M} token rows {med(small)}, of {len(large)} larger "
              f"{med(large)}; all calls {sum(step_ms) / 1e3:.2f}s of {dt:.2f}s")
        kv = engine.caches.get("shared", engine.caches["blocks"][0])
        kv = kv.get("k_pages" if engine.paged else "k")
        print(f"[4] serve {label}: path={path} {len(done)} requests, {n_tok} tokens in {dt:.2f}s = "
              f"{n_tok / dt:.1f} tok/s; prefill_calls={c['prefill_calls']} (cold buckets "
              f"{cold_buckets}) decode_steps={c['decode_steps']} occupancy="
              f"{engine.occupancy():.2f} kv pool dtype={None if kv is None else kv.dtype} "
              f"launches="
              f"{ {k: v for k, v in counts.items() if v} } bodies="
              f"{ {k: v for k, v in bodies.items() if v} }; req0 out[:8]={done[0].out[:8]}")
        return engine, done

    # paged traffic: 8 requests behind one 389-token system prefix
    rng = np.random.default_rng(4)
    system = rng.integers(1, cfg.vocab, size=SYSTEM_PREFIX).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(1, cfg.vocab, size=n).astype(np.int32)])
              for n in SUFFIXES]

    # The paper's §4.1 quantization kernel on the card: make_sparsity_plan over the
    # launcher's calibration traffic (2 batches of 4 x 16 tokens), its observer pass
    # in fake W8A8 CrossQuant mode on the f32 tree, every measured input recorded
    t0 = time.perf_counter()
    calib = calibration_batches(cfg, calib_batches=2, seq_len=16, batch_size=BATCH, seed=0,
                                device=dev)
    plan, records = recorded_plan(make_sparsity_plan, KA, cfg, params, calib, threshold=0.05)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    L = cfg.n_layers
    per = {}                                 # (layer, kind) -> (cq fractions, pt fractions)
    for i, (_, cq, pt) in enumerate(records):
        key = ((i // len(KINDS)) % L, KINDS[i % len(KINDS)])
        per.setdefault(key, ([], []))
        per[key][0].append(cq)
        per[key][1].append(pt)
    cq_of = {k: float(np.float32(np.mean(v[0]))) for k, v in per.items()}
    pt_of = {k: float(np.float32(np.mean(v[1]))) for k, v in per.items()}
    for kind in KINDS:                       # the plan gates a stacked leaf on its worst layer
        worst = max(cq_of[(b, kind)] for b in range(L))
        check(plan.fractions[f"blocks/0/{kind}"] == worst,
              f"plan fraction of {kind} {plan.fractions[f'blocks/0/{kind}']} != worst layer "
              f"{worst}")
    print(f"[4] §4.1 make_sparsity_plan (fake W8A8 CrossQuant observer pass, 2 x {BATCH}x16 "
          f"tokens, {len(records)} linear inputs) in {t_plan:.2f}s; threshold 0.05: plan "
          f"layers {list(plan.layers)}")
    for kind in KINDS:
        cqs = [cq_of[(b, kind)] for b in range(L)]
        pts = [pt_of[(b, kind)] for b in range(L)]
        under = [b for b in range(L) if cq_of[(b, kind)] <= 0.05]
        print(f"[4]   kernel fraction {kind:9s} CrossQuant a=0.15 min/median/max "
              f"{min(cqs):.6f}/{float(np.median(cqs)):.6f}/{max(cqs):.6f}; per-token a=1 "
              f"{min(pts):.6f}/{float(np.median(pts)):.6f}/{max(pts):.6f}; "
              f"{len(under)} of {L} layers <= 0.05")
    n_smaller = sum(cq_of[k] < pt_of[k] for k in cq_of)
    print(f"[4]   CrossQuant's kernel is smaller than per-token's on {n_smaller} of {len(cq_of)} "
          f"linears (the paper's prediction; random weights, nothing claimed)")
    for kind in ("attn/wq", "mlp/down"):
        x2 = records[KINDS.index(kind)][0]          # layer 0, first calibration batch
        stats = {k: round(float(v), 6) for k, v in KA.table1_stats(x2).items()}
        scale = Q.crossquant_scale(x2, 8, 0.15)
        n_card = int(KA.kernel_count(x2, scale))
        n_cpu = int(KA.kernel_count(x2.cpu(), scale.cpu()))
        check(n_card == n_cpu, f"{kind} layer 0: kernel count card {n_card} != CPU {n_cpu}")
        print(f"[4]   layer 0 {kind} input {tuple(x2.shape)}: table1_stats {stats}; kernel "
              f"count card {n_card} == CPU {n_cpu} under the same scale tensor")
    del records

    # the paper's evaluation path on the f32 tree: fake W8A8 CrossQuant (dynamic c),
    # dense fp KV and paged int8 KV behind the shared prefix; then the W8-Remove
    # Kernel ablation (10 %) over one admission of two 512-token rows, whose down
    # projection input (2 x 512 x 18432) exceeds 2^24 elements
    fake = ql.W8A8_CROSSQUANT
    serve("dense fake W8A8-CrossQuant kv=fp", prompts[:BATCH], tree=params, q=fake, path="fake",
          kv_cache="fp")
    serve("paged fake W8A8-CrossQuant kv=int8", shared, tree=params, q=fake, path="fake",
          kv_cache="int8", cache_layout="paged")
    sizes = []
    quantile_cut = KA.remove_kernel_fraction

    def cut_counted(x, fraction):
        sizes.append(x.numel())
        return quantile_cut(x, fraction)

    KA.remove_kernel_fraction = cut_counted
    try:
        engine, _ = serve("dense fake remove-kernel 0.1 kv=fp", prompts[2:4], tree=params,
                          q=ql.remove_kernel_cfg(0.1), path="fake", max_new=4)
    finally:
        KA.remove_kernel_fraction = quantile_cut
    check(engine.counters["prefill_calls"] == 1 and max(sizes) > 2 ** 24,
          f"remove-kernel run: {engine.counters['prefill_calls']} admissions, largest "
          f"quantile input {max(sizes)} elements")
    print(f"[4]   remove-kernel: {len(sizes)} quantile cuts, the largest over {max(sizes)} "
          f"elements (2^24 = {2 ** 24})")
    del engine, params
    torch.cuda.empty_cache()

    # the dense, 2:4 and W4A8 runs serve the first 4 prompts, to hold the script's
    # time
    for kv in ("fp", "int8"):
        serve(f"dense fused-int8 kv={kv}", prompts[:BATCH], kv_cache=kv)

    # paged with radix reuse over the shared-prefix traffic
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

    # chunked prefill (token budget 128) over the shared-prefix traffic
    for kv in ("fp", "int8"):
        engine, _ = serve(f"chunked fused-int8 kv={kv}", shared, kv_cache=kv,
                          cache_layout="paged", chunked=True, token_budget=CHUNK_BUDGET)
        c = engine.counters
        check(c["chunk_steps"] > 0 and c["chunk_prefill_rows"] > 0,
              f"chunked kv={kv}: no packed prefill step")
        engine.pool.check()
        print(f"[4]   chunked kv={kv}: token_budget={engine.token_budget} "
              f"chunk_steps={c['chunk_steps']} chunk_prefill_rows={c['chunk_prefill_rows']} "
              f"chunk_decode_rows={c['chunk_decode_rows']} mid_decode_admissions="
              f"{c['mid_decode_admissions']} prefix_hit_rate={engine.prefix_hit_rate():.3f} "
              f"decode_steps={c['decode_steps']} decode_only_steps="
              f"{c['chunk_decode_only_steps']}")
        del engine

    # One profiler window, outside the timed serving runs: a few pure decode steps
    # of the dense fp-KV engine and a few packed steps of the chunked fp-KV engine,
    # split into device-busy time, the longest device ops, the host ops with the
    # most self time, and kernel launches and host syncs per step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch_names = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaGraphLaunch"}
    sync_names = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy"}

    def family(name: str):
        """The hand-written GEMM or quantize kernel a profiler kernel name belongs to:
        the decode body's template arguments are <MT, W4, SKIP>, the wgmma body's
        <BM, SKIP>, the tile body's <MODE> (0 K2, 1 K7, 2 K8)."""
        if "act_quant" in name:
            return "K1 act_quantize"
        if "qgemm_w4a8_wgmma" in name:
            return "K8 qgemm_w4a8"
        for kern in ("qgemm_decode_kernel<", "qgemm_wgmma_kernel<", "qgemm_kernel<"):
            if kern in name:
                args = [t.strip() for t in name.split(kern)[1].split(">")[0].split(",")]
                if args == ["2"] or (kern == "qgemm_decode_kernel<" and args[1] == "true"):
                    return "K8 qgemm_w4a8"
                if args == ["1"] or args[-1] == "true":
                    return "K7 qgemm_w8a8_sparse"
                return "K2 qgemm_w8a8"
        return None

    def range_device_ms(prof, ranges, n_steps=1):
        """{range: (device ms, kernels) per step} of the kernels that PyTorch ops
        opened inside each ``record_function`` range launched (the profiler hangs
        each kernel on the op that launched it), the hand-written K1/K2/K7/K8
        kernels left out: the range's plain ops."""
        events = prof.events()
        out = {}
        for r in ranges:
            spans = [(e.time_range.start, e.time_range.end) for e in events
                     if e.name == r and e.device_type == DeviceType.CPU]
            tot, n = 0.0, 0
            for e in events:
                if e.device_type == DeviceType.CPU and e.kernels and any(
                        s0 <= e.time_range.start <= e0 for s0, e0 in spans):
                    plain_k = [k for k in e.kernels if family(k.name) is None]
                    tot += sum(k.duration for k in plain_k)
                    n += len(plain_k)
            out[r] = (tot / 1e3 / n_steps, n / n_steps)
        return out

    def report_window(label, prof, wall_us, n_steps, ranges=(), what="", tag="[4t]"):
        """Print a profiler window's device-busy share, launches and host syncs per
        step, its longest device ops and host ops, and the device time of the
        hand-written kernels; returns those numbers (None when the profiler
        recorded no device activity). ``ranges``: names of ``record_function``
        ranges the window's code opens, each printed with the device time of the
        kernels launched under it per step."""
        events = prof.events()
        # the device side of a record_function range is a span, not a kernel
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if not kernels:
            print(f"{tag} {label}: the profiler recorded no device activity: device split not "
                  f"measured (wall {wall_us / 1e3 / n_steps:.1f} ms per step)")
            return None
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
        by_kernel = {}
        for e in kernels:
            tot, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        host = {}
        for e in events:
            if e.device_type == DeviceType.CPU:
                tot, n = host.get(e.name, (0.0, 0))
                host[e.name] = (tot + e.self_cpu_time_total, n + 1)
        n_launch = sum(n for name, (_, n) in host.items() if name in launch_names)
        n_sync = sum(n for name, (_, n) in host.items() if name in sync_names)
        n_item = host.get("aten::_local_scalar_dense", (0.0, 0))[1]
        print(f"{tag} {label}: {n_steps} steps{what} in {wall_us / 1e3:.1f} ms of wall time; "
              f"device busy {busy / 1e3:.2f} ms = {busy / wall_us:.3f} of the window; per step "
              f"{n_launch / n_steps:.0f} kernel launches, {n_sync / n_steps:.1f} host syncs "
              f"(stream/device/event synchronize, blocking memcpy) and "
              f"{n_item / n_steps:.1f} scalar reads (aten::_local_scalar_dense)")
        syncs = {name: n for name, (_, n) in host.items() if name in sync_names}
        print(f"{tag}   host syncs per step by call: "
              f"{ {name: round(n / n_steps, 1) for name, n in sorted(syncs.items())} }")
        for name, (tot, n) in sorted(by_kernel.items(), key=lambda x: -x[1][0])[:5]:
            print(f"{tag}   device {tot / 1e3 / n_steps:8.3f} ms/step  x{n / n_steps:6.1f}  "
                  f"{name[:110]}")
        fams = {}
        for name, (tot, n) in by_kernel.items():
            f = family(name)
            if f is not None:
                t0, n0 = fams.get(f, (0.0, 0))
                fams[f] = (t0 + tot, n0 + n)
        print(f"{tag}   device time per step by kernel: " + "; ".join(
            f"{f} {tot / 1e3 / n_steps:.3f} ms x{n / n_steps:.0f}"
            for f, (tot, n) in sorted(fams.items())))
        for name, (tot, n) in sorted(host.items(), key=lambda x: -x[1][0])[:10]:
            print(f"{tag}   host self {tot / 1e3 / n_steps:8.3f} ms/step  x{n / n_steps:6.1f}  "
                  f"{name[:110]}")
        in_ranges = range_device_ms(prof, ranges, n_steps)
        if ranges:
            print(f"{tag}   device time per step under " + "; ".join(
                f"{r} {t:.3f} ms x{n:.0f} kernels" for r, (t, n) in in_ranges.items()))
        return dict(wall_ms=wall_us / 1e3 / n_steps, busy_share=busy / wall_us,
                    launches=n_launch / n_steps, syncs=n_sync / n_steps, ranges=in_ranges)

    def trace(label, reqs, ready, n_steps=3, tree=None, q=quant, model_cfg=None, ranges=(),
              **kw):
        """A profiler window over ``n_steps`` engine steps, once ``ready(engine)``
        holds (:func:`report_window` prints it)."""
        engine = ServeEngine(model_cfg or cfg, qparams if tree is None else tree, quant=q,
                             device=dev,
                             config=EngineConfig(batch_size=BATCH, max_len=MAX_LEN,
                                                 path="fused-int8", **kw))
        engine.submit(reqs, max_new=MAX_NEW)
        finished = []
        c = engine.counters
        while not ready(engine):
            check(engine.step(finished), f"trace {label}: the engine went idle before the window")
        engine.step(finished)                 # one untraced step of the same kind first
        before = dict(c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step(finished)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kinds = {k: c[k] - before[k] for k in ("decode_steps", "chunk_steps", "prefill_calls")}
        return report_window(label, prof, wall_us, n_steps, ranges, what=f" ({kinds})")

    print(f"[4t] trace start at {time.perf_counter() - t_start:.1f}s")
    trace("dense fused-int8 kv=fp, decode steps", prompts[:BATCH],
          lambda e: not e.queue and e.counters["decode_steps"] > 0, kv_cache="fp")
    trace("chunked fused-int8 kv=fp, packed steps", shared,
          lambda e: e.counters["chunk_steps"] >= 2, kv_cache="fp", cache_layout="paged",
          chunked=True, token_budget=CHUNK_BUDGET)
    print(f"[4t] trace end at {time.perf_counter() - t_start:.1f}s")

    # 2:4 sparsity applied at engine build: every (64, 64) weight tile keeps
    # survivors, so the sparse wrapper runs K2, as the reference routes it
    engine, _ = serve("dense fused-int8 kv=fp sparsity=2:4", prompts[:BATCH], sparsity="2:4")
    sparse_tree = engine.params
    print(f"[4]   sparsity=2:4: quantized_bytes dense {quantized_bytes(sparse_tree) / 2**30:.3f} "
          f"GiB, deploy_sparse {quantized_bytes(sparse_tree, deploy_sparse=True) / 2**30:.3f} "
          f"GiB (W8A8 tree {q_bytes / 2**30:.3f} GiB)")
    del engine
    # the same tree with every other 64-row k-tile of every mask emptied (a
    # block-structured mask): the sparse wrapper now runs K7, which skips those tiles
    empty_odd_k_tiles(sparse_tree)
    engine, _ = serve("dense fused-int8 kv=fp block-sparse", prompts[:BATCH], tree=sparse_tree,
                      sparsity="2:4", gemm="qgemm_w8a8_sparse")
    del engine
    # a profiler window over 3 of its decode steps: K7's device time per step
    trace("dense fused-int8 kv=fp block-sparse, decode steps", prompts[:BATCH],
          lambda e: not e.queue and e.counters["decode_steps"] > 0, tree=sparse_tree,
          kv_cache="fp", sparsity="2:4")
    del sparse_tree

    # W4A8 g128 (int mode) from the same calibration tables, then a profiler window
    # over 3 of its decode steps
    serve("dense W4A8-g128 kv=fp", prompts[:BATCH], tree=q4params, q=quant4,
          gemm="qgemm_w4a8")
    trace("dense W4A8-g128 kv=fp, decode steps", prompts[:BATCH],
          lambda e: not e.queue and e.counters["decode_steps"] > 0, tree=q4params, q=quant4,
          kv_cache="fp")
    del q4params

    # dequant-fp on the calibrated W8A8 tree: the codes scaled back to f32 before an
    # fp product, dense fp KV and paged int8 KV behind the shared prefix
    serve("dense dequant-fp kv=fp", prompts[:BATCH], path="dequant-fp", kv_cache="fp")
    serve("paged dequant-fp kv=int8", shared, path="dequant-fp", kv_cache="int8",
          cache_layout="paged")

    # The fake twin: dequantize_tree of the W8A8 tree (f32 weights carrying the int
    # path's rounding, cmax from the folded b), served with static c and prequantized
    # weights, and held with dequant-fp against fused-int8 on the same inputs: a
    # prefill of the 4 dense prompts and 3 decode steps fed fused-int8's greedy
    # tokens. d = max|logit difference| on the first decode step must stay within 5 %
    # of max|logit|; the greedy choices must agree wherever fused-int8's top-1/top-2
    # margin exceeds 2d.
    twin = dequantize_tree(qparams, quant)
    twin_q = dataclasses.replace(ql.W8A8_CROSSQUANT, static_c=True, w_prequantized=True)
    serve("dense fake twin kv=fp", prompts[:BATCH], tree=twin, q=twin_q, path="fake",
          kv_cache="fp")
    lens4 = np.array([len(p) for p in prompts[:BATCH]], np.int32)
    toks4 = np.zeros((BATCH, 512), np.int64)
    for b, p in enumerate(prompts[:BATCH]):
        toks4[b, :len(p)] = p

    def first_steps(tree, ctx_, forced=None, steps=3):
        caches = M.init_cache(cfg, BATCH, MAX_LEN, dtype=torch.float32, device=dev)
        logits, _ = M.apply(tree, {"tokens": torch.as_tensor(toks4, device=dev)}, cfg,
                            ctx=ctx_, mode="prefill", caches=caches,
                            cur_len=torch.as_tensor(lens4, device=dev))
        out, fed = [logits[:, -1].float()], []
        for i in range(steps):
            tok = torch.argmax(out[-1], dim=-1) if forced is None else forced[i]
            fed.append(tok)
            logits, _ = M.apply(tree, {"tokens": tok[:, None]}, cfg, ctx=ctx_, mode="decode",
                                caches=caches, cur_len=torch.as_tensor(lens4 + i + 1, device=dev))
            out.append(logits[:, -1].float())
        return torch.stack(out), fed

    with torch.no_grad():
        t0 = time.perf_counter()
        fused_l, fed = first_steps(qparams, QuantContext(quant, use_kernels=True,
                                                         int_exec="kernel"))
        top2 = torch.topk(fused_l, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        scale_l = float(fused_l.abs().max())
        for label, tree, ctx_ in (("fake twin", twin, QuantContext(twin_q)),
                                  ("dequant-fp", qparams, QuantContext(quant,
                                                                       int_exec="dequant"))):
            other, _ = first_steps(tree, ctx_, forced=fed)
            d = float((other[1] - fused_l[1]).abs().max())
            sure = margin > 2 * d
            same = torch.argmax(other, dim=-1) == torch.argmax(fused_l, dim=-1)
            check(d <= 0.05 * scale_l, f"{label} vs fused-int8: d = {d} > 5 % of max|logit| "
                  f"{scale_l}")
            check(bool(same[sure].all()), f"{label} vs fused-int8: greedy choice differs "
                  f"where the margin exceeds 2d = {2 * d}")
            print(f"[4]   {label} vs fused-int8 (prefill of 4 prompts + 3 decode steps fed "
                  f"fused-int8's tokens): d = {d:.4e} on the first decode step, {d / scale_l:.4f} "
                  f"of max|logit| {scale_l:.3f} (bar 0.05); max over all steps "
                  f"{float((other - fused_l).abs().max()):.4e}; greedy equal at "
                  f"{int(same[sure].sum())} of {int(sure.sum())} (step, row) pairs with margin "
                  f"> 2d, at {int(same.sum())} of all {same.numel()}")
        torch.cuda.synchronize()
        print(f"[4]   twin/dequant-fp/fused-int8 logit comparison in "
              f"{time.perf_counter() - t0:.1f}s")
    del twin

    # 2:4 restricted to the §4.1 plan's layers (sparsity_plan=): K2 as in the
    # unrestricted 2:4 run; the plan's leaves, and only they, carry masks
    engine, _ = serve("dense fused-int8 kv=fp sparsity=2:4 §4.1 plan", prompts[:BATCH],
                      sparsity="2:4", plan=plan)
    masked = sorted(sparsity_summary(engine.params))
    check(masked == sorted(plan.layers), f"masked leaves {masked} != plan layers {plan.layers}")
    print(f"[4]   2:4 with the plan: masked leaves {masked}")
    del engine

    # the grouped baseline scheduler: one whole-batch group of 4 equal-length prompts,
    # drained before the next admission
    engine, _ = serve("dense fused-int8 kv=fp grouped", make_prompts(cfg.vocab, [300], BATCH,
                                                                     seed=6),
                      scheduler="grouped")
    check(engine.counters["prefill_calls"] == 1 and engine.counters["mid_decode_admissions"] == 0,
          f"grouped: {engine.counters['prefill_calls']} admissions")
    del engine, qparams
    torch.cuda.empty_cache()

    # The rest of the dense zoo at full width, each model's trees freed before the
    # next. gemma2-9b FULL (42 layers: 21 local, 21 global; window 4096, softcaps 50
    # and 30): calibrated with the launcher's traffic, W8A8 static-c CrossQuant, served
    # fused-int8 on the dense layout (fp KV, 4 prompts of 130-450 tokens: the window
    # does not bind), paged with int8 KV at max_len 8192 over a 4600- and a 300-token
    # prompt (the window binds: the local layers mask keys older than 4096 in K3 at
    # the cold admission and in K4 at every decode step) and chunked (int8 KV, budget
    # 512: the long prompt in 9 chunks, K6 past 4096 in the later ones)
    print(f"[4z] start at {time.perf_counter() - t_start:.1f}s")
    t_zoo = time.perf_counter()
    from repro_torch.core import calibration as calib_lib
    from repro_torch.serving.config import NotPortedError
    from repro_torch.serving.engine import make_prefill_step

    def build(name, seed, frames=0, w4=False, **cut):
        """A FULL config (cut by ``cut``: depth, dtype, window), its f32 tree from a
        seeded generator on the card, calibrated with the launcher's traffic (an
        audio model: 2 batches of 4 x ``frames`` seeded frames) and quantized to
        W8A8 static-c CrossQuant; the f32 tree is freed. Returns (cfg, W8A8 tree),
        and with ``w4`` also the W4A8 g128 tree from the same tables."""
        c = dataclasses.replace(get(name), **cut)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = M.init_params(g, c, device=dev)
        fp_b = quantized_bytes(params)
        if frames:
            obs = calib_lib.Observer()
            with torch.no_grad():
                for _ in range(2):
                    fr = torch.randn(BATCH, frames, c.frontend_dim, generator=g, device=dev)
                    M.apply(params, {"frames": fr}, c, ctx=QuantContext(quant, observer=obs),
                            mode="train", unroll=True)
            tables_ = calib_lib.stack_tables(obs.tables())
        else:
            tables_ = calibrate(params, c, quant, calib_batches=2, seq_len=16,
                                batch_size=BATCH, seed=seed)
        qtree = quantize_tree(params, quant, tables=tables_)
        q4tree = quantize_tree(params, quant4, tables=tables_) if w4 else None
        del params, tables_
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[4z] {c.name}: {c.n_layers} layers d_model={c.d_model} heads={c.n_heads}/"
              f"{c.n_kv_heads}x{c.head_dim} d_ff={c.d_ff} vocab={c.vocab} tied="
              f"{c.tie_embeddings} {c.dtype} params={fp_b / 4 / 1e9:.2f}B: init+calibrate"
              f"{'(frames)' if frames else ''}+PTQ {time.perf_counter() - t0:.1f}s, f32 "
              f"{fp_b / 2**30:.2f} GiB -> W8A8 {quantized_bytes(qtree) / 2**30:.2f} GiB; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return (c, qtree, q4tree) if w4 else (c, qtree)

    cfg_g, qparams_g = build("gemma2-9b", 9)
    check(cfg_g.n_layers == 42 and cfg_g.d_model == 3584 and cfg_g.head_dim == 256
          and cfg_g.window == 4096 and cfg_g.attn_softcap == 50.0
          and cfg_g.final_softcap == 30.0 and cfg_g.layer_pattern == "local_global",
          "gemma2-9b FULL config")
    model_g = (cfg_g, linear_shapes(cfg_g), None, BATCH, MAX_LEN)
    serve("gemma2-9b dense fused-int8 kv=fp", make_prompts(cfg_g.vocab, LENS[:BATCH], BATCH,
                                                          seed=9),
          tree=qparams_g, model=model_g, kv_cache="fp")
    long_g = make_prompts(cfg_g.vocab, [4600, 300], 2, seed=10)
    model_gl = (cfg_g, linear_shapes(cfg_g), None, 2, 8192)
    engine, _ = serve("gemma2-9b paged fused-int8 kv=int8 long context", long_g,
                      tree=qparams_g, model=model_gl, kv_cache="int8", cache_layout="paged",
                      page_size=16)
    engine.pool.check()
    del engine
    engine, _ = serve("gemma2-9b chunked fused-int8 kv=int8 long context", long_g,
                      tree=qparams_g, model=model_gl, kv_cache="int8", cache_layout="paged",
                      page_size=16, chunked=True, token_budget=512)
    c = engine.counters
    check(c["chunk_prefill_rows"] == 4900 and c["chunk_steps"] >= 9,
          f"gemma2 chunked: {c['chunk_prefill_rows']} prefill rows in {c['chunk_steps']} steps")
    print(f"[4z]   gemma2-9b chunked: chunk_steps={c['chunk_steps']} chunk_prefill_rows="
          f"{c['chunk_prefill_rows']} decode_steps={c['decode_steps']}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine, qparams_g
    torch.cuda.empty_cache()

    # nemotron-4-15b at full width, depth cut to 8 of 32 layers (calibration needs the
    # f32 tree: 62 GB at full depth): relu2, layernorm and the untied head at N =
    # 256000, its fp weights prepared on the fly every step (one more K1 and K2 per
    # model step); then what that preparation costs: the head's linear on 4 decode
    # rows with and without it, and the same tree served with a tied head
    cfg_n, qparams_n = build("nemotron-4-15b", 15, n_layers=8)
    head_n = (cfg_n.d_model, cfg_n.vocab_padded)
    check(cfg_n.d_model == 6144 and head_n[1] == 256000 and not cfg_n.tie_embeddings
          and "cmax" not in qparams_n["lm_head"], "nemotron-4-15b: untied fp head, N=256000")
    prompts_n = make_prompts(cfg_n.vocab, LENS[:BATCH], BATCH, seed=15)
    serve("nemotron-4-15b (8 layers) dense fused-int8 kv=fp", prompts_n, tree=qparams_n,
          model=(cfg_n, linear_shapes(cfg_n), head_n, BATCH, MAX_LEN), kv_cache="fp")
    tied_n = dataclasses.replace(cfg_n, tie_embeddings=True)
    serve("nemotron-4-15b (8 layers) tied twin dense fused-int8 kv=fp", prompts_n,
          tree={k: v for k, v in qparams_n.items() if k != "lm_head"},
          model=(tied_n, linear_shapes(cfg_n), None, BATCH, MAX_LEN), kv_cache="fp")
    xh = torch.randn(BATCH, 1, cfg_n.d_model, generator=gz, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        fly = once(lambda: ql.apply(qparams_n["lm_head"], xh, quant, use_kernels=True))
        prepared = ql.prepare_int8(qparams_n["lm_head"], quant, cmax=ql._col_absmax(xh),
                                   jitted=True)
        fixed = once(lambda: ql.apply(prepared, xh, quant, use_kernels=True))
        check(torch.equal(fly(), fixed()), "nemotron head: on-the-fly != prepared once")
        t_fly, t_fixed = time_ms(fly, 5), time_ms(fixed, 5)
    del prepared
    print(f"[4z]   nemotron-4-15b head (K={head_n[0]} N={head_n[1]}) on {BATCH} decode rows: "
          f"prepared on the fly {t_fly:.3f} ms, K1+K2 on a head prepared once {t_fixed:.3f} "
          f"ms: the per-step preparation costs {t_fly - t_fixed:.3f} ms; model-call median "
          f"untied {call_ms['nemotron-4-15b (8 layers) dense fused-int8 kv=fp']:.1f} ms, tied "
          f"twin {call_ms['nemotron-4-15b (8 layers) tied twin dense fused-int8 kv=fp']:.1f} "
          f"ms (its tied head casts the f32 embedding to bf16 every step)")
    del qparams_n
    torch.cuda.empty_cache()

    # hubert-xlarge FULL (48 layers, d_model 1280, 16 heads of 80, not causal): an
    # encoder, served by make_prefill_step (the slot-table engine refuses it),
    # calibrated on seeded frames (2 batches of 4 x 512 frames of 512 features), then
    # one fused-int8 prefill step over 4 x 512 frames: per layer 6 K1 and K2 launches
    # and one K3 (D = 80, non-causal, bf16 body), one more K1 and K2 for the untied
    # head (prepared on the fly over all 2048 rows); its logits held against the
    # dequant-fp path's on the same tree (within 5 % of max|logit|)
    cfg_h, qparams_h = build("hubert-xlarge", 48, frames=512)
    check(cfg_h.n_layers == 48 and cfg_h.head_dim == 80 and not cfg_h.causal,
          "hubert-xlarge FULL config")
    try:
        EngineConfig(batch_size=BATCH, max_len=MAX_LEN).check_model(cfg_h)
        check(False, "the engine accepts an encoder-only model")
    except NotPortedError:
        pass
    gh = torch.Generator(device=dev)
    gh.manual_seed(49)
    batch_h = {"frames": torch.randn(BATCH, 512, cfg_h.frontend_dim, generator=gh, device=dev)}
    step_h = make_prefill_step(cfg_h, quant, path="fused-int8")
    with torch.no_grad():
        step_h(qparams_h, batch_h, None)                  # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits_h, _ = step_h(qparams_h, batch_h, None)
        torch.cuda.synchronize()
        ms_h = (time.perf_counter() - t0) * 1e3
        counts, bodies = dict(ops.LAUNCHES), dict(ops.BODY_LAUNCHES)
        deq_h, _ = make_prefill_step(cfg_h, quant, path="dequant-fp")(qparams_h, batch_h, None)
    rows_h = BATCH * 512
    lin_h = linear_shapes(cfg_h) * cfg_h.n_layers + [(cfg_h.d_model, cfg_h.vocab_padded)]
    want = {name: 0 for name in ops.LAUNCHES}
    want.update(act_quantize=len(lin_h), qgemm_w8a8=len(lin_h), flash_attention=cfg_h.n_layers)
    want_b = {name: 0 for name in ops.BODY_LAUNCHES}
    for K, N in lin_h:
        want_b[f"act_quantize/{act_quantize_plan(rows_h, K)[0]}"] += 1
        want_b[f"qgemm_w8a8/{qgemm_w8a8_plan(rows_h, K, N)[0]}"] += 1
    want_b["flash_attention/bf16_mma"] = cfg_h.n_layers
    check(counts == want and bodies == want_b,
          f"hubert prefill step launches {counts} / {bodies} != {want} / {want_b}")
    for name in launches:
        launches[name] += counts[name]
    for name in body_launches:
        body_launches[name] += bodies[name]
    check(logits_h.shape == (BATCH, 1, cfg_h.vocab_padded)
          and bool(torch.isfinite(logits_h).all()), f"hubert logits {tuple(logits_h.shape)}")
    d_h = float((logits_h - deq_h).abs()[..., :cfg_h.vocab].max())
    s_h = float(logits_h[..., :cfg_h.vocab].abs().max())
    check(d_h <= 0.05 * s_h, f"hubert fused-int8 vs dequant-fp: {d_h} > 5 % of {s_h}")
    print(f"[4z]   hubert-xlarge make_prefill_step fused-int8 over {BATCH} x 512 frames: "
          f"model call {ms_h:.1f} ms (synchronised); launches "
          f"{ {k: v for k, v in counts.items() if v} } bodies "
          f"{ {k: v for k, v in bodies.items() if v} }; logits {tuple(logits_h.shape)}, "
          f"against dequant-fp d = {d_h:.4e} = {d_h / s_h:.4f} of max|logit| {s_h:.3f}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del qparams_h, logits_h, deq_h, batch_h
    torch.cuda.empty_cache()
    print(f"[4z] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_zoo:.1f}s "
          f"for the zoo)")

    # [4m] The MoE slice: granite-moe-3b-a800m FULL (32 layers, d_model 1536, 24/8
    # heads of 64, 40 experts top-8 of width 512, vocab 49155) calibrated with the
    # launcher's traffic, W8A8 static-c CrossQuant, served fused-int8: dense with fp
    # and int8 KV, paged (int8 KV) behind a 389-token shared prefix, paged
    # speculate=4 over motif-tiled prompts, chunked (int8 KV, budget 512). Per model
    # call 224 K1 and 224 K2 launches: 4 x 32 on the attention's linears (bodies by
    # the step's rows) and 3 x 32 expert-batched ones, one per stacked linear (K1's
    # body by E·C rows, K2's by the C rows per expert). Then llama4-scout-17b-a16e at
    # full width, depth cut to 2 of its 48 layers (its f32 tree is 2.2 G parameters
    # a layer: 35 GB at 4, with the 4.1 GB embedding), dense fp KV: top-1 routing
    # over 16 experts of width 8192 and a shared expert, 10 K1 and 10 K2 launches a
    # layer (4 attention, 3 shared, 3 expert-batched).
    print(f"[4m] start at {time.perf_counter() - t_start:.1f}s")
    t_moe = time.perf_counter()
    cfg_m, qparams_m = build("granite-moe-3b-a800m", 30)
    check(cfg_m.n_layers == 32 and cfg_m.d_model == 1536 and cfg_m.n_experts == 40
          and cfg_m.top_k == 8 and cfg_m.d_ff_expert == 512 and cfg_m.head_dim == 64
          and M.block_spec(cfg_m).sublayers == ("attn_moe",), "granite-moe-3b-a800m FULL")
    d_m, f_m = cfg_m.d_model, cfg_m.d_ff_expert
    experts_m = [(d_m, f_m), (d_m, f_m), (f_m, d_m)]          # up, gate, down
    up_m = qparams_m["blocks"][0]["moe"]["up"]
    check(up_m["qw"].shape == (32, 40, d_m, f_m) and up_m["qalpha"].shape == (32, 40)
          and float(up_m["qalpha"].max()) < 1.0, "granite experts: calibrated (L, E) stacks")
    model_m = (cfg_m, linear_shapes(cfg_m)[:4], None, BATCH, MAX_LEN)
    prompts_m = make_prompts(cfg_m.vocab, LENS, len(LENS), seed=30)
    rng_m = np.random.default_rng(31)
    system_m = rng_m.integers(1, cfg_m.vocab, size=SYSTEM_PREFIX).astype(np.int32)
    shared_m = [np.concatenate([system_m, rng_m.integers(1, cfg_m.vocab, size=n)
                                .astype(np.int32)]) for n in SUFFIXES]
    motif_m = [np.tile(rng_m.integers(1, cfg_m.vocab, size=MOTIF).astype(np.int32), n // MOTIF)
               for n in (160, 240, 320, 480)]
    runs_m = [("dense fused-int8 kv=fp", prompts_m[:BATCH], dict(kv_cache="fp")),
              ("dense fused-int8 kv=int8", prompts_m[:BATCH], dict(kv_cache="int8")),
              ("paged fused-int8 kv=int8 shared prefix", shared_m,
               dict(kv_cache="int8", cache_layout="paged")),
              ("paged fused-int8 speculate=4", motif_m,
               dict(kv_cache="fp", cache_layout="paged", speculate=4)),
              ("chunked fused-int8 kv=int8 budget 512", shared_m[:BATCH],
               dict(kv_cache="int8", cache_layout="paged", chunked=True, token_budget=512))]
    for label, reqs, kw in runs_m:
        engine, _ = serve(f"granite-moe {label}", reqs, tree=qparams_m, model=model_m,
                          experts=experts_m, **kw)
        if label == "dense fused-int8 kv=fp":      # where a decode step's time goes
            trace("granite-moe dense fused-int8 kv=fp, decode steps", reqs,
                  lambda e: not e.queue and e.counters["decode_steps"] > 0, tree=qparams_m,
                  model_cfg=cfg_m, kv_cache="fp")
        c = engine.counters
        if engine.paged and engine.radix is not None and "shared" in label:
            check(c["prefix_hits"] > 0, f"granite-moe {label}: no prefix hit")
        print(f"[4m]   granite-moe {label}: prefix_hits={c['prefix_hits']} accept_rate="
              f"{engine.accept_rate():.3f} chunk_steps={c['chunk_steps']}; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del engine
    del qparams_m
    torch.cuda.empty_cache()

    cfg_l, qparams_l = build("llama4-scout-17b-a16e", 17, n_layers=2)
    check(cfg_l.d_model == 5120 and cfg_l.n_experts == 16 and cfg_l.top_k == 1
          and cfg_l.n_shared_experts == 1 and cfg_l.rope_theta == 500000.0
          and "shared" in qparams_l["blocks"][0]["moe"], "llama4-scout FULL width, shared expert")
    d_l, f_l = cfg_l.d_model, cfg_l.d_ff_expert
    serve("llama4-scout (2 layers) dense fused-int8 kv=fp",
          make_prompts(cfg_l.vocab, LENS[:BATCH], BATCH, seed=17), tree=qparams_l,
          model=(cfg_l, linear_shapes(cfg_l), None, BATCH, MAX_LEN),
          experts=[(d_l, f_l), (d_l, f_l), (f_l, d_l)], kv_cache="fp")
    print(f"[4m]   llama4-scout: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del qparams_l
    torch.cuda.empty_cache()
    print(f"[4m] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_moe:.1f}s "
          f"for the MoE models)")

    # [4s] The SSM and hybrid slice: mamba2-130m FULL (24 Mamba2 layers, d_model 768,
    # 24 heads of 64, state 128) and zamba2-1.2b FULL (38 Mamba2 layers, d_model 2048,
    # 64 heads of 64, state 64, and one shared attention + MLP block, 32/32 heads of
    # 64, applied after each of the 6 super-blocks of 6; a 2-layer tail), each
    # initialised from a seeded generator, calibrated (2 batches of 4 x 16 tokens)
    # and quantized to W8A8 static-c CrossQuant, served fused-int8 on the dense
    # layout (fp and int8 KV) and the paged one (fp and int8 KV, prefix_reuse off:
    # one state page per slot from the KV pages' pool), then fake W8A8 CrossQuant
    # (the f32 tree) and dequant-fp on dense fp KV: 4 requests of 16 new tokens each.
    # The schedule per model call: mamba2 48 K1 and 48 K2 launches (in_proj and
    # out_proj of 24 layers; in_proj's N = 3352 on K2's tile body, out_proj on the
    # decode or wgmma body by the step's rows), no attention; zamba2 118 (2 x 38 in
    # the Mamba2 layers, 7 x 6 in the shared block), 6 K3 launches per admission of
    # 128 tokens or more and 6 K4 per paged decode step. On the card both refuse
    # speculate=4, paged prefix reuse and chunked with the reference's types.
    print(f"[4s] start at {time.perf_counter() - t_start:.1f}s")
    t_ssm = time.perf_counter()
    from torch.profiler import record_function

    from repro_torch.models import ssm as ssm_lib
    from repro_torch.serving.config import (
        ChunkedStateError, PrefixReuseStateError, SpeculativeStateError, UnsupportedModelError)

    def build_ssm(name, seed, **cut):
        """(cfg, f32 tree, W8A8 tree) of a FULL config cut by ``cut``: the tree from a
        seeded generator on the card, calibrated with the launcher's traffic and
        quantized to W8A8 static-c CrossQuant. The f32 tree is kept for the fake
        path."""
        c = dataclasses.replace(get(name), **cut)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = M.init_params(g, c, device=dev)
        tables_ = calibrate(params, c, quant, calib_batches=2, seq_len=16, batch_size=BATCH,
                            seed=seed)
        qtree = quantize_tree(params, quant, tables=tables_)
        torch.cuda.synchronize()
        print(f"[4s] {c.name}: {c.n_layers} layers {M.block_spec(c)} d_model={c.d_model} "
              f"d_inner={c.d_inner} ssm heads={c.ssm_heads}x{c.ssm_head_dim} state="
              f"{c.ssm_state} vocab={c.vocab} {c.dtype} params={c.param_count() / 1e9:.3f}B "
              f"(tree {quantized_bytes(params) / 4 / 1e9:.3f}B): init+calibrate+PTQ "
              f"{time.perf_counter() - t0:.1f}s, W8A8 {quantized_bytes(qtree) / 2**30:.3f} GiB")
        return c, params, qtree

    def state_bytes_per_slot(engine):
        """Bytes of one slot's SSM state in the engine's cache: every Mamba2 layer's f32
        state slab and conv window (one page of the state pools, one row of the dense
        leaves)."""
        rows = engine.n_pages if engine.paged else engine.B
        groups = list(engine.caches["blocks"]) + list(engine.caches.get("tail", []))
        return sum(t.numel() * t.element_size() for grp in groups for name, t in grp.items()
                   if name in ("state", "conv", "state_pages", "conv_pages")) / rows

    ssm_fns = ("ssd_decode_step", "_conv_step", "ssd_scan", "_causal_conv", "mamba_apply")

    def ssm_ranges():
        """Open a ``record_function`` range ``ssm::<name>`` around each of the Mamba2
        block's functions (module attributes, looked up at call time); returns the
        originals, to put back with ``setattr``."""
        orig = {n: getattr(ssm_lib, n) for n in ssm_fns}

        def ranged(n, fn):
            def call(*a, **k):
                with record_function(f"ssm::{n}"):
                    return fn(*a, **k)
            return call

        for n, fn in orig.items():
            setattr(ssm_lib, n, ranged(n, fn))
        return orig

    def ssm_model(c):
        """(serve()'s model tuple, layers) for the SSM and hybrid schedules."""
        d, di = c.d_model, c.d_inner
        ssm_lin = [(d, 2 * di + 2 * c.ssm_groups * c.ssm_state + c.ssm_heads), (di, d)]
        if c.family == "ssm":
            return (c, ssm_lin, None, BATCH, MAX_LEN), (c.n_layers, 0)
        n_shared = c.n_layers // c.attn_every
        return (c, ssm_lin * c.n_layers + linear_shapes(c) * n_shared, None, BATCH,
                MAX_LEN), (1, n_shared)

    ssm_e2e = {}
    for name, seed, want_lin in (("mamba2-130m", 50, 48), ("zamba2-1.2b", 51, 118)):
        c, p_fp, p_q = build_ssm(name, seed)
        spec = M.block_spec(c)
        model_s, layers_s = ssm_model(c)
        check(len(model_s[1]) * layers_s[0] == want_lin, f"{name}: {len(model_s[1])} x "
              f"{layers_s[0]} linears per model call, not {want_lin}")
        if name == "mamba2-130m":
            check(c.n_layers == 24 and c.d_model == 768 and c.ssm_heads == 24
                  and c.ssm_state == 128 and model_s[1][0] == (768, 3352), "mamba2-130m FULL")
            check(qgemm_w8a8_plan(4, 768, 3352)[0] == "tile", "mamba2 in_proj routes to the "
                  "tile body")
        else:
            check(c.n_layers == 38 and c.d_model == 2048 and c.n_heads == c.n_kv_heads == 32
                  and spec.n_blocks == 6 and spec.sublayers == ("ssm",) * 6
                  and spec.tail == ("ssm",) * 2 and spec.shared_attn, "zamba2-1.2b FULL")
        prompts_s = make_prompts(c.vocab, LENS[:BATCH], BATCH, seed=seed)
        # the paged pool: every slot's worst case (prompt + 15 tokens in pages of 8)
        # plus its state page; the state pools hold a row per page id
        n_pages = BATCH * (-(-(max(LENS[:BATCH]) + MAX_NEW) // 8) + 1) if spec.shared_attn \
            else 2 * BATCH
        paged = dict(cache_layout="paged", prefix_reuse=False, n_pages=n_pages)
        runs_s = [("dense fused-int8 kv=fp", p_q, quant, "fused-int8", dict(kv_cache="fp")),
                  ("dense fused-int8 kv=int8", p_q, quant, "fused-int8", dict(kv_cache="int8")),
                  ("paged fused-int8 kv=fp", p_q, quant, "fused-int8",
                   dict(kv_cache="fp", **paged)),
                  ("paged fused-int8 kv=int8", p_q, quant, "fused-int8",
                   dict(kv_cache="int8", **paged)),
                  ("dense fake W8A8-CrossQuant kv=fp", p_fp, ql.W8A8_CROSSQUANT, "fake",
                   dict(kv_cache="fp")),
                  ("dense dequant-fp kv=fp", p_q, quant, "dequant-fp", dict(kv_cache="fp"))]
        for label, tree_s, q_s, path_s, kw in runs_s:
            torch.cuda.reset_peak_memory_stats()
            engine, _ = serve(f"{name} {label}", prompts_s, tree=tree_s, q=q_s, path=path_s,
                              model=model_s, layers=layers_s, **kw)
            sb = state_bytes_per_slot(engine)
            H, P_, N_ = c.ssm_heads, c.ssm_head_dim, c.ssm_state
            want_sb = c.n_layers * 4 * (H * P_ * N_ + (c.ssm_conv - 1) * (c.d_inner + 2 * N_))
            check(sb == want_sb, f"{name} {label}: {sb} state bytes per slot, not {want_sb}")
            cc = engine.counters
            if engine.paged:
                check(engine.radix is None and cc["peak_state_pages_in_use"] == BATCH
                      and cc["state_pages_in_use"] == 0 and engine.pool.used_count == 0
                      and ("page_table" in engine.caches) == spec.shared_attn,
                      f"{name} {label}: state pages {cc['peak_state_pages_in_use']} at the "
                      f"peak, {engine.pool.used_count} pages held at the end")
            ssm_e2e[(name, label)] = (e2e[f"{name} {label}"], call_ms[f"{name} {label}"],
                                      torch.cuda.max_memory_allocated(), sb)
            print(f"[4s]   {name} {label}: {e2e[f'{name} {label}']:.1f} tok/s, model call "
                  f"{call_ms[f'{name} {label}']} ms at <= {DECODE_MAX_M} rows (median), state "
                  f"{sb / 2**20:.2f} MiB per slot, peak pages kv/state "
                  f"{cc['peak_kv_pages_in_use']}/{cc['peak_state_pages_in_use']} of "
                  f"{engine.n_pages if engine.paged else 0}, max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del engine
        for kw, err_t in ((dict(speculate=4), SpeculativeStateError),
                          (dict(cache_layout="paged"), PrefixReuseStateError),
                          (dict(cache_layout="paged", prefix_reuse=False, chunked=True,
                                token_budget=512), ChunkedStateError)):
            try:
                ServeEngine(c, p_q, quant=quant, device=dev, config=EngineConfig(
                    batch_size=BATCH, max_len=MAX_LEN, path="fused-int8", **kw))
                raised = None
            except UnsupportedModelError as e:
                raised = e
            check(type(raised) is err_t and isinstance(raised, ValueError),
                  f"{name} {kw}: raised {type(raised).__name__}, not {err_t.__name__}")
        print(f"[4s]   {name}: speculate=4, paged prefix reuse and chunked refused with "
              f"SpeculativeStateError, PrefixReuseStateError and ChunkedStateError")

        # [4t] profiler windows over 3 dense and 3 paged decode steps (launches and
        # syncs per step, busy share, the Mamba2 block's plain ops' device time: its
        # recurrence), then one 4 x 512 admission prefill outside the engine (the SSD
        # scan's ops)
        orig = ssm_ranges()
        try:
            ranges_d = ("ssm::mamba_apply", "ssm::ssd_decode_step", "ssm::_conv_step")
            tr = trace(f"{name} dense fused-int8 kv=fp, decode steps", prompts_s,
                       lambda e: not e.queue and e.counters["decode_steps"] > 0, tree=p_q,
                       model_cfg=c, kv_cache="fp", ranges=ranges_d)
            # the paged route beside it: the state gathered from and scattered back
            # to its page in every layer (the scatter filters sentinel rows)
            trace(f"{name} paged fused-int8 kv=fp, decode steps", prompts_s,
                  lambda e: not e.queue and e.counters["decode_steps"] > 0, tree=p_q,
                  model_cfg=c, kv_cache="fp", ranges=ranges_d, **paged)
            toks_a = torch.as_tensor(np.stack(make_prompts(c.vocab, [512], BATCH, seed=seed + 1)),
                                     dtype=torch.int64, device=dev)
            ctx_a = QuantContext(quant, use_kernels=True, int_exec="kernel")

            def admission():
                caches_a = M.init_cache(c, BATCH, 512, dtype=torch.float32, device=dev)
                M.apply(p_q, {"tokens": toks_a}, c, ctx=ctx_a, mode="prefill", caches=caches_a,
                        cur_len=torch.full((BATCH,), 512, device=dev))

            with torch.no_grad():
                admission()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    admission()
                    torch.cuda.synchronize()
                    wall_a = (time.perf_counter() - t0) * 1e3
        finally:
            for n, fn in orig.items():
                setattr(ssm_lib, n, fn)
        dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)) / 1e3
        ra = range_device_ms(prof, ("ssm::mamba_apply", "ssm::ssd_scan", "ssm::_causal_conv"))
        fams = {}
        for e in prof.events():
            f = family(e.name) if e.device_type == DeviceType.CUDA else None
            if f is not None:
                fams[f] = fams.get(f, 0.0) + e.time_range.elapsed_us() / 1e3
        ssm_e2e[(name, "trace")] = (tr, ra, wall_a, dev_ms)
        print(f"[4t] {name} one {BATCH} x 512 admission prefill (fused-int8, outside the "
              f"engine): wall {wall_a:.1f} ms, device kernels {dev_ms:.2f} ms (busy "
              f"{dev_ms / wall_a:.3f} of the wall time); under ssm::"
              f"mamba_apply {ra['ssm::mamba_apply'][0]:.3f} ms x{ra['ssm::mamba_apply'][1]:.0f} "
              f"plain-op kernels, of which ssm::ssd_scan {ra['ssm::ssd_scan'][0]:.3f} ms x"
              f"{ra['ssm::ssd_scan'][1]:.0f} and ssm::_causal_conv "
              f"{ra['ssm::_causal_conv'][0]:.3f} ms; "
              + "; ".join(f"{f} {t:.3f} ms" for f, t in sorted(fams.items())))
        del p_fp, p_q
        torch.cuda.empty_cache()
    print(f"[4s] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_ssm:.1f}s "
          f"for the SSM and hybrid models)")

    # ---------------------------------------------------------------- phase 5
    print(f"[5] start at {time.perf_counter() - t_start:.1f}s")
    p5_launches = {name: 0 for name in ops.LAUNCHES}
    p5_bodies = {name: 0 for name in ops.BODY_LAUNCHES}
    ops.reset_launches()                    # phase 4's last run is counted already

    def reset5():
        """Add phase 5's launches so far to its totals, then zero the counts."""
        for total, counts in ((p5_launches, ops.LAUNCHES), (p5_bodies, ops.BODY_LAUNCHES)):
            for name in total:
                total[name] += counts[name]
        ops.reset_launches()

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    p2f = M.init_params(g, cfg2, device=dev)
    tables2 = calibrate(p2f, cfg2, quant, calib_batches=2, seq_len=16, batch_size=BATCH, seed=1)
    p2 = quantize_tree(p2f, quant, tables=tables2)
    p2w4 = quantize_tree(p2f, quant4, tables=tables2)
    p2_cpu = M.map_tensors(p2, lambda t: t.cpu())
    rng = np.random.default_rng(2)
    lens = np.array([150, 131], np.int32)                    # bucket 256: flash path
    toks = np.zeros((2, 256), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(1, cfg2.vocab, size=n)
    ctx = QuantContext(quant, use_kernels=True, int_exec="kernel")

    # paged parity runs through a permuted page table (64 pages of 8 per slot)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(6)).to(torch.int32)

    # the chunked, block-sparse and W4A8 runs prefill two shorter prompts (bucket
    # 64) and decode 4 steps: a full-width run's CPU side costs about 10 s per
    # 512-row prefill
    toks_s = np.zeros((2, 64), np.int64)
    lens_s = np.array([40, 27], np.int32)
    for b, n in enumerate(lens_s):
        toks_s[b, :n] = toks[b, :n]
    steps5 = 4

    def greedy(params, device, forced=None, layout="dense", steps=8, short=False, c=cfg2,
               ctx=ctx, kv_int8=False, tl=None, extra=None):
        """Prefill + ``steps`` decode steps of config ``c`` under ``ctx``, feeding its
        own argmax (or ``forced`` tokens); ``short``: the two shorter prompts; ``tl``:
        other (tokens, lens), ``extra``: more prefill inputs (patch embeddings). The
        fp KV pool is f32 at either activation dtype, as the engine gives the tree's
        first float leaf."""
        tk, ln = tl if tl is not None else ((toks_s, lens_s) if short else (toks, lens))
        B = tk.shape[0]
        caches = M.init_cache(c, B, 512, dtype=torch.float32, layout=layout, page_size=8,
                              kv_int8=kv_int8, device=device)
        if "page_table" in caches:
            caches["page_table"] = perm.reshape(2, 64)[:B].to(device)
        if "state_table" in caches:                 # SSM state: one page per row
            caches["state_table"] = perm[-B:].to(device)
        batch = {"tokens": torch.as_tensor(tk, device=device),
                 **{k: v.to(device) for k, v in (extra or {}).items()}}
        logits, _ = M.apply(params, batch, c, ctx=ctx, mode="prefill", caches=caches,
                            cur_len=torch.as_tensor(ln, device=device))
        out_logits, out_toks = [logits[:, -1].float().cpu()], []
        for i in range(steps):
            tok = (torch.argmax(logits[:, -1], dim=-1) if forced is None
                   else forced[i].to(device))
            out_toks.append(tok.cpu())
            logits, _ = M.apply(params, {"tokens": tok[:, None]}, c, ctx=ctx,
                                mode="decode", caches=caches,
                                cur_len=torch.as_tensor(ln + i + 1, device=device))
            out_logits.append(logits[:, -1].float().cpu())
        return torch.stack(out_logits), torch.stack(out_toks)

    cpu = torch.device("cpu")
    with torch.no_grad():
        reset5()
        gl, gt = greedy(p2, dev)
        check(ops.LAUNCHES["flash_attention"] == cfg2.n_layers
              == ops.BODY_LAUNCHES["flash_attention/f32"], "parity prefill used flash's f32 body")
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
        reset5()
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

    # bf16 activations, the configs' default and the main path's dtype, on the paged
    # layout: the cold admission (bucket 256) runs flash's bf16 body and the decode
    # steps the paged bf16 body. The bar calibrates itself: e = max|bf16 - f32
    # logits| of the card's first decode step (the same tree, fed the f32 card run's
    # tokens). The card's bf16 logits, fed the CPU bf16 run's greedy tokens, lie
    # within e of the CPU's (a factor of 1, as tests/test_torch_bf16.py holds the
    # port's CPU run to the JAX engine's), and the card's greedy choice equals the
    # CPU's at every step where the CPU's top-1/top-2 margin exceeds 2e (at least one
    # must).
    cfg2b = dataclasses.replace(cfg2, dtype="bfloat16")
    with torch.no_grad():
        reset5()
        bfl, _ = greedy(p2, dev, forced=pgt, layout="paged", c=cfg2b)
        bodies_b = {k: v for k, v in ops.BODY_LAUNCHES.items() if k.startswith(("flash", "paged"))}
        check(bodies_b == {"flash_attention/bf16_mma": cfg2.n_layers, "flash_attention/f32": 0,
                           "paged_attention/bf16_mma": 8 * cfg2.n_layers,
                           "paged_attention/f32": 0},
              f"bf16 parity run: attention launches by body {bodies_b}")
        bcl, bct = greedy(p2_cpu, cpu, layout="paged", c=cfg2b)
        bgl, _ = greedy(p2, dev, forced=bct, layout="paged", c=cfg2b)
    e_b = float((bfl[1] - pgl[1]).abs().max())
    berr = float((bgl - bcl).abs().max())
    top2 = torch.topk(bcl, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * e_b
    same = torch.argmax(bgl, dim=-1) == torch.argmax(bcl, dim=-1)
    check(e_b > 0, "bf16 parity: bf16 and f32 logits are equal")
    check(berr <= e_b, f"bf16 card vs CPU logits: max err {berr} > e = {e_b}")
    check(int(sure.sum()) > 0,
          f"bf16 parity: no step with a top-1/top-2 margin above 2e = {2 * e_b}")
    check(bool(same[sure].all()), f"bf16 card vs CPU greedy choice differs at a margin > 2e: "
          f"{torch.argmax(bgl, dim=-1).T} vs {torch.argmax(bcl, dim=-1).T}")
    print(f"[5] bf16 paged card vs CPU (flash and paged bf16 bodies, {bodies_b}): e = max|bf16 - "
          f"f32| on the card's first decode step = {e_b:.3e}; logits max_abs_err={berr:.3e} "
          f"({berr / e_b:.2f} e, bar e); greedy choice equal at "
          f"{int(same[sure].sum())} of the {int(sure.sum())} of {sure.numel()} (step, row) "
          f"pairs whose margin exceeds 2e, at {int(same.sum())} of all {same.numel()}")

    # chunked prefill: the two shorter prompts through packed steps (each prompt in
    # two chunks, the second starting mid-page), then 4 steps of one-token rows, all
    # through mode="chunked" (K6), fp and int8 KV
    def chunked_greedy(params, device, kv_int8, c=cfg2, tk=toks_s, ln=lens_s, cut=(20, 12)):
        """The two prompts ``tk``/``ln`` of config ``c`` through packed steps: the
        first ``cut`` tokens of each, then the rest (starting mid-page), then
        ``steps5`` one-token rows."""
        caches = M.init_cache(c, 2, 512, dtype=torch.float32, kv_int8=kv_int8,
                              layout="paged", page_size=8, device=device)
        caches["page_table"] = perm.reshape(2, 64).to(device)

        def step(rows):                       # rows: (slot, tokens, first position)
            flat, pos, sid = [], [], []
            qs, qln, kvl = [0, 0], [0, 0], [0, 0]
            for slot, tk, start in rows:
                qs[slot], qln[slot], kvl[slot] = len(flat), len(tk), start + len(tk)
                flat += [int(t) for t in tk]
                pos += range(start, start + len(tk))
                sid += [slot] * len(tk)
            t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
            chunk = dict(q_start=t(qs), q_len=t(qln), kv_len=t(kvl), positions=t(pos),
                         slot_ids=t(sid))
            logits, _ = M.apply(params, {"tokens": torch.as_tensor([flat], device=device)},
                                c, ctx=ctx, mode="chunked", caches=caches, chunk=chunk)
            return logits[0, [qs[0] + qln[0] - 1, qs[1] + qln[1] - 1]]

        step([(b, tk[b, :cut[b]], 0) for b in (0, 1)])
        logits = step([(b, tk[b, cut[b]:ln[b]], cut[b]) for b in (0, 1)])
        out_logits, out_toks = [logits.float().cpu()], []
        for i in range(steps5):
            tok = torch.argmax(logits, dim=-1)
            out_toks.append(tok.cpu())
            logits = step([(b, [int(tok[b])], int(ln[b]) + i) for b in (0, 1)])
            out_logits.append(logits.float().cpu())
        return torch.stack(out_logits), torch.stack(out_toks)

    with torch.no_grad():
        _, sgt = greedy(p2, dev, layout="paged", steps=steps5, short=True)   # bucketed
        for kv_int8 in (False, True):
            reset5()
            kgl, kgt = chunked_greedy(p2, dev, kv_int8)
            check(ops.LAUNCHES["ragged_prefill_attention"] == (2 + steps5) * cfg2.n_layers
                  and ops.LAUNCHES["flash_attention"] == 0,
                  f"chunked parity launches {ops.LAUNCHES}")
            kcl, kct = chunked_greedy(p2_cpu, cpu, kv_int8)
            kerr = float((kgl - kcl).abs().max())
            kv = "int8" if kv_int8 else "fp"
            check(torch.equal(kgt, kct), f"chunked kv={kv} card vs CPU tokens differ: "
                  f"{kgt.T} vs {kct.T}")
            check(kerr <= tol, f"chunked kv={kv} card vs CPU logits: max err {kerr} > {tol}")
            if not kv_int8:
                check(torch.equal(kgt, sgt), f"chunked fp KV vs bucketed paged tokens "
                      f"differ: {kgt.T} vs {sgt.T}")
            same = "" if kv_int8 else " and equal to bucketed paged"
            print(f"[5] chunked kv={kv} (2 packed prefill steps, {steps5} one-token steps, all K6) "
                  f"card vs CPU: tokens equal{same}; logits max_abs_err={kerr:.3e}, "
                  f"tol={tol:.3e}")

    # a block-sparse tree (2:4, then every other 64-row k-tile emptied): K7 runs
    # on every linear; and the W4A8-g128 tree from the same calibration: K8
    p2bs = sparsify_tree(p2, SparsityPlan(nm=(2, 4)))
    empty_odd_k_tiles(p2bs)
    p2bs = with_tile_occupancy(p2bs)                 # after the last edit of the codes
    for label, tree, kernel in (("block-sparse", p2bs, "qgemm_w8a8_sparse"),
                                ("W4A8-g128", p2w4, "qgemm_w4a8")):
        with torch.no_grad():
            reset5()
            bgl, bgt = greedy(tree, dev, layout="paged", steps=steps5, short=True)
            n_gemm = 6 * cfg2.n_layers * (1 + steps5)
            check(ops.LAUNCHES[kernel] == n_gemm and ops.LAUNCHES["qgemm_w8a8"] == 0,
                  f"{label} parity launches {ops.LAUNCHES}")
            bcl, bct = greedy(M.map_tensors(tree, lambda t: t.cpu()), cpu, layout="paged",
                              steps=steps5, short=True)
        berr = float((bgl - bcl).abs().max())
        btol = 5e-2 * float(bcl.abs().max())
        check(torch.equal(bgt, bct), f"{label} card vs CPU tokens differ: {bgt.T} vs {bct.T}")
        check(berr <= btol, f"{label} card vs CPU logits: max err {berr} > {btol}")
        print(f"[5] {label} paged card vs CPU ({kernel} x{n_gemm}): tokens equal "
              f"{bgt.T.tolist()}, logits max_abs_err={berr:.3e}, tol 5e-2*max|logit|={btol:.3e}")
    del p2bs, p2w4

    # the paper's paths on the card against the CPU: fake W8A8 CrossQuant (dynamic c)
    # on the f32 tree, dense fp KV, and dequant-fp on the W8A8 tree, paged int8 KV;
    # both plain torch (no act_quantize, GEMM or flash launch; K4 on the paged decode)
    p2f_cpu = M.map_tensors(p2f, lambda t: t.cpu())
    for label, trees, ctx_, layout, kv_int8 in (
            ("fake W8A8-CrossQuant dense fp KV", (p2f, p2f_cpu),
             QuantContext(ql.W8A8_CROSSQUANT), "dense", False),
            ("dequant-fp paged int8 KV", (p2, p2_cpu), QuantContext(quant, int_exec="dequant"),
             "paged", True)):
        with torch.no_grad():
            reset5()
            t0 = time.perf_counter()
            fgl, fgt = greedy(trees[0], dev, layout=layout, steps=steps5, short=True, ctx=ctx_,
                              kv_int8=kv_int8)
            want = {name: 0 for name in ops.LAUNCHES}
            if layout == "paged":
                want["paged_decode_attention"] = steps5 * cfg2.n_layers
            check(dict(ops.LAUNCHES) == want, f"{label} parity launches {ops.LAUNCHES}")
            t_card = time.perf_counter() - t0
            fcl, fct = greedy(trees[1], cpu, layout=layout, steps=steps5, short=True, ctx=ctx_,
                              kv_int8=kv_int8)
        ferr = float((fgl - fcl).abs().max())
        ftol = 5e-2 * float(fcl.abs().max())
        check(torch.equal(fgt, fct), f"{label} card vs CPU tokens differ: {fgt.T} vs {fct.T}")
        check(ferr <= ftol, f"{label} card vs CPU logits: max err {ferr} > {ftol}")
        print(f"[5] {label} card vs CPU: tokens equal {fgt.T.tolist()}, logits max_abs_err="
              f"{ferr:.3e}, tol 5e-2*max|logit|={ftol:.3e}; card {t_card:.1f}s")

    # the grouped scheduler through the engine, card vs CPU: two 40-token prompts
    # form one group, a 27-token one the next
    gp = [toks[0, :40].astype(np.int32), toks[1, :40].astype(np.int32),
          toks[0, 40:67].astype(np.int32)]
    gouts = []
    for device, tree in ((dev, p2), (cpu, p2_cpu)):
        geng = ServeEngine(cfg2, tree, quant=quant, device=device,
                           config=EngineConfig(batch_size=2, max_len=64, path="fused-int8",
                                               scheduler="grouped"))
        geng.submit([p.copy() for p in gp], max_new=steps5)
        gouts.append(([r.out for r in geng.run()], geng.counters["prefill_calls"]))
    check(gouts[0] == gouts[1] and gouts[0][1] == 2,
          f"grouped card vs CPU: {gouts[0]} vs {gouts[1]}")
    print(f"[5] grouped scheduler (2 groups) card vs CPU: tokens equal {gouts[0][0]}")

    # make_sparsity_plan: the card's per-linear §4.1 fractions against the CPU's over
    # the same activations (the card's observer pass replayed into the CPU's plan);
    # the CPU's own forward pass is printed beside, not gated: its fake-quant codes
    # move with the CPU's float sums, and each move shifts kernel elements
    calib2 = calibration_batches(cfg2, calib_batches=2, seq_len=16, batch_size=BATCH, seed=1,
                                 device=dev)
    reset5()
    plan_card, recs2 = recorded_plan(make_sparsity_plan, KA, cfg2, p2f, calib2, threshold=0.05)
    apply = M.apply
    replay = iter([x2.cpu() for x2, _, _ in recs2])

    def replayed(params, batch, c, *, ctx, **kw):
        for b in range(c.n_layers):
            for kind in KINDS:
                ctx.observer.observe(f"/L{b}/S0/{kind}", next(replay))
        return None, {}

    M.apply = replayed
    try:
        plan_cpu = make_sparsity_plan(cfg2, p2f_cpu, [{}, {}], threshold=0.05)
    finally:
        M.apply = apply
    plan_own = make_sparsity_plan(cfg2, p2f_cpu, [{"tokens": b["tokens"].cpu()} for b in calib2],
                                  threshold=0.05)
    perr = max(abs(plan_cpu.fractions[k] - f) for k, f in plan_card.fractions.items())
    oerr = max(abs(plan_own.fractions[k] - f) for k, f in plan_card.fractions.items())
    check(set(plan_cpu.fractions) == set(plan_card.fractions) and perr <= 1e-6
          and plan_cpu.layers == plan_card.layers,
          f"plan card vs CPU: fractions differ by {perr}, layers {plan_card.layers} vs "
          f"{plan_cpu.layers}")
    print(f"[5] make_sparsity_plan card vs CPU on the same activations: {len(recs2)} inputs, "
          f"fractions max diff {perr:.3e} (bar 1e-6), layers equal {list(plan_card.layers)}; "
          f"the CPU's own forward pass: max diff {oerr:.3e}, layers {list(plan_own.layers)}")
    del recs2, p2f, p2f_cpu

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
    chunk_out, ceng = engine_tokens(shared, cache_layout="paged", chunked=True, token_budget=64)
    check(ceng.counters["chunk_prefill_rows"] > 0 and chunk_out == dense_out,
          f"engine chunked vs bucketed tokens differ: {chunk_out} vs {dense_out}")
    print(f"[5] 2-layer engine on the card: paged == dense over {len(shared)} shared-prefix "
          f"requests (prefix_hits={peng.counters['prefix_hits']} cow_copies="
          f"{peng.counters['cow_copies']}); speculate=4 == speculate=1 over {len(motifs)} "
          f"motif prompts (accept_rate={seng.accept_rate():.3f} tokens_per_step="
          f"{seng.tokens_per_step():.3f}); chunked (budget 64, fp KV) == bucketed "
          f"(chunk_steps={ceng.counters['chunk_steps']})")

    # The rest of the dense zoo at full width, cut to 2 layers (deepseek-coder-33b,
    # pixtral-12b and hubert-xlarge to 1), float32, card against
    # CPU under the bars above: equal greedy tokens, logits within 5e-2 of max|logit|.
    # gemma2-9b (one local and one global sublayer; window cut to 48 so that short
    # prompts bind it): dense, paged through a permuted table (== dense), chunked fp
    # and int8 KV (fp == bucketed), speculate=4 == 1 on the card, and the paged run in
    # bf16 under the self-calibrated bar; deepseek-coder-33b (untied head prepared on
    # the fly): a prefill and 8 decode steps, the CPU fed the card's tokens (greedy
    # equal wherever its margin is decidable), and a chunked engine on the card whose
    # packed steps launch all token_budget rows into the head; pixtral-12b: a
    # 320-token prefill whose first 256 positions are seeded bf16 patch embeddings,
    # then 4 decode steps, compared as deepseek's; hubert-xlarge: the encoder's
    # logits (not causal; flash at D = 80)
    del p2, p2_cpu
    torch.cuda.empty_cache()
    print(f"[5z] start at {time.perf_counter() - t_start:.1f}s")
    t_z5 = time.perf_counter()

    def build2(name, seed, frames=0, **cut):
        """(cfg, W8A8 tree on the card, its CPU copy) of a FULL config cut to 2 layers,
        float32 (:func:`build`)."""
        c, qt = build(name, seed, frames, **{"n_layers": 2, "dtype": "float32", **cut})
        return c, qt, M.map_tensors(qt, lambda t: t.cpu())

    def card_vs_cpu(label, card, host):
        (gl_, gt_), (cl_, ct_) = card, host
        err_, tol_ = float((gl_ - cl_).abs().max()), 5e-2 * float(cl_.abs().max())
        check(torch.equal(gt_, ct_), f"{label} card vs CPU tokens differ: {gt_.T} vs {ct_.T}")
        check(err_ <= tol_, f"{label} card vs CPU logits: max err {err_} > {tol_}")
        print(f"[5z] {label} card vs CPU: tokens equal {gt_.T.tolist()}, logits max_abs_err="
              f"{err_:.3e}, tol 5e-2*max|logit|={tol_:.3e}")
        return err_

    def nudged(tree):
        """``tree`` with every embedding weight moved by one ulp, up or down (seeded):
        how far an ulp-level float difference carries through the int8 path."""
        emb = tree["embed"]["w"]
        up = torch.rand(emb.shape, generator=torch.Generator().manual_seed(3)) < 0.5
        return {**tree, "embed": {"w": torch.where(
            up, torch.nextafter(emb, torch.full_like(emb, 1.0)),
            torch.nextafter(emb, torch.full_like(emb, -1.0)))}}

    def card_vs_cpu_forced(label, card, host, nudge=None):
        """The card's free greedy run against the CPU fed the card's tokens: logits
        within 5e-2 of max|logit|, and the CPU's greedy choice equal to the card's
        token wherever the CPU's top-1/top-2 margin exceeds twice the largest gap.
        For the untied heads: each is prepared on the fly from its rows' column max,
        whose c^(1-α) the card's and the CPU's pow round apart by an ulp, so a code
        of the head may move a step and a near tie flip."""
        (gl_, gt_), (cl_, _) = card, host
        err_, tol_ = float((gl_ - cl_).abs().max()), 5e-2 * float(cl_.abs().max())
        top2_ = torch.topk(cl_[:-1], 2, dim=-1).values
        sure_ = (top2_[..., 0] - top2_[..., 1]) > 2 * err_
        same_ = torch.argmax(cl_[:-1], dim=-1) == gt_
        check(err_ <= tol_, f"{label} card vs CPU logits: max err {err_} > {tol_}")
        check(bool(same_[sure_].all()), f"{label}: the CPU's greedy choice differs from the "
              f"card's token at a margin > 2 x {err_}")
        moved = "" if nudge is None else (f" (a one-ulp nudge of the embedding moves the "
                                          f"CPU's {float((nudge - cl_).abs().max()):.3e})")
        print(f"[5z] {label} card vs CPU (the CPU fed the card's tokens {gt_.T.tolist()}): "
              f"logits max_abs_err={err_:.3e}{moved}, tol 5e-2*max|logit|={tol_:.3e}; greedy "
              f"equal at "
              f"{int(same_[sure_].sum())} of the {int(sure_.sum())} of {sure_.numel()} (step, "
              f"row) pairs whose margin exceeds 2 x err, at {int(same_.sum())} of all")
        return err_

    def prompts_for(c, lens_, width, seed):
        rng_ = np.random.default_rng(seed)
        tk_ = np.zeros((len(lens_), width), np.int64)
        for b, n in enumerate(lens_):
            tk_[b, :n] = rng_.integers(1, c.vocab, size=n)
        return tk_, np.asarray(lens_, np.int32)

    # gemma2-9b
    cfg_g2, p2g, p2g_cpu = build2("gemma2-9b", 21, window=48)
    check(M.block_spec(cfg_g2).sublayers == ("attn_local", "attn"), "gemma2: local + global")
    tl_g = prompts_for(cfg_g2, [100, 70], 128, 21)          # bucket 128: flash at admission
    with torch.no_grad():
        reset5()
        ggl, ggt = greedy(p2g, dev, c=cfg_g2, tl=tl_g)
        check(ops.BODY_LAUNCHES["flash_attention/f32"] == 2, "gemma2 parity prefill: flash f32")
        ggc = greedy(p2g_cpu, cpu, c=cfg_g2, tl=tl_g)
        card_vs_cpu("gemma2-9b 2-layer (window 48) dense, 1 prefill (bucket 128) + 8 decode "
                    "steps", (ggl, ggt), ggc)
        reset5()
        gpl, gpt = greedy(p2g, dev, c=cfg_g2, tl=tl_g, layout="paged")
        check(ops.LAUNCHES["paged_decode_attention"] == 8 * cfg_g2.n_layers,
              f"gemma2 paged parity decode launches {ops.LAUNCHES['paged_decode_attention']}")
        card_vs_cpu("gemma2-9b paged (permuted table)", (gpl, gpt),
                    greedy(p2g_cpu, cpu, c=cfg_g2, tl=tl_g, layout="paged"))
        check(torch.equal(gpt, ggt), f"gemma2 paged vs dense tokens differ: {gpt.T} vs {ggt.T}")
        for kv_int8 in (False, True):
            reset5()
            kw_c = dict(c=cfg_g2, tk=tl_g[0], ln=tl_g[1], cut=(60, 36))
            kgl, kgt = chunked_greedy(p2g, dev, kv_int8, **kw_c)
            check(ops.LAUNCHES["ragged_prefill_attention"] == (2 + steps5) * cfg_g2.n_layers
                  and ops.LAUNCHES["flash_attention"] == 0,
                  f"gemma2 chunked parity launches {ops.LAUNCHES}")
            kv = "int8" if kv_int8 else "fp"
            card_vs_cpu(f"gemma2-9b chunked kv={kv} (2 packed prefill steps, {steps5} one-token "
                        f"steps)", (kgl, kgt), chunked_greedy(p2g_cpu, cpu, kv_int8, **kw_c))
            if not kv_int8:
                check(torch.equal(kgt, gpt[:steps5]), f"gemma2 chunked fp KV vs bucketed paged "
                      f"tokens differ: {kgt.T} vs {gpt[:steps5].T}")
        # bf16 activations on the paged layout: flash's and the paged bf16 bodies at D =
        # 256 with the window and both softcaps, under the bar of the starcoder2 run
        cfg_g2b = dataclasses.replace(cfg_g2, dtype="bfloat16")
        reset5()
        bfl, _ = greedy(p2g, dev, forced=gpt, layout="paged", c=cfg_g2b, tl=tl_g)
        check(ops.BODY_LAUNCHES["flash_attention/bf16_mma"] == cfg_g2.n_layers
              and ops.BODY_LAUNCHES["paged_attention/bf16_mma"] == 8 * cfg_g2.n_layers,
              f"gemma2 bf16 parity: attention launches by body {ops.BODY_LAUNCHES}")
        bcl, bct = greedy(p2g_cpu, cpu, layout="paged", c=cfg_g2b, tl=tl_g)
        bgl, _ = greedy(p2g, dev, forced=bct, layout="paged", c=cfg_g2b, tl=tl_g)
    e_g = float((bfl[1] - gpl[1]).abs().max())
    berr = float((bgl - bcl).abs().max())
    top2 = torch.topk(bcl, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * e_g
    same = torch.argmax(bgl, dim=-1) == torch.argmax(bcl, dim=-1)
    check(e_g > 0 and berr <= e_g, f"gemma2 bf16 card vs CPU logits: max err {berr} > e {e_g}")
    check(int(sure.sum()) > 0 and bool(same[sure].all()),
          f"gemma2 bf16 card vs CPU greedy choice at a margin > 2e: {int(sure.sum())} sure, "
          f"{int(same[sure].sum())} equal")
    print(f"[5z] gemma2-9b bf16 paged card vs CPU: e = {e_g:.3e}; logits max_abs_err={berr:.3e} "
          f"({berr / e_g:.2f} e, bar e); greedy equal at {int(same[sure].sum())} of the "
          f"{int(sure.sum())} of {sure.numel()} (step, row) pairs whose margin exceeds 2e")
    # speculate=4 == 1 on the card, over motif prompts that bind the window
    rng = np.random.default_rng(22)
    motifs_g = [np.tile(rng.integers(1, cfg_g2.vocab, size=MOTIF).astype(np.int32),
                        -(-n // MOTIF))[:n] for n in (70, 90)]
    outs_g = []
    for spec in (1, 4):
        eng = ServeEngine(cfg_g2, p2g, quant=quant, device=dev,
                          config=EngineConfig(batch_size=2, max_len=256, path="fused-int8",
                                              cache_layout="paged", speculate=spec))
        eng.submit([m.copy() for m in motifs_g], max_new=8)
        outs_g.append([r.out for r in eng.run()])
    check(outs_g[0] == outs_g[1] and eng.counters["spec_steps"] > 0,
          f"gemma2 speculate=4 vs 1 tokens differ: {outs_g[1]} vs {outs_g[0]}")
    print(f"[5z] gemma2-9b speculate=4 == speculate=1 on the card (accept_rate="
          f"{eng.accept_rate():.3f})")
    del p2g, p2g_cpu, eng
    torch.cuda.empty_cache()

    # deepseek-coder-33b: the untied head (K = 7168, N = 32256) prepared on the fly
    cfg_d2, p2d, p2d_cpu = build2("deepseek-coder-33b", 33, n_layers=1)
    check(not cfg_d2.tie_embeddings and "lm_head" in p2d, "deepseek: untied head")
    tl_d = prompts_for(cfg_d2, [40, 27], 64, 33)
    n_lin = len(linear_shapes(cfg_d2)) * cfg_d2.n_layers + 1
    with torch.no_grad():
        reset5()
        dgl, dgt = greedy(p2d, dev, c=cfg_d2, tl=tl_d)
        check(ops.LAUNCHES["qgemm_w8a8"] == 9 * n_lin, f"deepseek parity GEMM launches "
              f"{ops.LAUNCHES['qgemm_w8a8']} != 9 x {n_lin} (head included)")
        card_vs_cpu_forced(f"deepseek-coder-33b {cfg_d2.n_layers}-layer fused-int8, 1 prefill + 8 "
                           "decode steps",
                           (dgl, dgt), greedy(p2d_cpu, cpu, forced=dgt, c=cfg_d2, tl=tl_d),
                           greedy(nudged(p2d_cpu), cpu, forced=dgt, c=cfg_d2, tl=tl_d)[0])
    # a chunked engine on the card (budget 32, int8 KV: every step packed): the head,
    # prepared on the fly, sees all token_budget rows of every packed step
    heads = []
    col_absmax = ql._col_absmax

    def head_rows(x):
        heads.append(x.shape[:-1].numel())
        return col_absmax(x)

    ql._col_absmax = head_rows
    try:
        eng = ServeEngine(cfg_d2, p2d, quant=quant, device=dev,
                          config=EngineConfig(batch_size=2, max_len=64, path="fused-int8",
                                              cache_layout="paged", kv_cache="int8",
                                              chunked=True, token_budget=32))
        eng.submit([tl_d[0][0, :30].astype(np.int32), tl_d[0][1, :20].astype(np.int32)],
                   max_new=4)
        outs_d = [r.out for r in eng.run()]
    finally:
        ql._col_absmax = col_absmax
    n_steps = eng.counters["chunk_steps"]
    check(all(len(o) == 4 and all(0 <= t < cfg_d2.vocab for t in o) for o in outs_d),
          f"deepseek chunked: {outs_d}")
    check(eng._rows_coupled and len(heads) == n_steps and set(heads) == {32},
          f"deepseek chunked: the head saw {heads} rows over {n_steps} packed steps, not "
          f"token_budget (32) each")
    print(f"[5z] deepseek-coder-33b chunked (budget 32, int8 KV) on the card: tokens "
          f"{outs_d}; the head, prepared on the fly, saw all 32 rows in each of the "
          f"{n_steps} packed steps (rows coupled)")
    del p2d, p2d_cpu, eng
    torch.cuda.empty_cache()

    # pixtral-12b: patch embeddings replace the first 256 of 320 positions at prefill
    cfg_p2, p2p, p2p_cpu = build2("pixtral-12b", 12, n_layers=1)
    check(cfg_p2.n_patches == 256 and cfg_p2.frontend_dim == 1024 and "frontend" in p2p,
          "pixtral-12b vision stub")
    tl_p = prompts_for(cfg_p2, [320], 320, 12)
    pe = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, cfg_p2.n_patches, cfg_p2.frontend_dim)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        reset5()
        xgl = greedy(p2p, dev, c=cfg_p2, tl=tl_p, extra={"patch_embeds": pe}, steps=4)
        check(ops.BODY_LAUNCHES["flash_attention/f32"] == cfg_p2.n_layers,
              "pixtral parity prefill: flash f32")
        card_vs_cpu_forced(f"pixtral-12b {cfg_p2.n_layers}-layer fused-int8, a 320-token prefill "
                           "with 256 bf16 patch embeddings + 4 decode steps", xgl,
                           greedy(p2p_cpu, cpu, forced=xgl[1], c=cfg_p2, tl=tl_p,
                                  extra={"patch_embeds": pe}, steps=4))
    del p2p, p2p_cpu
    torch.cuda.empty_cache()

    # hubert-xlarge: the encoder's logits over 2 x 128 seeded frames (flash f32 body at D
    # = 80, not causal); argmax equal wherever the CPU's top-1/top-2 margin exceeds
    # twice the largest gap
    cfg_h2, p2h, p2h_cpu = build2("hubert-xlarge", 80, frames=128, n_layers=1)
    fr = torch.from_numpy(np.random.default_rng(81).standard_normal(
        (2, 128, cfg_h2.frontend_dim)).astype(np.float32))
    with torch.no_grad():
        reset5()
        hgl = M.apply(p2h, {"frames": fr.to(dev)}, cfg_h2, ctx=ctx)[0].cpu()
        check(ops.BODY_LAUNCHES["flash_attention/f32"] == cfg_h2.n_layers,
              "hubert parity: flash f32 at D = 80")
        hcl = M.apply(p2h_cpu, {"frames": fr}, cfg_h2, ctx=ctx)[0]
    hl, hc = hgl[..., :cfg_h2.vocab], hcl[..., :cfg_h2.vocab]
    herr, htol = float((hl - hc).abs().max()), 5e-2 * float(hc.abs().max())
    top2 = torch.topk(hc, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * herr
    same = torch.argmax(hl, dim=-1) == torch.argmax(hc, dim=-1)
    check(herr <= htol, f"hubert card vs CPU logits: max err {herr} > {htol}")
    check(bool(same[sure].all()), f"hubert card vs CPU argmax at a margin > 2 x {herr}")
    print(f"[5z] hubert-xlarge {cfg_h2.n_layers}-layer encoder logits (2 x 128 frames) card vs "
          f"CPU: max_abs_err="
          f"{herr:.3e}, tol 5e-2*max|logit|={htol:.3e}; argmax equal at {int(same[sure].sum())} "
          f"of the {int(sure.sum())} of {sure.numel()} positions whose margin exceeds 2 x err "
          f"(at {int(same.sum())} of all)")
    del p2h, p2h_cpu
    torch.cuda.empty_cache()
    print(f"[5z] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_z5:.1f}s "
          f"for the zoo)")

    # [5m] The MoE slice at 2 layers (granite-moe) and 1 layer (llama4-scout), full
    # width, float32. The router's top-k is a step function of its input: an int8
    # code that moves by one where a value sits within an ulp of a rounding boundary
    # (the card's and the CPU's float sums part there, as in the dense runs) moves a
    # router input by ~1e-2, enough to swap a token's k-th and (k+1)-th expert. So
    # card against CPU is held three ways: (1) the routing itself, on the same
    # inputs: every router input the card's run met, routed on the CPU, gives the
    # card's experts, slots and drops exactly (gates within 1e-6); (2) the kernels
    # end to end on one machine: the card's kernel path against the card's plain
    # path (plain torch linears, no flash), equal greedy tokens and logits within
    # 5e-2 of max|logit|; (3) the CPU fed the card's tokens: logits within the
    # larger of 5e-2·max|logit| and twice what a one-ulp nudge of the embedding
    # moves the CPU's own, and equal greedy choices wherever the CPU's top-1/top-2
    # margin exceeds twice the gap. Logits compare over the real vocabulary (the
    # padded ids carry -1e9). granite: dense prefill of two prompts in bucket 256
    # (each expert's buffer C = 128 rows) + 8 decode steps; paged ≡ dense on the
    # card; capacity_factor 0.25, whose admission prefill drops (token, k) pairs
    # (keep is false somewhere). llama4: top-1, the shared expert, 16 experts of
    # width 8192, the two shorter prompts and 4 decode steps.
    print(f"[5m] start at {time.perf_counter() - t_start:.1f}s")
    t_m5 = time.perf_counter()
    ref_ctx = QuantContext(quant, int_exec="ref")
    route = moe_lib._route_group

    def moe_vs_cpu(label, c, tree, tree_cpu, tl, steps):
        seen = []

        def recording(xf, w, c_):
            out = route(xf, w, c_)
            seen.append((xf, w, out))
            return out

        moe_lib._route_group = recording
        try:
            gl_, gt_ = greedy(tree, dev, c=c, tl=tl, steps=steps)
        finally:
            moe_lib._route_group = route
        n_drop = sum(int((~o[3]).sum()) for _, _, o in seen)
        for xf, w, out in seen:                         # (1) routing on the same input
            host = route(xf.cpu(), w.cpu(), c)
            check(all(torch.equal(a_.cpu(), b_) for a_, b_ in zip(out[1:4], host[1:4]))
                  and float((out[0].cpu() - host[0]).abs().max()) <= 1e-6,
                  f"{label}: the card's routing of {tuple(xf.shape)} rows differs from the CPU's")
        pgl_, pgt_ = greedy(tree, dev, c=c, tl=tl, steps=steps, ctx=ref_ctx)   # (2)
        V = c.vocab
        kerr = float((gl_[..., :V] - pgl_[..., :V]).abs().max())
        ktol = 5e-2 * float(pgl_[..., :V].abs().max())
        check(torch.equal(gt_, pgt_) and kerr <= ktol, f"{label}: card kernels vs card plain "
              f"path: tokens {gt_.T} vs {pgt_.T}, logits err {kerr} (tol {ktol})")
        cl_, _ = greedy(tree_cpu, cpu, forced=gt_, c=c, tl=tl, steps=steps)  # (3)
        ul_, _ = greedy(nudged(tree_cpu), cpu, forced=gt_, c=c, tl=tl, steps=steps)
        gl_, cl_, ul_ = gl_[..., :V], cl_[..., :V], ul_[..., :V]
        err_, nerr = float((gl_ - cl_).abs().max()), float((ul_ - cl_).abs().max())
        tol_ = max(5e-2 * float(cl_.abs().max()), 2 * nerr)
        top2_ = torch.topk(cl_[:-1], 2, dim=-1).values
        sure_ = (top2_[..., 0] - top2_[..., 1]) > 2 * err_
        same_ = torch.argmax(cl_[:-1], dim=-1) == gt_
        check(err_ <= tol_, f"{label} card vs CPU logits: max err {err_} > {tol_}")
        check(bool(same_[sure_].all()), f"{label}: the CPU's greedy choice differs from the "
              f"card's token at a margin > 2 x {err_}")
        print(f"[5m] {label}: {len(seen)} routings ({sum(x.shape[0] for x, _, _ in seen)} token "
              f"rows, {n_drop} (token, k) pairs dropped) equal to the CPU's on the same inputs; "
              f"card kernels == card plain path in tokens {gt_.T.tolist()}, logits max_abs_err="
              f"{kerr:.3e}; CPU fed the card's tokens: logits max_abs_err={err_:.3e} (a one-ulp "
              f"nudge of the embedding moves the CPU's {nerr:.3e}; tol {tol_:.3e}), greedy equal "
              f"at {int(same_[sure_].sum())} of the {int(sure_.sum())} of {sure_.numel()} (step, "
              f"row) pairs whose margin exceeds 2 x err, at {int(same_.sum())} of all")
        return gt_, n_drop

    cfg_m2, p2m, p2m_cpu = build2("granite-moe-3b-a800m", 40, n_layers=1)
    tl_m = prompts_for(cfg_m2, [150, 131], 256, 40)
    with torch.no_grad():
        reset5()
        mgl, mgt = greedy(p2m, dev, c=cfg_m2, tl=tl_m)
        n_lin = 7 * cfg_m2.n_layers * 9
        check(ops.LAUNCHES["act_quantize"] == n_lin == ops.LAUNCHES["qgemm_w8a8"]
              and ops.BODY_LAUNCHES["qgemm_w8a8/experts_wgmma"] == 3 * cfg_m2.n_layers
              and ops.BODY_LAUNCHES["qgemm_w8a8/experts_decode"] == 3 * cfg_m2.n_layers * 8,
              f"granite parity launches {ops.LAUNCHES} {ops.BODY_LAUNCHES}")
        moe_vs_cpu("granite-moe 2-layer dense, 1 prefill (bucket 256, C = 128) + 8 decode "
                   "steps", cfg_m2, p2m, p2m_cpu, tl_m, 8)
        reset5()
        _, mpt = greedy(p2m, dev, c=cfg_m2, tl=tl_m, layout="paged")
        check(torch.equal(mpt, mgt), f"granite paged vs dense tokens differ: {mpt.T} vs {mgt.T}")
        cfg_mo = dataclasses.replace(cfg_m2, capacity_factor=0.25)
        reset5()
        _, n_drop = moe_vs_cpu(f"granite-moe capacity_factor 0.25 (C = "
                               f"{moe_capacity(512, cfg_mo)} at the admission), {steps5} "
                               f"decode steps", cfg_mo, p2m, p2m_cpu, tl_m, steps5)
        check(n_drop > 0, "granite capacity_factor 0.25: no (token, k) pair dropped")
    del p2m, p2m_cpu
    torch.cuda.empty_cache()
    cfg_l1, p1l, p1l_cpu = build2("llama4-scout-17b-a16e", 41, n_layers=1)
    tl_l = prompts_for(cfg_l1, [40, 27], 64, 41)
    with torch.no_grad():
        reset5()
        greedy(p1l, dev, c=cfg_l1, tl=tl_l, steps=steps5)
        check(ops.LAUNCHES["act_quantize"] == 10 * (1 + steps5) == ops.LAUNCHES["qgemm_w8a8"],
              f"llama4 parity launches {ops.LAUNCHES}")
        moe_vs_cpu(f"llama4-scout 1-layer dense (top-1, shared expert), 1 prefill (bucket 64) "
                   f"+ {steps5} decode steps", cfg_l1, p1l, p1l_cpu, tl_l, steps5)
    del p1l, p1l_cpu
    torch.cuda.empty_cache()
    print(f"[5m] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_m5:.1f}s "
          f"for the MoE models)")

    # [5s] The SSM and hybrid models card against CPU in float32, full width: mamba2
    # at 2 of its 24 layers and zamba2 at 8 of its 38 (one super-block of 6 Mamba2
    # layers, the shared attention + MLP block, and a 2-layer tail; at 2 layers it
    # would have neither, attn_every staying 6). One admission prefill of two
    # prompts (bucket 256: zamba2's shared attention takes flash's f32 body) and 8
    # greedy decode steps, on the card's kernels and on the CPU's plain versions.
    # The bar: free-running greedy tokens equal and logits within 5e-2 of max|logit|
    # over the real vocabulary. Where a near tie breaks the tokens, [5m]'s three-way
    # bar holds instead: the card's kernels give its plain path's greedy tokens
    # (logits within 5e-2), and the CPU fed the card's tokens stays within twice
    # what a one-ulp nudge of the embedding moves it, with equal greedy choices
    # wherever the CPU's top-1/top-2 margin exceeds twice the gap. Then the paged
    # layout on the card (the state through a state_table, zamba2's KV through the
    # page table, its decode on K4) fed the dense run's tokens: logits within 5e-2
    # of the dense run's and greedy choices equal where its margin exceeds twice
    # the gap.
    print(f"[5s] start at {time.perf_counter() - t_start:.1f}s")
    t_s5 = time.perf_counter()
    for name, seed, n_layers in (("mamba2-130m", 60, 1), ("zamba2-1.2b", 61, 8)):
        c, p_card, p_cpu = build2(name, seed, n_layers=n_layers)
        spec = M.block_spec(c)
        n_attn = spec.n_blocks if spec.shared_attn else 0
        n_lin = 2 * c.n_layers + 7 * n_attn
        check(not spec.shared_attn or (spec.n_blocks, len(spec.tail)) == (1, 2),
              f"{name} at {n_layers} layers: {spec}")
        tl_s = prompts_for(c, [150, 131], 256, seed)
        V = c.vocab
        label = f"{name} {n_layers}-layer dense, 1 prefill (bucket 256) + 8 decode steps"
        with torch.no_grad():
            reset5()
            gl, gt = greedy(p_card, dev, c=c, tl=tl_s)
            tile = ops.BODY_LAUNCHES["qgemm_w8a8/tile"]
            check(ops.LAUNCHES["act_quantize"] == n_lin * 9 == ops.LAUNCHES["qgemm_w8a8"]
                  and tile == (c.n_layers * 9 if c.family == "ssm" else 0)
                  and ops.BODY_LAUNCHES["flash_attention/f32"] == n_attn,
                  f"{label}: launches {ops.LAUNCHES} {ops.BODY_LAUNCHES}")
            cl, ct = greedy(p_cpu, cpu, c=c, tl=tl_s)
            gl, cl = gl[..., :V], cl[..., :V]
            err, tol = float((gl - cl).abs().max()), 5e-2 * float(cl.abs().max())
            if torch.equal(gt, ct):
                check(err <= tol, f"{label} card vs CPU logits: max err {err} > {tol}")
                print(f"[5s] {label} card vs CPU: tokens equal {gt.T.tolist()}, logits "
                      f"max_abs_err={err:.3e}, tol 5e-2*max|logit|={tol:.3e}")
            else:
                reset5()
                pgl_, pgt_ = greedy(p_card, dev, c=c, tl=tl_s, ctx=ref_ctx)
                kerr = float((gl - pgl_[..., :V]).abs().max())
                ktol = 5e-2 * float(pgl_[..., :V].abs().max())
                check(torch.equal(gt, pgt_) and kerr <= ktol, f"{label}: card kernels vs card "
                      f"plain path: tokens {gt.T} vs {pgt_.T}, logits err {kerr} (tol {ktol})")
                fl, _ = greedy(p_cpu, cpu, forced=gt, c=c, tl=tl_s)
                ul, _ = greedy(nudged(p_cpu), cpu, forced=gt, c=c, tl=tl_s)
                fl, ul = fl[..., :V], ul[..., :V]
                ferr, nerr = float((gl - fl).abs().max()), float((ul - fl).abs().max())
                ftol = max(5e-2 * float(fl.abs().max()), 2 * nerr)
                top2 = torch.topk(fl[:-1], 2, dim=-1).values
                sure = (top2[..., 0] - top2[..., 1]) > 2 * ferr
                same = torch.argmax(fl[:-1], dim=-1) == gt
                check(ferr <= ftol and bool(same[sure].all()), f"{label}: the CPU fed the card's "
                      f"tokens: logits err {ferr} (tol {ftol}), greedy differs at a margin > 2 x "
                      f"err: {same}")
                print(f"[5s] {label}: a near tie parted the free-running tokens (card "
                      f"{gt.T.tolist()}, CPU {ct.T.tolist()}); card kernels == card plain path "
                      f"in tokens, logits max_abs_err={kerr:.3e}; CPU fed the card's tokens: "
                      f"logits max_abs_err={ferr:.3e} (a one-ulp nudge moves the CPU's "
                      f"{nerr:.3e}; tol {ftol:.3e}), greedy equal at {int(same[sure].sum())} of "
                      f"the {int(sure.sum())} of {sure.numel()} pairs whose margin exceeds 2 x err")
            reset5()
            pl, _ = greedy(p_card, dev, c=c, tl=tl_s, layout="paged", forced=gt)
            check(ops.LAUNCHES["paged_decode_attention"] == 8 * n_attn,
                  f"{name} paged parity decode launches {ops.LAUNCHES['paged_decode_attention']}")
            pl = pl[..., :V]
            gl_all = gl
            perr = float((pl - gl_all).abs().max())
            ptol = 5e-2 * float(gl_all.abs().max())
            top2 = torch.topk(gl_all[:-1], 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1]) > 2 * perr
            same = torch.argmax(pl[:-1], dim=-1) == gt
            check(perr <= ptol and bool(same[sure].all()), f"{name} paged vs dense on the card: "
                  f"logits err {perr} (tol {ptol}), greedy differs at a margin > 2 x err")
            print(f"[5s] {name} paged (state_table{', page table and K4' if n_attn else ''}) vs "
                  f"dense on the card, fed the dense tokens: logits max_abs_err={perr:.3e}, tol "
                  f"{ptol:.3e}; greedy equal at {int(same.sum())} of {same.numel()} (step, row) "
                  f"pairs, at all {int(sure.sum())} whose margin exceeds 2 x err")
        del p_card, p_cpu
        torch.cuda.empty_cache()
    print(f"[5s] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_s5:.1f}s "
          f"for the SSM and hybrid models)")

    # ---------------------------------------------------------------- phase 6
    # The async replica server (AsyncServer) on phase 4's calibrated starcoder2-7b FULL
    # W8A8 tree (rebuilt from the same seed and calibration): fused-int8, paged, int8 KV, batch 4 per replica, max_len 1024, 16
    # requests in two prefix families (a 256-token shared prefix each, suffixes of
    # 32-192 tokens, 16 new tokens each), affinity routing; with 2 replicas sharing
    # the card (a thread and a CUDA stream each, FIFO turns at engine steps), with
    # 2 free-running (the turns replaced by no-ops: what the turns buy) and with 1.
    # Then replica 0 fails at its step 3 and restarts, and a one-slot server shows
    # both admission bounds.
    reset5()                                # phase 5's launches are banked
    print(f"[6] start at {time.perf_counter() - t_start:.1f}s; {nvidia_smi_line()}")
    t_s6 = time.perf_counter()
    # phase 4 freed its calibrated tree before the zoo: rebuild it the same way
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = M.init_params(g, cfg, device=dev)
    qparams = quantize_tree(params, quant, tables=calibrate(
        params, cfg, quant, calib_batches=2, seq_len=16, batch_size=BATCH, seed=0))
    del params
    torch.cuda.empty_cache()
    print(f"[6] {cfg.name} FULL W8A8 tree rebuilt as in phase 4 (seed 0, 2 calibration "
          f"batches) in {time.perf_counter() - t_s6:.1f}s")
    import asyncio
    import contextlib
    import gc

    from repro_torch.runtime.supervisor import FailureInjector
    from repro_torch.serving.api import AdmissionError, FinishReason, Request
    from repro_torch.serving.server import AsyncServer

    config6 = EngineConfig(batch_size=BATCH, max_len=MAX_LEN, path="fused-int8",
                           kv_cache="int8", cache_layout="paged")
    rng = np.random.default_rng(6)
    families = [rng.integers(1, cfg.vocab, size=SERVER_PREFIX).astype(np.int32)
                for _ in range(2)]
    traffic = [np.concatenate([families[i % 2],
                               rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)])
               for i, n in enumerate(rng.integers(*SERVER_SUFFIX, size=SERVER_REQUESTS))]
    records = []                            # (token rows, mode, flash?) per model call
    apply = M.apply

    def apply_recorded(p, inputs, *rest, **kw):
        out = apply(p, inputs, *rest, **kw)
        tok = inputs["tokens"]
        records.append((tok.numel(), kw.get("mode"), kw.get("mode") == "prefill"
                        and kw.get("prefix_len") is None and tok.shape[1] >= 128))
        return out

    def check_counts(label):
        """The launches of a server run (both replica threads) against the schedule
        its model calls imply: 192 K1 and K2 per call on the bodies their token rows
        give, 32 K3 per cold admission of >= 128 tokens (warm suffixes run the plain
        path), 32 K4 per paged decode step; then add them to the phase-4 totals."""
        counts, bodies = dict(ops.LAUNCHES), dict(ops.BODY_LAUNCHES)
        want = {name: 0 for name in ops.LAUNCHES}
        want_bodies = {name: 0 for name in ops.BODY_LAUNCHES}
        L = cfg.n_layers
        for rows, mode, flash in records:
            for K, N in linears:
                want_bodies[f"act_quantize/{act_quantize_plan(rows, K)[0]}"] += L
                want_bodies[f"qgemm_w8a8/{qgemm_w8a8_plan(rows, K, N)[0]}"] += L
            want["act_quantize"] += len(linears) * L
            want["qgemm_w8a8"] += len(linears) * L
            want["flash_attention"] += L * flash
            want["paged_decode_attention"] += L * (mode == "decode")
        want_bodies["flash_attention/bf16_mma"] = want["flash_attention"]
        want_bodies["paged_attention/bf16_mma"] = want["paged_decode_attention"]
        check(counts == want and bodies == want_bodies,
              f"{label}: launches {counts} / bodies {bodies} != schedule {want} / "
              f"{want_bodies} over {len(records)} model calls")
        check(want["flash_attention"] > 0 and want["paged_decode_attention"] > 0,
              f"{label}: no cold admission >= 128 tokens or no paged decode step")
        for name in launches:
            launches[name] += counts[name]
        for name in body_launches:
            body_launches[name] += bodies[name]
        return counts

    async def until(cond, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, f"[6] timed out waiting for {what}")
            await asyncio.sleep(0.001)

    async def collect(srv, req):
        toks, fin = [], None
        async for ev in srv.submit(req):
            check(ev.kind != "error", f"[6] stream ended in an error frame: {ev.error}")
            if ev.kind == "token":
                toks.append(ev.token)
            else:
                fin = ev
        return toks, fin

    async def place(srv, reqs):
        """Hold every replica and submit ``reqs`` one by one, each once the previous
        one sits in an inbox: each replica then drains its share in submission order,
        as a direct engine fed the same prompts would."""
        srv.pause()
        tasks = []
        for req in reqs:
            n = sum(r.load for r in srv.replicas)
            tasks.append(asyncio.create_task(collect(srv, req)))
            await until(lambda: sum(r.load for r in srv.replicas) == n + 1, "an inbox")
        return tasks

    def direct(prompts, max_new):
        """The port's engine alone on the card, fed ``prompts`` in this order."""
        engine = ServeEngine(cfg, qparams, config=config6, quant=quant, device=dev)
        reqs = engine.submit([np.asarray(p, np.int32) for p in prompts], max_new=max_new)
        engine.run()
        torch.cuda.synchronize()
        return [r.out for r in reqs]

    def cache_bytes(engine):
        leaves = [engine.caches]
        n = 0
        while leaves:
            x = leaves.pop()
            if isinstance(x, dict):
                leaves.extend(x.values())
            elif isinstance(x, (list, tuple)):
                leaves.extend(x)
            elif isinstance(x, torch.Tensor):
                n += x.numel() * x.element_size()
        return n

    class FreeRunning:
        """A device's replicas step at once, each thread grabbing the GIL back at
        every torch op the other releases it in."""

        def turn(self):
            return contextlib.nullcontext()

    def baseline():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    async def served(n_rep, free=False):
        before = baseline()
        async with AsyncServer(cfg, qparams, config=config6, replicas=n_rep, quant=quant,
                               max_queue=SERVER_REQUESTS) as srv:
            if free:
                srv._turns = {d: FreeRunning() for d in srv._turns}
            t0 = time.perf_counter()
            tasks = await place(srv, [Request(prompt=p.tolist(), max_new=MAX_NEW)
                                      for p in traffic])
            hold = time.perf_counter() - t0
            torch.cuda.synchronize()
            ops.reset_launches()
            records.clear()
            M.apply = apply_recorded
            try:
                t0 = time.perf_counter()
                srv.resume()
                res = await asyncio.gather(*tasks)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                M.apply = apply
            counts = check_counts(f"server {n_rep} replica(s){' free-running' if free else ''}")
            return dict(res=res, dt=dt, hold=hold, m=srv.metrics(), counts=counts,
                        before=before, peak=torch.cuda.max_memory_allocated(),
                        cache=cache_bytes(srv.replicas[0].engine),
                        streams=[r.stream for r in srv.replicas])

    runs = {label: asyncio.run(served(n, free=label.endswith("free")))
            for label, n in (("2", 2), ("2 free", 2), ("1", 1))}
    refs = {}
    for label, run in runs.items():
        n = int(label[0])
        res, m = run["res"], run["m"]
        n_tok = sum(len(t) for t, _ in res)
        check(n_tok == SERVER_REQUESTS * MAX_NEW and all(
            f.finish_reason == FinishReason.LENGTH for _, f in res),
              f"server {n}: every request gets {MAX_NEW} tokens")
        check(m["server"]["completed"] == SERVER_REQUESTS and m["server"]["errors"] == 0
              and m["server"]["rejected"] == 0, f"server {n}: counters {m['server']}")
        for rep in range(n):
            idx = [i for i, (_, f) in enumerate(res) if f.metrics.replica == rep]
            if (n, rep) not in refs:
                refs[(n, rep)] = (idx, direct([traffic[i] for i in idx], MAX_NEW))
            check(idx == refs[(n, rep)][0] and [res[i][0] for i in idx] == refs[(n, rep)][1],
                  f"server {label} replica {rep}: streams differ from the engine alone")
        e2e[f"server {label} replica(s)"] = n_tok / run["dt"]
        lat = m["latency"]
        print(f"[6] server replicas={label} (paged int8 KV, affinity): {n_tok} tokens in "
              f"{run['dt']:.2f}s = {n_tok / run['dt']:.1f} tok/s; TTFT p50/p95 "
              f"{lat['ttft_p50_s'] * 1e3:.1f}/{lat['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50/p95 "
              f"{lat['tpot_p50_s'] * 1e3:.1f}/{lat['tpot_p95_s'] * 1e3:.1f} ms (from submission; "
              f"the ordered hold took {run['hold'] * 1e3:.1f} ms); affinity_hits="
              f"{m['server']['affinity_hits']}; prefix_hit_rate per replica "
              f"{[round(r['engine']['prefix_hit_rate'], 4) for r in m['replicas']]}; peak "
              f"memory {run['peak'] / 2**30:.2f} GiB ({(run['peak'] - run['before']) / 2**30:.2f} "
              f"over the {run['before'] / 2**30:.2f} held before the server; one engine's "
              f"caches {run['cache'] / 2**30:.3f} GiB); streams token-exact vs the engine alone "
              f"in the same per-replica order; launches "
              f"{ {k: v for k, v in run['counts'].items() if v} } over {len(records)} calls")
    two = runs["2"]
    check(two["streams"][0] is not None and two["streams"][0] != two["streams"][1],
          "each replica has a CUDA stream of its own")
    check(two["m"]["server"]["affinity_hits"] == SERVER_REQUESTS - 2 and all(
        f.metrics.replica == i % 2 for i, (_, f) in enumerate(two["res"])),
          "affinity: each prefix family stays on its replica")
    check(all(r["engine"]["prefix_hit_rate"] > 0 for r in two["m"]["replicas"]),
          "every replica reuses its family's prefix")
    print(f"[6] aggregate tok/s over 1 replica's: 2 replicas taking turns "
          f"{e2e['server 2 replica(s)'] / e2e['server 1 replica(s)']:.3f}, 2 free-running "
          f"{e2e['server 2 free replica(s)'] / e2e['server 1 replica(s)']:.3f}")

    # failover: replica 0's share of the 2-replica run, every request pinned to
    # replica 0, which fails at its step 3; replica 1 is held until the requeued
    # continuations sit in its inbox, so it admits them together
    idx0, ref0 = refs[(2, 0)]

    async def failover():
        before = baseline()
        inj = {0: FailureInjector(fail_at_steps=(3,))}
        async with AsyncServer(cfg, qparams, config=config6, replicas=2, quant=quant,
                               injectors=inj, max_restarts=2) as srv:
            requeued = []
            handle = srv._handle_replica_failure

            def snapshot(replica, interrupted, err):
                requeued.extend((list(r.req.prompt), list(r.emitted)) for r in interrupted)
                handle(replica, interrupted, err)

            srv._handle_replica_failure = snapshot
            tasks = await place(srv, [Request(prompt=traffic[i].tolist(), max_new=MAX_NEW,
                                              replica_hint=0) for i in idx0])
            torch.cuda.synchronize()
            ops.reset_launches()
            records.clear()
            M.apply = apply_recorded
            try:
                t0 = time.perf_counter()
                srv.replicas[0].pause_flag.clear()
                srv.replicas[0].wake.set()
                await until(lambda: srv.counters["restarts"] == 1, "replica 0's failure")
                await until(lambda: srv.replicas[1].load == len(requeued), "the requeue")
                srv.resume()
                res = await asyncio.gather(*tasks)
                await until(lambda: srv.replicas[0].alive and srv.replicas[0].engine
                            is not None, "replica 0's restart")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                M.apply = apply
            counts = check_counts("server failover")
            peak = torch.cuda.max_memory_allocated()
            after = torch.cuda.memory_allocated()
            _, fin = await collect(srv, Request(prompt=traffic[idx0[0]].tolist(), max_new=4,
                                                replica_hint=0))
            return dict(res=res, requeued=requeued, m=srv.metrics(), dt=dt, counts=counts,
                        peak=peak, after=after, before=before, again=fin.metrics.replica)

    fo = asyncio.run(failover())
    res, requeued, m = fo["res"], fo["requeued"], fo["m"]
    check(len(requeued) == len(idx0) and any(e for _, e in requeued),
          f"failover: {len(requeued)} requests requeued, some mid-decode")
    check(all(len(t) == MAX_NEW and f.metrics.replica == 1 for t, f in res),
          f"failover: every request gets its {MAX_NEW} tokens on the survivor")
    emitted = {tuple(p): e for p, e in requeued}
    for (toks, _), i, head in zip(res, idx0, ref0):
        e = emitted[tuple(traffic[i].tolist())]
        check(toks[:len(e)] == e == head[:len(e)],
              "failover: replica 0's tokens before the failure equal the engine alone's")
    cont = [(p, e) for p, e in requeued if len(e) < MAX_NEW]
    tails = direct([p + e for p, e in cont], [MAX_NEW - len(e) for _, e in cont])
    got = {tuple(traffic[i].tolist()): toks for (toks, _), i in zip(res, idx0)}
    for (p, e), tail in zip(cont, tails):
        check(got[tuple(p)][len(e):] == tail,
              "failover: the survivor's continuation equals the engine alone fed the "
              "continuations in requeue order")
    check(m["server"]["restarts"] == 1 and m["replicas"][0]["state"] == "live"
          and m["replicas"][0]["restarts"] == 1 and fo["again"] == 0,
          f"failover: replica 0 restarted and serves again ({m['replicas'][0]})")
    grew = (fo["peak"] - fo["before"]) - (two["peak"] - two["before"])
    check(grew <= two["cache"],
          f"failover: peak over the held memory grew by {grew} bytes past the 2-replica "
          f"run's, more than one engine's caches ({two['cache']})")
    print(f"[6] failover: replica 0 failed at its step 3 with {len(requeued)} requests "
          f"({sum(len(e) for _, e in requeued)} tokens already streamed); the survivor "
          f"finished them token-exact vs the engine alone fed the continuations in requeue "
          f"order; replica 0 live again and serving; {fo['dt']:.2f}s; peak memory "
          f"{(fo['peak'] - fo['before']) / 2**30:.3f} GiB over the {fo['before'] / 2**30:.2f} "
          f"held, across the failure and restart (2-replica run "
          f"{(two['peak'] - two['before']) / 2**30:.3f}, one engine's caches "
          f"{two['cache'] / 2**30:.3f}); allocated after the restart "
          f"{(fo['after'] - fo['before']) / 2**30:.3f} GiB over the held; launches "
          f"{ {k: v for k, v in fo['counts'].items() if v} }")

    # bounded admission on the card: a one-slot replica whose pool holds 40 pages
    async def admission_bounds():
        small = EngineConfig(batch_size=1, max_len=MAX_LEN, path="fused-int8",
                             kv_cache="int8", cache_layout="paged", n_pages=40)
        big = np.concatenate(traffic[:2])[:400]        # 400 + 15 tokens: 52 pages > 40
        reasons = []
        async with AsyncServer(cfg, qparams, config=small, replicas=1, quant=quant,
                               max_queue=1, admission_timeout=0.05) as srv:
            try:
                await collect(srv, Request(prompt=big.tolist(), max_new=MAX_NEW))
            except AdmissionError as e:
                reasons.append(e.reason)
            held = await place(srv, [Request(prompt=traffic[0][:40].tolist(), max_new=2)])
            try:                            # the one admission slot is held
                await collect(srv, Request(prompt=traffic[1][:40].tolist(), max_new=2))
            except AdmissionError as e:
                reasons.append(e.reason)
            srv.resume()
            toks, _ = (await asyncio.gather(*held))[0]
            return reasons, len(toks), srv.counters["rejected"]

    reasons, n_held, rejected = asyncio.run(admission_bounds())
    check(reasons == ["pool_pressure", "queue_full"] and n_held == 2 and rejected == 2,
          f"admission: reasons {reasons}, held request {n_held} tokens, rejected {rejected}")
    print(f"[6] admission: a 400-token request (52 pages) against a 40-page pool "
          f"rejected as pool_pressure, a second one behind max_queue=1 as queue_full, the "
          f"held one finished")
    ops.reset_launches()                    # the engines alone above count nothing
    print(f"[6] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_s6:.1f}s "
          f"for the server)")

    # ---------------------------------------------------------------- phase 7
    # Training on the card: the port's training half (loss_fn with remat, AdamW,
    # gradient compression, the train step, CheckpointManager, the Supervisor and
    # launch.train). No hand-written kernel runs while training (the reference
    # trains with use_pallas=False, and the kernels refuse inputs that require
    # grad); the trained tree is then checkpointed, restored, calibrated, quantized
    # to W8A8 and served through fused-int8, which runs K1-K4 on trained weights.
    import os
    import tempfile
    import warnings

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_train_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import calibrate_and_quantize
    from repro_torch.training import compression as comp_lib, optimizer as opt_lib, trainer

    del qparams                             # phase 6's tree; phases 4-5 freed theirs
    gc.collect()
    torch.cuda.empty_cache()
    t_s7 = time.perf_counter()
    print(f"[7] start at {time.perf_counter() - t_start:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held; {nvidia_smi_line()}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"[7] TF32: torch.backends.cuda.matmul.allow_tf32={tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (f32 matmuls "
          f"in full f32)")
    check(not tf32, "TF32 is on: the f32 parity step needs full-f32 matmuls")

    def rel_max(a, b):
        """max|a - b| / max|b| (b the reference)."""
        return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30))

    # [7a] card against CPU: one f32 train step of starcoder2-7b at full width cut
    # to 1 layer, B = 1, S = 64, from the same seeded params and batch
    cfg7a = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    opt7 = opt_lib.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    p_card = M.init_params(g, cfg7a, device=dev)
    p_cpu = M.map_tensors(p_card, lambda t: t.to("cpu", copy=True))
    toks7 = make_train_batches(cfg.vocab, 64, 1, seed=7)(0)["tokens"]
    step7a = trainer.make_train_step(cfg7a, opt7)
    t0 = time.perf_counter()
    _, o_card, m_card = step7a(p_card, opt_lib.init(p_card),
                               {"tokens": torch.as_tensor(toks7, device=dev)})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, o_cpu, m_cpu = step7a(p_cpu, opt_lib.init(p_cpu), {"tokens": torch.as_tensor(toks7)})
    t_cpu = time.perf_counter() - t0
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    gn_rel = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) / float(m_cpu["grad_norm"])
    m_errs = [rel_max(a.cpu(), b) for a, b in zip(M.leaves(o_card.m), M.leaves(o_cpu.m))]
    print(f"[7a] {cfg7a.name} full width, 1 layer, f32, B=1 S=64: card step {t_card:.2f}s, CPU "
          f"{t_cpu:.2f}s; loss card {float(m_card['loss']):.7f} CPU {float(m_cpu['loss']):.7f} "
          f"(rel {loss_rel:.2e}); grad norm rel {gn_rel:.2e}; first moment max|d|/max per leaf: "
          f"max {max(m_errs):.2e}, median {float(np.median(m_errs)):.2e} over {len(m_errs)} leaves")
    check(loss_rel <= LOSS_RTOL, f"[7a] loss card vs CPU rel {loss_rel} > {LOSS_RTOL}")
    check(gn_rel <= GNORM_RTOL, f"[7a] grad norm card vs CPU rel {gn_rel} > {GNORM_RTOL}")
    check(max(m_errs) <= MOMENT_RTOL, f"[7a] first moment card vs CPU {max(m_errs)} > "
          f"{MOMENT_RTOL}")
    del p_card, p_cpu, o_card, o_cpu
    torch.cuda.empty_cache()

    # [7b] starcoder2-7b at full width cut to 2 of its 32 layers (f32 params, grads
    # and both moments at 16 B/param: 32 layers would need ~115 GB), bf16
    # activations, global batch 4 x 512 tokens, n_micro 2, remat on
    cfg7 = dataclasses.replace(cfg, n_layers=2)
    g.manual_seed(8)
    p7 = M.init_params(g, cfg7, device=dev)
    o7 = opt_lib.init(p7)
    n_params = sum(t.numel() for t in M.leaves(p7))
    batch7 = make_train_batches(cfg.vocab, 512, 4, seed=8)
    step7 = trainer.make_train_step(cfg7, opt7, n_micro=2)

    def batch_at(s):
        return {"tokens": torch.as_tensor(batch7(s)["tokens"], device=dev)}

    torch.cuda.synchronize()
    held7 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses7, ms7 = [], []
    for s in range(8):                     # 2 warm-up steps, then 6 measured
        b = batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p7, o7, met = step7(p7, o7, b)
        losses7.append(float(met["loss"]))     # waits for the step
        ms7.append((time.perf_counter() - t0) * 1e3)
    peak7 = torch.cuda.max_memory_allocated() - held7
    med7 = float(np.median(ms7[2:]))
    tok7 = 4 * 512 / (med7 / 1e3)
    mfu7 = 6 * n_params * 4 * 512 / (med7 / 1e3) / PEAK_OPS["bf16"]
    print(f"[7b] {cfg7.name} full width (d_model {cfg7.d_model}, {cfg7.n_heads}/"
          f"{cfg7.n_kv_heads} heads of {cfg7.head_dim}, d_ff {cfg7.d_ff}, vocab {cfg7.vocab}) at "
          f"2 of 32 layers, {n_params / 1e9:.3f}B params, bf16 activations, batch 4 x 512, "
          f"n_micro 2, remat, AdamW lr {opt7.lr} warmup {opt7.warmup_steps}: step ms "
          f"{[round(t, 1) for t in ms7]}; median of the 6 after warm-up {med7:.1f} ms = "
          f"{tok7:.0f} training tok/s; 6*N*tokens/step/989 TFLOP/s = {mfu7:.4f}; peak "
          f"{peak7 / 2**30:.2f} GiB over the {held7 / 2**30:.2f} held (params + moments); "
          f"{nvidia_smi_line()}")
    print(f"[7b] losses {[round(x, 4) for x in losses7]}")
    check(all(math.isfinite(x) for x in losses7), f"[7b] non-finite loss {losses7}")
    check(losses7[-1] < losses7[0], f"[7b] the loss did not fall: {losses7}")
    b = batch_at(8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p7, o7, met = step7(p7, o7, b)
        float(met["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    report_window("train step (profiled)", prof, wall_us, 1, tag="[7b]")
    del prof
    stepc = trainer.make_train_step(cfg7, opt7, n_micro=2,
                                    compression=comp_lib.CompressionConfig())
    err7 = comp_lib.init_error_state(p7)
    lossc = []
    for s in (9, 10):
        p7, o7, err7, met = stepc(p7, o7, err7, batch_at(s))
        lossc.append(float(met["loss"]))
    err_max = max(float(e.abs().max()) for e in M.leaves(err7))
    print(f"[7b] 2 steps with int8 CrossQuant gradient compression (alpha 0.5, error "
          f"feedback): losses {[round(x, 4) for x in lossc]}, max |error state| {err_max:.3e}")
    check(all(math.isfinite(x) for x in lossc) and err_max > 0,
          f"[7b] compressed steps: losses {lossc}, error state max {err_max}")
    del err7, stepc, o7
    gc.collect()
    torch.cuda.empty_cache()

    # [7c] train, then serve: the trained params through a blocking checkpoint round
    # trip, calibration and W8A8 static-c CrossQuant, served fused-int8, paged, int8 KV
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        cm = CheckpointManager(ckpt_dir, keep_n=1)
        t0 = time.perf_counter()
        cm.save(11, p7, blocking=True)
        t_save = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(ckpt_dir, "step_000000011", f))
                   for f in os.listdir(os.path.join(ckpt_dir, "step_000000011")))
        template = M.map_tensors(p7, lambda t: torch.empty_like(t, device="meta"))
        t0 = time.perf_counter()
        restored, step_r = cm.restore(template, device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(M.leaves(restored), M.leaves(p7)))
    print(f"[7c] checkpoint of the trained params: {size / 2**30:.2f} GiB saved (blocking) in "
          f"{t_save:.1f}s, restored into a fresh template in {t_restore:.1f}s; bitwise equal "
          f"to the live tree: {same}; directory deleted")
    check(step_r == 11 and same, "[7c] the restored params differ from the trained ones")
    t0 = time.perf_counter()
    q_restored = calibrate_and_quantize(restored, cfg7, quant, calib_batches=2, seq_len=16,
                                        batch_size=BATCH, seed=0)
    q_live = calibrate_and_quantize(p7, cfg7, quant, calib_batches=2, seq_len=16,
                                    batch_size=BATCH, seed=0)
    torch.cuda.synchronize()
    print(f"[7c] calibrate + PTQ to W8A8 static-c CrossQuant, twice (restored and in-memory "
          f"trees): {time.perf_counter() - t0:.1f}s")
    del restored
    model7 = (cfg7, linears, None, BATCH, MAX_LEN)
    _, done_r = serve("7c trained+restored W8A8 paged kv=int8", prompts[:BATCH], tree=q_restored,
                      model=model7, kv_cache="int8", cache_layout="paged")
    _, done_l = serve("7c trained in-memory W8A8 paged kv=int8", prompts[:BATCH], tree=q_live,
                      model=model7, kv_cache="int8", cache_layout="paged")
    check([r.out for r in done_r] == [r.out for r in done_l],
          "[7c] the restored tree serves other tokens than the in-memory trained tree")
    print(f"[7c] 4 requests x {MAX_NEW} new tokens served from the restored tree equal those "
          f"from the in-memory trained tree; K1/K2/K3/K4 launch counts per body equal the "
          f"schedule (checked per run above)")
    del q_restored, q_live
    calib7 = calibration_batches(cfg7, calib_batches=2, seq_len=16, batch_size=BATCH, seed=0,
                                 device=dev)
    _, records7 = recorded_plan(make_sparsity_plan, KA, cfg7, p7, calib7, threshold=0.05)
    per7 = {}
    for i, (_, cq, pt) in enumerate(records7):
        per7.setdefault(KINDS[i % len(KINDS)], []).append((cq, pt))
    for kind in KINDS:
        cqs, pts = zip(*per7[kind])
        print(f"[7c]   §4.1 kernel fraction on the trained model, {kind:9s} CrossQuant a=0.15 "
              f"min/median/max {min(cqs):.6f}/{float(np.median(cqs)):.6f}/{max(cqs):.6f}; "
              f"per-token a=1 {min(pts):.6f}/{float(np.median(pts)):.6f}/{max(pts):.6f}")
    n_small7 = sum(cq < pt for cq, pt in (r[1:] for r in records7))
    print(f"[7c]   CrossQuant's kernel is smaller than per-token's on {n_small7} of "
          f"{len(records7)} linear inputs of the trained model (8 steps: nothing claimed)")
    del records7, p7
    gc.collect()
    torch.cuda.empty_cache()

    # [7d] supervised restart through the entry point: mamba2-130m FULL (24 layers),
    # 12 steps of batch 4 x 256, a checkpoint every 4, a failure at step 6, against
    # the same 12 steps uninterrupted
    cfg_m = get("mamba2-130m")
    kw7 = dict(steps=12, global_batch=4, seq_len=256, ckpt_every=4, log_every=4, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        t0 = time.perf_counter()
        faulty = launch_train.run(cfg_m, ckpt_dir=os.path.join(run_dir, "faulty"), fail_at=(6,),
                                  **kw7)
        t_faulty = time.perf_counter() - t0
        step_dir = os.path.join(run_dir, "faulty", "step_000000012")
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        t0 = time.perf_counter()
        clean = launch_train.run(cfg_m, ckpt_dir=os.path.join(run_dir, "clean"), **kw7)
        t_clean = time.perf_counter() - t0
    steps_seen = [h["step"] for h in faulty.metrics_history]
    check(faulty.restarts == 1 and clean.restarts == 0 and steps_seen == list(range(12)),
          f"[7d] restarts {faulty.restarts}/{clean.restarts}, history steps {steps_seen}")
    pf, pc = M.leaves(faulty.state["params"]), M.leaves(clean.state["params"])
    bitwise = all(torch.equal(a, b) for a, b in zip(pf, pc))
    d_params = max(rel_max(a, b) for a, b in zip(pf, pc))
    d_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(faulty.metrics_history, clean.metrics_history))
    print(f"[7d] launch.train.run {cfg_m.name} FULL ({cfg_m.n_layers} layers): 12 steps, batch "
          f"4 x 256, checkpoints of {ck_bytes / 2**30:.2f} GiB every 4 steps; with a failure "
          f"at step 6: 1 restart, history truncated at the restore point and re-run, "
          f"{t_faulty:.1f}s; uninterrupted {t_clean:.1f}s; final params bitwise equal: "
          f"{bitwise} (max|d|/max over leaves {d_params:.2e}; losses rel {d_loss:.2e})")
    # the ops the card runs without a deterministic implementation in one train step
    step_m = trainer.make_train_step(cfg_m, opt_lib.AdamWConfig(lr=3e-3))
    pm = M.map_tensors(clean.state["params"], lambda t: t.clone())
    bm = {"tokens": torch.as_tensor(make_train_batches(cfg_m.vocab, 256, 4)(0)["tokens"],
                                    device=dev)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step_m(pm, opt_lib.init(pm), bm)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"[7d] ops without a deterministic implementation in one {cfg_m.name} train step "
          f"(torch.use_deterministic_algorithms(True, warn_only=True)): {nondet or 'none'}")
    check(bitwise, f"[7d] the restarted run's params differ from the uninterrupted run's by "
          f"{d_params} (ops without a deterministic implementation: {nondet})")
    del faulty, clean, pm, pf, pc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[7] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_s7:.1f}s "
          f"for training)")

    # ---------------------------------------------------------------- phase 8
    # [8] Tensor- and expert-parallel serving: two ranks spawned on the one card,
    # a gloo process group over CUDA tensors (NCCL refuses two ranks on one
    # device). The parent builds each FULL W8A8 tree once (seeded, calibrated with
    # the launcher's traffic, as phase 4 does) and serves it single-device; the
    # ranks receive the tree by CUDA IPC and copy only their shards.
    # starcoder2-7b FULL at tp=2 (tier tp_full: 18/2 heads a rank; wq/wk/wv/up
    # column-parallel, wo/down row-parallel through K1's given-max and K2's
    # int32-out modes, the vocab-parallel embedding and head): dense with int8 KV
    # and paged with int8 KV behind the 389-token shared prefix, 4 requests x 16
    # tokens each; granite-moe-3b-a800m FULL at ep=2 (expert_axis: 20 of 40 experts
    # a rank), dense int8 KV. Per rank: tokens equal the single-device engine's,
    # every logits row its sampler saw bitwise equal, launches per body and
    # collectives per model call equal the schedule, weights about half the single
    # engine's (starcoder2). Times are of 2 ranks sharing one H100 over gloo, beside
    # the single-device engine's in this call: nothing is claimed. Then
    # starcoder2-7b at data 2 (paged, int8 KV, the shared-prefix
    # traffic: each rank its own 2 slots, a whole pool, one hidden-row gather and
    # one K/V-row exchange a call), W4A8 g128 at tp=2 over short prompts (K8's
    # group-acc mode in wo and down), granite-moe forced to expert_tp at tp=2 (the
    # expert-batched K1 given-max and K2 int32-out modes in down), mamba2-130m and
    # zamba2-1.2b at tp=2 (paged; the state heads split), each against the
    # single-device engine on the same tree and traffic.
    print(f"[8] start at {time.perf_counter() - t_start:.1f}s; {nvidia_smi_line()}")
    t_s8 = time.perf_counter()
    import socket

    import torch.multiprocessing as tmp

    cfg8, q8, q8w4 = build("starcoder2-7b", 0, w4=True)
    cfg8m, q8m = build("granite-moe-3b-a800m", 30)
    cfg8s, _, q8s = build_ssm("mamba2-130m", 50)
    cfg8z, _, q8z = build_ssm("zamba2-1.2b", 51)
    torch.cuda.empty_cache()
    trees8 = {"sc": q8, "w4": q8w4, "granite": q8m, "mamba": q8s, "zamba": q8z}
    full_bytes = {k: quantized_bytes(v) for k, v in trees8.items()}
    print(f"[8] trees built in {time.perf_counter() - t_s8:.1f}s: "
          + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in full_bytes.items()))
    L8 = cfg8.n_layers
    d8, hd8, kv8, ff8 = cfg8.d_model, cfg8.n_heads * cfg8.head_dim, \
        cfg8.n_kv_heads * cfg8.head_dim, cfg8.d_ff
    tp_coll = {"sum_i32": 2 * L8, "max_f32": 2 * L8, "sum_f32": 1, "gather_vocab": 1}
    sc_runs = dict(cfg=cfg8, tree="sc", quant=quant, mesh=(1, 2), experts=(),
                   experts_local=0, share=0.5, bitwise="first",
                   linears=[(d8, hd8 // 2, L8), (d8, kv8 // 2, L8), (d8, kv8 // 2, L8),
                            (d8, ff8 // 2, L8)],
                   row_linears=[(hd8 // 2, d8, L8), (ff8 // 2, d8, L8)],
                   collectives_per_call=tp_coll)
    dm, fm = cfg8m.d_model, cfg8m.d_ff_expert
    prompts8 = make_prompts(cfg8.vocab, LENS, BATCH, seed=0)     # phase 4's first four
    rng8 = np.random.default_rng(8)
    system8 = rng8.integers(1, cfg8.vocab, size=SYSTEM_PREFIX).astype(np.int32)
    shared8 = [np.concatenate([system8, rng8.integers(1, cfg8.vocab, size=n).astype(np.int32)])
               for n in SUFFIXES[:BATCH]]
    prompts8m = make_prompts(cfg8m.vocab, LENS, BATCH, seed=30)  # [4m]'s first four
    # W4A8 at tp=2 on short prompts (buckets 32 and 64): the gathered group partials
    # of an admission stay under the 256 MiB chunk, down's 2.65 MB a row
    prompts8w = make_prompts(cfg8.vocab, [20, 33, 47, 60], BATCH, seed=5)
    dense_cfg = dict(batch_size=BATCH, max_len=MAX_LEN, path="fused-int8", kv_cache="int8")
    paged_cfg = dict(dense_cfg, cache_layout="paged")
    Ha, ssm_cfg = cfg8z.n_heads * cfg8z.head_dim, dict(paged_cfg, prefix_reuse=False)
    n_sh = cfg8z.n_layers // cfg8z.attn_every
    runs8 = [
        dict(sc_runs, label="starcoder2-7b tp=2 dense int8 KV", reqs=prompts8,
             max_new=MAX_NEW, config=dense_cfg),
        dict(sc_runs, label="starcoder2-7b tp=2 paged int8 KV shared prefix",
             reqs=shared8, max_new=MAX_NEW, config=paged_cfg, bitwise="all"),
        dict(label="granite-moe ep=2 dense int8 KV", cfg=cfg8m, tree="granite", quant=quant,
             mesh=(1, 1, 2), reqs=prompts8m, max_new=MAX_NEW, config=dense_cfg,
             linears=[(K, N, cfg8m.n_layers) for K, N in linear_shapes(cfg8m)[:4]],
             row_linears=[], experts=[(dm, fm), (dm, fm), (fm, dm)],
             experts_local=cfg8m.n_experts // 2, share=None, bitwise="all",
             collectives_per_call={"gather_experts": cfg8m.n_layers}),
        # data-parallel slots, W4A8 under TP, expert_tp, SSM and hybrid
        dict(sc_runs, label="starcoder2-7b data=2 paged int8 KV shared prefix",
             mesh=(2, 1), reqs=shared8, max_new=MAX_NEW, config=paged_cfg, share=1.0,
             bitwise="all", single="starcoder2-7b tp=2 paged int8 KV shared prefix",
             linears=[(K, N, L8) for K, N in linear_shapes(cfg8)], row_linears=[],
             collectives_per_call={"gather_slots": 1, "gather_pages": 1}),
        dict(sc_runs, label="starcoder2-7b W4A8 tp=2 dense int8 KV short prompts",
             tree="w4", quant=quant4, reqs=prompts8w, max_new=MAX_NEW // 2, config=dense_cfg,
             bitwise="bar", linears=[], row_linears=[],
             w4_linears=sc_runs["linears"], w4_row_linears=sc_runs["row_linears"],
             collectives_per_call={"max_f32": 2 * L8, "sum_f32": 1, "gather_vocab": 1}),
        dict(label="granite-moe expert_tp tp=2 dense int8 KV", cfg=cfg8m, tree="granite",
             quant=quant, mesh=(1, 2), moe_mode="expert_tp", reqs=prompts8m,
             max_new=MAX_NEW, config=dense_cfg, share=0.5, bitwise="all",
             single="granite-moe ep=2 dense int8 KV",
             linears=[(dm, N // 2, cfg8m.n_layers) for K, N in linear_shapes(cfg8m)[:3]],
             row_linears=[(cfg8m.n_heads * cfg8m.head_dim // 2, dm, cfg8m.n_layers)],
             experts=[(dm, fm // 2), (dm, fm // 2)], experts_row=[(fm // 2, dm)],
             experts_local=cfg8m.n_experts, collectives_per_call=dict(
                 tp_coll, sum_i32=2 * cfg8m.n_layers, max_f32=2 * cfg8m.n_layers)),
        dict(label="mamba2-130m tp=2 paged", cfg=cfg8s, tree="mamba", quant=quant,
             mesh=(1, 2), reqs=make_prompts(cfg8s.vocab, LENS, BATCH, seed=50),
             max_new=MAX_NEW // 2, config=ssm_cfg, share=0.5, bitwise="all", attn_layers=0,
             linears=[(cfg8s.d_model, (2 * cfg8s.d_inner + 2 * cfg8s.ssm_state
                                       + cfg8s.ssm_heads) // 2, cfg8s.n_layers)],
             row_linears=[(cfg8s.d_inner // 2, cfg8s.d_model, cfg8s.n_layers)],
             experts=(), experts_local=0,
             collectives_per_call={"sum_i32": cfg8s.n_layers, "max_f32": cfg8s.n_layers,
                                   "gather_cols": 2 * cfg8s.n_layers, "sum_f32": 1,
                                   "gather_vocab": 1}),
        # mamba2 with data-parallel slots: each rank its own 2 slots and their state
        # pages in a whole pool (max_len 512: a rank holds every head's state, and
        # the pools of max_len 1024 on both ranks do not fit beside the parent's
        # trees); the gated norm served through F.rms_norm, so a rank's rows round
        # as among one device's 4
        dict(label="mamba2-130m data=2 paged", cfg=cfg8s, tree="mamba", quant=quant,
             mesh=(2, 1), reqs=make_prompts(cfg8s.vocab, LENS, BATCH, seed=50),
             max_new=MAX_NEW // 2, config=dict(ssm_cfg, max_len=512), share=1.0,
             bitwise="all", attn_layers=0,
             linears=[(cfg8s.d_model, 2 * cfg8s.d_inner + 2 * cfg8s.ssm_state
                       + cfg8s.ssm_heads, cfg8s.n_layers),
                      (cfg8s.d_inner, cfg8s.d_model, cfg8s.n_layers)],
             row_linears=[], experts=(), experts_local=0,
             collectives_per_call={"gather_slots": 1}),
        dict(label="zamba2-1.2b tp=2 paged", cfg=cfg8z, tree="zamba", quant=quant,
             mesh=(1, 2), reqs=make_prompts(cfg8z.vocab, LENS, BATCH, seed=51),
             max_new=MAX_NEW // 2, config=ssm_cfg, share=0.5, bitwise="all",
             attn_layers=n_sh,
             linears=[(cfg8z.d_model, (2 * cfg8z.d_inner + 2 * cfg8z.ssm_state
                                       + cfg8z.ssm_heads) // 2, cfg8z.n_layers)]
             + [(cfg8z.d_model, N // 2, n_sh) for N in (Ha, Ha, Ha, cfg8z.d_ff, cfg8z.d_ff)],
             row_linears=[(cfg8z.d_inner // 2, cfg8z.d_model, cfg8z.n_layers),
                          (Ha // 2, cfg8z.d_model, n_sh), (cfg8z.d_ff // 2, cfg8z.d_model, n_sh)],
             experts=(), experts_local=0,
             collectives_per_call={"sum_i32": cfg8z.n_layers + 2 * n_sh,
                                   "max_f32": cfg8z.n_layers + 2 * n_sh,
                                   "gather_cols": 2 * cfg8z.n_layers, "sum_f32": 1,
                                   "gather_vocab": 1}),
    ]
    single8 = {}
    for run in runs8:                  # the single-device engine on the same trees
        if "single" in run:            # the same tree, config and traffic as another run
            continue
        seen8 = []
        make8 = serving_engine._make_sampler

        def recording8(temperature, top_k, seen8=seen8, make8=make8):
            inner = make8(temperature, top_k)

            def sample(logits, gen):
                seen8.append(logits.cpu().numpy())
                return inner(logits, gen)
            return sample

        serving_engine._make_sampler = recording8
        try:
            eng8 = ServeEngine(run["cfg"], trees8[run["tree"]], quant=run["quant"],
                               device=dev, config=EngineConfig(**run["config"]))
        finally:
            serving_engine._make_sampler = make8
        rows8, ms8 = [], []
        apply8 = M.apply

        def apply_timed(p, inputs, *rest, apply8=apply8, rows8=rows8, ms8=ms8, **kw):
            t0 = time.perf_counter()
            o = apply8(p, inputs, *rest, **kw)
            torch.cuda.synchronize()
            rows8.append(inputs["tokens"].numel())
            ms8.append((time.perf_counter() - t0) * 1e3)
            return o

        eng8.submit([np.asarray(r, np.int32) for r in run["reqs"]], max_new=run["max_new"])
        torch.cuda.synchronize()
        M.apply = apply_timed
        t0 = time.perf_counter()
        try:
            done8 = eng8.run()
            torch.cuda.synchronize()
        finally:
            M.apply = apply8
        dt8 = time.perf_counter() - t0
        small8 = [t for m_, t in zip(rows8, ms8) if m_ <= DECODE_MAX_M]
        single8[run["label"]] = dict(
            tokens={r.rid: r.out for r in done8}, logits=seen8,
            tok_s=sum(len(r.out) for r in done8) / dt8, call_ms=float(np.median(small8)))
        del eng8, done8
        torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port8 = sk.getsockname()[1]
    ctx8 = tmp.get_context("spawn")
    queue8 = ctx8.Queue()
    job8 = dict(runs=runs8, trees=trees8)
    procs8 = [ctx8.Process(target=tp_rank, args=(r, port8, job8, queue8)) for r in (0, 1)]
    for pr in procs8:
        pr.start()
    ranks8 = {}
    try:
        for _ in procs8:
            rk, status, payload = queue8.get(timeout=900)
            check(status == "ok", f"[8] rank {rk} failed:\n{payload}")
            ranks8[rk] = payload
    finally:
        for pr in procs8:
            pr.join(timeout=120)
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(all(pr.exitcode == 0 for pr in procs8),
          f"[8] rank exit codes {[pr.exitcode for pr in procs8]}")
    # Logits: every rank makes the single-device engine's sampler calls (one
    # allocator and radix index, the same admissions), and each call is compared.
    # "all": every call bitwise, where the hand-written kernels carry the attention
    # (paged: K4) or attention is whole (ep=2). "first": the admissions and the
    # first decode step bitwise: the dense layout's decode attention is plain torch
    # (as the reference's), two einsums run as cuBLAS batched f32 GEMMs over (slot,
    # kv head) whose algorithm cuBLAS picks by the batch count, so a rank holding 2
    # of the 4 kv heads may round a score otherwise than one device holding all 4.
    # "bar": no call bitwise: W4A8 at tp=2 sums the group products after the
    # gather, in another order than the single device's K8 fold. Past the bitwise
    # calls, every call up to the first where a row's greedy token
    # parts holds max|d logit| <= LOGIT_BAR * max|logit| (the drift bounded, not
    # only the tokens), and a parting must be a near tie inside that bar: the
    # single engine's top-1/top-2 margin on the parting rows at most twice the
    # call's max|d logit|. Later calls see other tokens and are not compared.
    LOGIT_BAR = 5e-2        # 2.4x the largest drift read before (2.07e-2, W4A8 tp=2)
    p8_bodies = {name: 0 for name in ops.BODY_LAUNCHES}
    logit_faults = []

    def drift(got_l, one_l, held):
        """Calls ``held`` onwards up to the first parting: (index of the parting
        call or None, the largest max|d logit| / max|logit| of those calls, the
        parting rows' largest top-1/top-2 margin and the call's max|d logit|)."""
        worst = 0.0
        for i in range(held, len(one_l)):
            a2 = got_l[i].reshape(-1, got_l[i].shape[-1]).astype(np.float64)
            b2 = one_l[i].reshape(-1, one_l[i].shape[-1]).astype(np.float64)
            dmax = float(np.abs(a2 - b2).max())
            worst = max(worst, dmax / float(np.abs(b2).max()))
            rows_ = np.nonzero(a2.argmax(-1) != b2.argmax(-1))[0]
            if len(rows_):
                top2 = np.sort(b2[rows_], axis=-1)[:, -2:]
                return i, worst, float((top2[:, 1] - top2[:, 0]).max()), dmax
        return None, worst, 0.0, 0.0

    for run in runs8:
        lab = run["label"]
        one = single8[run.get("single", lab)]
        policy = run["bitwise"]
        for rk in (0, 1):
            got = ranks8[rk][lab]
            check(len(got["logits"]) == len(one["logits"]),
                  f"[8] {lab} rank {rk}: {len(got['logits'])} sampler calls != the single "
                  f"engine's {len(one['logits'])}")
            held = {"all": len(one["logits"]), "first": got["prefill_calls"] + 1,
                    "bar": 0}[policy]
            differ = [i for i, (a_, b_) in enumerate(zip(got["logits"], one["logits"]))
                      if not np.array_equal(a_, b_)]
            if differ:
                note = (f"{lab} rank {rk}: {len(differ)} of {len(one['logits'])} sampler "
                        f"calls' logits differ (first call {differ[0]}; "
                        + (f"calls 0..{held - 1} held bitwise)" if held else "none held "
                           "bitwise)"))
                print(f"[8] logits: {note}")
                if differ[0] < held:
                    logit_faults.append(note)
            part, worst, margin, dmax = drift(got["logits"], one["logits"], held)
            got["drift"], got["part"] = worst, part
            check(worst <= LOGIT_BAR, f"[8] {lab} rank {rk}: logits drift {worst:.3e} of "
                  f"max|logit| before the tokens part (call {part}), over the bar {LOGIT_BAR}")
            check(part is not None or got["tokens"] == one["tokens"],
                  f"[8] {lab} rank {rk}: tokens {got['tokens']} != single-device "
                  f"{one['tokens']} with every call's argmax equal")
            if part is not None:
                check(margin <= 2 * dmax, f"[8] {lab} rank {rk}: tokens part at sampler "
                      f"call {part} with a top-1/top-2 margin {margin:.3e} > 2 x |d| "
                      f"{dmax:.3e}: not a near tie")
                print(f"[8] {lab} rank {rk}: tokens part from the single engine's at a near "
                      f"tie: sampler call {part}, top-1/top-2 margin {margin:.3e} <= 2 x |d| "
                      f"{dmax:.3e}, the drift up to it {worst:.3e} <= {LOGIT_BAR} of "
                      f"max|logit|")
        check(all(np.array_equal(a_, b_) for a_, b_ in zip(ranks8[0][lab]["logits"],
                                                           ranks8[1][lab]["logits"])),
              f"[8] {lab}: the two ranks' logits differ")
        r0 = ranks8[0][lab]
        for name in p8_bodies:
            p8_bodies[name] += r0["bodies"][name]
        ratio = r0["shard_bytes"] / full_bytes[run["tree"]]
        if run["share"] is not None:
            check(abs(ratio - run["share"]) <= 0.06,
                  f"[8] {lab}: a rank holds {ratio:.3f} of the weights, not ~{run['share']}")
        held_txt = {"all": "every one", "first": "the admissions and the first decode step",
                    "bar": "none"}[policy]
        print(f"[8] {lab}: plan {r0['plan']['tier']}/{r0['plan']['moe_mode']} dp="
              f"{r0['plan']['dp']} tp={r0['plan']['tp']} ep={r0['plan']['ep']}, slot groups "
              f"{r0['slot_groups']}; tokens "
              f"{'equal' if r0['tokens'] == one['tokens'] else 'part at a near tie from'} "
              f"the single-device engine's on rank 0; of {len(one['logits'])} sampler calls "
              f"{held_txt} held bitwise, the rest up to a parting within {r0['drift']:.3e} <= "
              f"{LOGIT_BAR} of max|logit|; {r0['calls']} model calls, launches per body and "
              f"collectives { {k: v for k, v in r0['collectives'].items() if v} } equal the "
              f"schedule on both ranks; rank weights {r0['shard_bytes'] / 2**30:.3f} GiB = "
              f"{ratio:.3f} of the single engine's {full_bytes[run['tree']] / 2**30:.3f} GiB, "
              f"rank peak {r0['peak'] / 2**30:.2f} GiB over what it held before; prefix hits "
              f"{r0['prefix_hits']}, peak pages {r0['peak_pages']}")
        print(f"[8]   {lab}: 2 ranks sharing one H100 over gloo {r0['tok_s']:.1f} tok/s, "
              f"model call {r0['call_ms']:.1f} ms (rank 1 {ranks8[1][lab]['tok_s']:.1f} tok/s, "
              f"{ranks8[1][lab]['call_ms']:.1f} ms); the single-device engine in this call "
              f"{one['tok_s']:.1f} tok/s, {one['call_ms']:.1f} ms; nothing claimed")
        print(f"[8]   {lab}: rank 0's decode call {r0['call_ms']:.3f} ms (median): "
              f"{r0['wait_ms']:.3f} ms waiting for the card before its {r0['coll_n']} "
              f"collectives, {r0['coll_ms']:.3f} ms inside them (the peer rank's arrival "
              f"included), {r0['call_ms'] - r0['wait_ms'] - r0['coll_ms']:.3f} ms of host "
              f"remainder; the same collectives alone {r0['solo_ms']:.3f} ms a call "
              f"(op: per call, median ms alone: {r0['solo']})")
    check(not logit_faults, "[8] logits not bitwise the single-device engine's: "
          + "; ".join(logit_faults))
    # Why the dense layout's later decode steps may part: the decode attention's two
    # einsums on one device's 4 kv heads against a rank's 2 (same inputs, f32, the
    # dense decode's shapes), and the tied head's bf16 product split by vocab. Each
    # line counts the elements of the rank's share that differ (printed, not held).
    gd = torch.Generator(device=dev)
    gd.manual_seed(8)
    for T in (256, 1024):
        qd = torch.randn(BATCH, 4, 9, 128, generator=gd, device=dev)
        kd = torch.randn(BATCH, T, 4, 128, generator=gd, device=dev)
        sc_full = torch.einsum("bhgd,bthd->bhgt", qd, kd)
        sc_half = torch.einsum("bhgd,bthd->bhgt", qd[:, :2], kd[:, :, :2])
        pd = torch.softmax(sc_full, dim=-1)
        out_full = torch.einsum("bhgt,bthd->bhgd", pd, kd)
        out_half = torch.einsum("bhgt,bthd->bhgd", pd[:, :2], kd[:, :, :2])
        print(f"[8] dense decode attention einsums, T={T}, 2 of 4 kv heads against all 4: "
              f"scores differ at {int((sc_full[:, :2] != sc_half).sum())} of "
              f"{sc_half.numel()}, outputs at {int((out_full[:, :2] != out_half).sum())} of "
              f"{out_half.numel()}")
    xd = torch.randn(BATCH, cfg8.d_model, generator=gd, device=dev).to(torch.bfloat16)
    wd = (torch.randn(cfg8.vocab_padded, cfg8.d_model, generator=gd, device=dev) * 0.02)
    head_full = xd @ wd.T.to(torch.bfloat16)
    v2 = cfg8.vocab_padded // 2
    head_half = xd @ wd[:v2].T.to(torch.bfloat16)
    print(f"[8] tied head bf16, vocab split in 2: "
          f"{int((head_full[:, :v2] != head_half).sum())} of {head_half.numel()} differ")
    # Why a data rank's norms are served through F.layer_norm / F.rms_norm: the
    # f32 row statistics of a rank's 2 rows against the same rows among one
    # device's 4 (d_model 4608, 64 seeded draws), in the two-pass form training
    # and the CPU keep (torch's mean) and as norm_apply serves them on the card.
    # Counted, not held ([8]'s data-2 run holds the served logits).
    from repro_torch.models import layers as layers8
    pn = {"scale": torch.ones(cfg8.d_model, device=dev),
          "bias": torch.zeros(cfg8.d_model, device=dev)}
    cfg_rms = dataclasses.replace(cfg8, norm="rmsnorm")
    n_mu = n_ln = n_rms = 0
    for _ in range(64):
        xn = torch.randn(BATCH, 1, cfg8.d_model, generator=gd, device=dev) * 3
        n_mu += int((xn.mean(-1)[:2] != xn[:2].mean(-1)).sum())
        n_ln += int((layers8.norm_apply(pn, xn, cfg8)[:2]
                     != layers8.norm_apply(pn, xn[:2], cfg8)).sum())
        n_rms += int((layers8.norm_apply(pn, xn, cfg_rms)[:2]
                      != layers8.norm_apply(pn, xn[:2], cfg_rms)).sum())
    print(f"[8] norms of 2 rows against the same rows among 4 (d_model {cfg8.d_model}, 64 "
          f"draws, f32): torch's mean differs at {n_mu} of 128 rows; served layernorm "
          f"outputs at {n_ln}, rmsnorm outputs at {n_rms} of {128 * cfg8.d_model}")
    del qd, kd, sc_full, sc_half, pd, out_full, out_half, xd, wd, head_full, head_half, xn
    del q8, q8w4, q8m, q8s, q8z, trees8, job8
    torch.cuda.empty_cache()
    print(f"[8] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_s8:.1f}s "
          f"for sharded serving)")

    # ---------------------------------------------------------------- phase 9
    # [9] Sharded training: two ranks spawned on the one card over gloo, as [8]. The
    # parent runs the one-device make_train_step on the card (f32 params and moments,
    # TF32 off) from seeded params and batches, and hands the ranks the initial
    # params, the batches and its first moment after each step by CUDA IPC; each
    # rank cuts its shards and takes the same steps sharded. starcoder2-7b FULL
    # width cut to 2 of its 32 layers at data 2 (FSDP: a rank stores half the
    # params and moments, gathers them for the step, sums the gradients over the
    # data axis) and at model 2 (tp_full: Megatron's column/row-parallel linears,
    # the vocab-parallel embedding and head); granite-moe-3b-a800m FULL width cut
    # to 2 layers at data 2 (a rank's rows are one token group of the grouped
    # dispatch), against the one-device step at G = 2. Global batch 4 x 512,
    # n_micro 2, 2 steps, AdamW lr 1e-4: each step's loss, grad norm and each rank's
    # shard of the first moment within phase 7's bars. Step ms of a rank beside one
    # device's (two ranks sharing one card measure no multi-card speed), the
    # collectives of a step by kind with their ms, a rank's bytes of params + m + v
    # over one device's and its peak memory are printed.
    print(f"[9] start at {time.perf_counter() - t_start:.1f}s; {nvidia_smi_line()}")
    t_s9 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    check(not tf32, "[9] TF32 is on: the f32 parity steps need full-f32 matmuls")
    opt9 = opt_lib.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    S9, B9, N_MICRO9, STEPS9 = 512, 4, 2, 2
    cfgs9 = {"sc": dataclasses.replace(cfg, n_layers=2, dtype="float32"),
             "granite": dataclasses.replace(get("granite-moe-3b-a800m"), n_layers=2,
                                            dtype="float32")}
    inits9, batches9, refs9, one9 = {}, {}, {}, {}
    for k, c9 in cfgs9.items():
        g9 = torch.Generator(device=dev)
        g9.manual_seed(90 + len(k))
        inits9[k] = M.init_params(g9, c9, device=dev)
        bf9 = make_train_batches(c9.vocab, S9, B9, seed=91)
        batches9[k] = [{"tokens": torch.as_tensor(bf9(s)["tokens"], device=dev)}
                       for s in range(STEPS9)]
        p9 = M.map_tensors(inits9[k], lambda t: t.clone())
        o9 = opt_lib.init(p9)
        step9 = trainer.make_train_step(c9, opt9, n_micro=N_MICRO9,
                                        token_groups=2 if c9.n_experts else 1)
        refs9[k], ms9 = [], []
        for s in range(STEPS9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p9, o9, met9 = step9(p9, o9, batches9[k][s])
            refs9[k].append({"loss": float(met9["loss"]), "gnorm": float(met9["grad_norm"]),
                             "m": M.map_tensors(o9.m, lambda t: t.clone())})
            torch.cuda.synchronize()
            ms9.append((time.perf_counter() - t0) * 1e3)
        one9[k] = dict(ms=ms9, bytes=3 * sum(t.numel() * t.element_size()
                                             for t in M.leaves(p9)))
        del p9, o9, step9
        torch.cuda.empty_cache()
        print(f"[9] one device, {c9.name} FULL width at 2 layers, f32, batch {B9} x {S9}, "
              f"n_micro {N_MICRO9}{', G = 2' if c9.n_experts else ''}: step ms "
              f"{[round(t, 1) for t in ms9]}, losses {[round(r['loss'], 6) for r in refs9[k]]}; "
              f"params + m + v {one9[k]['bytes'] / 2**30:.2f} GiB; {nvidia_smi_line()}")
    runs9 = [dict(label="starcoder2-7b data=2 (FSDP)", cfg=cfgs9["sc"], tree="sc", mesh=(2, 1)),
             dict(label="starcoder2-7b model=2 (tp_full)", cfg=cfgs9["sc"], tree="sc",
                  mesh=(1, 2)),
             dict(label="granite-moe data=2 (FSDP, grouped dispatch)", cfg=cfgs9["granite"],
                  tree="granite", mesh=(2, 1))]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port9 = sk.getsockname()[1]
    queue9 = ctx8.Queue()
    job9 = dict(runs=runs9, inits=inits9, batches=batches9, ref=refs9, opt=opt9,
                n_micro=N_MICRO9)
    procs9 = [ctx8.Process(target=train_rank, args=(r, port9, job9, queue9)) for r in (0, 1)]
    for pr in procs9:
        pr.start()
    ranks9 = {}
    try:
        for _ in procs9:
            rk, status, payload = queue9.get(timeout=600)
            check(status == "ok", f"[9] rank {rk} failed:\n{payload}")
            ranks9[rk] = payload
    finally:
        for pr in procs9:
            pr.join(timeout=120)
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(all(pr.exitcode == 0 for pr in procs9),
          f"[9] rank exit codes {[pr.exitcode for pr in procs9]}")
    for run in runs9:
        lab = run["label"]
        for rk in (0, 1):
            for s, st in enumerate(ranks9[rk][lab]["steps"]):
                check(st["loss_rel"] <= LOSS_RTOL, f"[9] {lab} rank {rk} step {s}: loss rel "
                      f"{st['loss_rel']} > {LOSS_RTOL}")
                check(st["gn_rel"] <= GNORM_RTOL, f"[9] {lab} rank {rk} step {s}: grad norm rel "
                      f"{st['gn_rel']} > {GNORM_RTOL}")
                check(st["m_err"] <= MOMENT_RTOL, f"[9] {lab} rank {rk} step {s}: first moment "
                      f"{st['m_err']} > {MOMENT_RTOL}")
        r0 = ranks9[0][lab]
        one = one9[run["tree"]]
        for s, st in enumerate(r0["steps"]):
            print(f"[9] {lab} step {s}: rank 0 {st['ms']:.1f} ms (rank 1 "
                  f"{ranks9[1][lab]['steps'][s]['ms']:.1f}), one device {one['ms'][s]:.1f} ms; "
                  f"loss rel {st['loss_rel']:.2e}, grad norm rel {st['gn_rel']:.2e}, first "
                  f"moment max|d|/max per leaf {st['m_err']:.2e} (rank 1 "
                  f"{ranks9[1][lab]['steps'][s]['m_err']:.2e}); collectives by kind "
                  f"{st['counts']}, by op (calls, ms) "
                  f"{ {k: (n, round(t, 1)) for k, (n, t) in st['by_op'].items()} }")
        print(f"[9] {lab}: plan {r0['plan']['tier']}/{r0['plan']['moe_mode']} dp="
              f"{r0['plan']['dp']} tp={r0['plan']['tp']} fsdp={r0['plan']['fsdp']}; a rank holds "
              f"{r0['held'] / 2**30:.2f} GiB of params + m + v = {r0['held'] / one['bytes']:.3f} "
              f"of one device's {one['bytes'] / 2**30:.2f} GiB; rank peak {r0['peak'] / 2**30:.2f} "
              f"GiB over what it held before (rank 1 {ranks9[1][lab]['peak'] / 2**30:.2f}); "
              f"every step within loss {LOSS_RTOL}, grad norm {GNORM_RTOL}, first moment "
              f"{MOMENT_RTOL} on both ranks; 2 ranks sharing one H100 over gloo, "
              f"nothing claimed; {nvidia_smi_line()}")
    del inits9, batches9, refs9, job9
    torch.cuda.empty_cache()
    print(f"[9] end at {time.perf_counter() - t_start:.1f}s ({time.perf_counter() - t_s9:.1f}s "
          f"for sharded training)")

    # ---------------------------------------------------------------- result
    reset5()
    # (name, source, replaced TPU kernel, phase-3 result, shape, launch counts): the
    # bodies of the main path count their phase-4 launches; the f32 bodies serve
    # only the phase-5 parity runs and count those. K2's tile body serves mamba2's
    # in_proj (N = 3352, off the 16-column grid) in [4s]; K7's and K8's tile bodies
    # and K1's sweep body serve no run.
    kernel_rows = [
        ("act_quantize/split", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize/split", 4, 4608),
         "M=4 K=4608 bf16, cluster-split body", "phase 4"),
        ("act_quantize/rows", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize/rows", 2048, 18432),
         "M=2048 K=18432 bf16, rows body", "phase 4"),
        ("qgemm_w8a8/decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8", 4, 4608, 18432),
         "M=4 K=4608 N=18432, split-K decode body", "phase 4"),
        ("qgemm_w8a8/wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/wgmma", 2048, 4608, 18432),
         "M=2048 K=4608 N=18432, wgmma body", "phase 4"),
        ("qgemm_w8a8/tile", "src/repro_torch/csrc/qgemm_w8a8.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/tile", 4, 768, 3352),
         "M=4 K=768 N=3352 (mamba2-130m in_proj), 64 x 64 tile body", "phase 4"),
        ("act_quantize/experts_rows", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29",
         ("act_quantize/experts_rows", 40, 8, 1536, 0.15),
         "E=40 C=8 K=1536 bf16 alpha=0.15, expert-batched rows body (granite decode)",
         "phase 4"),
        ("qgemm_w8a8/experts_decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/experts_decode", 40, 8, 1536, 512),
         "E=40 C=8 K=1536 N=512, expert-batched split-K decode body (granite up)", "phase 4"),
        ("qgemm_w8a8/experts_wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/experts_wgmma", 40, 512, 1536, 512),
         "E=40 C=512 K=1536 N=512, expert-batched wgmma body (granite 4 x 512 admission)",
         "phase 4"),
        ("flash_attention/bf16_mma", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:33", ("flash_attention", 512, "bf16"),
         "B=4 H=36/4 S=512 D=128 bf16, tensor-core body", "phase 4"),
        ("flash_attention/f32", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:33", ("flash_attention", 512, "f32"),
         "B=4 H=36/4 S=512 D=128 f32, CUDA-core body", "phase 5"),
        ("paged_decode_attention", "src/repro_torch/csrc/paged_attention_mma.cu",
         "src/repro/kernels/flash_attention.py:98",
         ("paged_decode_attention", "bf16", "f32", 8),
         "B=4 H=36/4 D=128 ps=8 q bf16 pool f32 kv_len=[700,517,130,1], split bf16 body",
         "phase 4"),
        ("paged_verify_attention", "src/repro_torch/csrc/paged_attention_mma.cu",
         "src/repro/kernels/flash_attention.py:98",
         ("paged_verify_attention", "bf16", "f32", 8),
         "B=4 H=36/4 D=128 ps=8 q_win=4 q bf16 pool f32 q_len=[4,1,3,2], split bf16 body",
         "phase 4"),
        ("ragged_prefill_attention", "src/repro_torch/csrc/paged_attention_mma.cu",
         "src/repro/kernels/flash_attention.py:337",
         ("ragged_prefill_attention", "f32", "128 mixed"),
         "Nt=128 B=4 H=36/4 D=128 ps=8 q bf16 pool f32 q_len=[1,1,1,125] "
         "kv_len=[700,517,130,514], split bf16 body", "phase 4"),
        ("paged_attention/f32", "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/flash_attention.py:98",
         ("paged_decode_attention", "f32", "f32", 8),
         "B=4 H=36/4 D=128 ps=8 q f32 pool f32 kv_len=[700,517,130,1], CUDA-core body "
         "(decode; it serves verify and ragged f32 q too)", "phase 5"),
        ("qgemm_w8a8_sparse/decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:91", ("qgemm_w8a8_sparse", 4, 4608, 18432, "alt"),
         "M=4 K=4608 N=18432, every other 64-row k-tile empty, split-K decode body with "
         "the tile skip", "phase 4"),
        ("qgemm_w8a8_sparse/wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:91", ("qgemm_w8a8_sparse", 2048, 4608, 18432, "alt"),
         "M=2048 K=4608 N=18432, every other 64-row k-tile empty, wgmma body with the "
         "tile skip", "phase 4"),
        ("qgemm_w4a8/decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:161", ("qgemm_w4a8/decode", 4, 4608, 18432),
         "M=4 K=4608 N=18432 g128, split-K decode body", "phase 4"),
        ("qgemm_w4a8/wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:161", ("qgemm_w4a8/wgmma", 2048, 4608, 18432),
         "M=2048 K=4608 N=18432 g128, wgmma body", "phase 4"),
    ]
    kernel_rows += [
        ("act_quantize/given_split", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize/given_split", 4, 9216),
         "M=4 K=9216 bf16 (starcoder2 down at tp=2), given-max mode, cluster-split body",
         "phase 8"),
        ("act_quantize/given_rows", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize/given_rows", 2048, 9216),
         "M=2048 K=9216 bf16, given-max mode, rows body", "phase 8"),
        ("qgemm_w8a8/i32_decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/i32_decode", 4, 9216, 4608),
         "M=4 K=9216 N=4608 (starcoder2 down at tp=2), int32-out mode, split-K decode body",
         "phase 8"),
        ("qgemm_w8a8/i32_wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/i32_wgmma", 2048, 9216, 4608),
         "M=2048 K=9216 N=4608, int32-out mode, wgmma body", "phase 8"),
        ("qgemm_w4a8/gacc_decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:161", ("qgemm_w4a8/gacc_decode", 4, 9216),
         "M=4 K=9216 N=4608 g128 (starcoder2 down at tp=2), group-acc mode, split-K decode "
         "body", "phase 8"),
        ("qgemm_w4a8/gacc_wgmma", "src/repro_torch/csrc/qgemm_wgmma.cu",
         "src/repro/kernels/qgemm.py:161", ("qgemm_w4a8/gacc_wgmma", 2048, 9216),
         "M=2048 K=9216 N=4608 g128, group-acc mode, wgmma body", "phase 8"),
        ("act_quantize/experts_given_rows", "src/repro_torch/csrc/act_quantize.cu",
         "src/repro/kernels/act_quantize.py:29", ("act_quantize/experts_given_rows", 40, 8, 256),
         "E=40 C=8 K=256 bf16 (granite down at expert_tp tp=2), expert-batched given-max "
         "mode, rows body", "phase 8"),
        ("qgemm_w8a8/experts_i32_decode", "src/repro_torch/csrc/qgemm_decode.cu",
         "src/repro/kernels/qgemm.py:37", ("qgemm_w8a8/experts_i32_decode", 40, 8, 256, 1536),
         "E=40 C=8 K=256 N=1536 (granite down at expert_tp tp=2), expert-batched int32-out "
         "mode, split-K decode body", "phase 8"),
    ]
    kernels = []
    for name, source, replaces, key, shape, counted in kernel_rows:
        r = results[key]
        counts = ({**launches, **body_launches} if counted == "phase 4"
                  else p8_bodies if counted == "phase 8"
                  else {**p5_launches, **p5_bodies})
        n_launch = counts[name]
        check(n_launch > 0, f"{name}: no launch in {counted}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": n_launch,
                        "launches_in": counted + (" rank 0" if counted == "phase 8" else ""),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape,
                        **{k: r[k] for k in ("library", "body_ms", "gb_s", "f32_body_ms",
                                             "k2_ms", "n3360_decode_ms", "n3360_wgmma_ms",
                                             "own_body_ms")
                           if r.get(k) is not None}})
    print("[end] e2e tok/s " + "; ".join(f"{k}={v:.1f}" for k, v in e2e.items())
          + f"; total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--only kernel,quant,times,...]

Phases, in order; any failed check raises and the script exits non-zero
without printing a result:

1. card   — the card's name and power limit, torch and CUDA versions;
2. build  — nvcc builds every kernel from the sources in this checkout
            and prints the -Xptxas -v report;
3. kernel — fused_cold_ffn against its plain PyTorch version on the card
            (ids identical but for fp64-confirmed near ties; y within
            2e-4 in fp32, 5e-2 in bf16, the reference's tolerances), at
            the main path's shapes and past them: B up to 300, D = 200
            and 203, Bp at an odd column offset, exact ties between
            clusters (duplicate Bp column blocks; ids identical), two
            runs bit-identical;
   quant  — the same for its quant mode (int8 and int4-mixed codes; ids
            identical);
   times  — fused_cold_ffn at the main path's shapes, B 1/4/32, fp,
            int8 and int4-mixed: CUDA-event time per call, the same in
            one CUDA graph, each of its four kernels' device time per
            call (torch.profiler, which must see exactly those four),
            the plain version, the card's bound for the call and for
            gate_up;
   gather — cluster_gather_ffn and dense_ffn against their plain
            versions (the reference's sweep, B up to 300, N = 1472 that
            512 does not divide); then, at the full-width shapes, B 1/32/300
            with the weights L2-cold (each call reads the next of enough
            weight copies that 64 MB pass between two uses of one): time
            per call, the same in one CUDA graph, each launch's device time
            (torch.profiler, which must see exactly gate_up and down), the
            plain version, the port's torch.matmul composition of the same
            FFN eagerly and in a graph over the same copies, and the bound
            (a share of it above 100% fails as a fault of the harness);
4. serve  — build_engine("smollm-135m", reduced=False, backend="pallas")
            serves a staggered stream of 4 greedy requests at full width
            (30 layers, bf16) through the kernel, crossing the bucket
            ladder up and down, then a Best-of-N generate() whose batch
            decays 4 -> 1; twice, with one CUDA graph per decode bucket
            (the default) and eagerly (cuda_graphs=False): tokens,
            per-step cluster ids and every TokenStats field must be
            identical between the two, the launch count 30 per decode
            step in both, and the profiler must see fused_cold_ffn's four
            kernels per layer and step in both; each run reports its wall
            per step, its device time per step (torch.profiler; for the
            graphs also CUDA events around the replays), kernels per step
            and the storage plane's host time; at fp16, the KV arena's
            rows and bytes and the peak device memory of generate() at B
            1, 4 and 64 at ctx_budget 2048; then the same at storage
            dtypes int8 and int4-mixed through the kernel's quant mode;
5. parity — the same stream at full width in fp32 (4 layers) under the
            "pallas" and "jnp" backends: identical tokens, TokenStats
            and traces, at fp16, int8 and int4-mixed storage, then
            bamboo-7b (relu mode, relu2, D 4096) at fp16 storage;
6. api    — the kernel API at full width: over every layer of the model,
            dense_ffn against its plain version and
            cluster_gather_ffn_grouped over the clusters fused_cold_ffn
            picked (relu mode) against fused_cold_ffn's output;
   fleet  — smollm-135m at full width, graphed: ServeEngine(dp=2) serves
            a staggered stream of 8 greedy requests with the tokens of
            two independent dp=1 engines fed the routed streams, each
            replica's graphs over its own buffers and pool, 30 launches
            per replica step, a cancel on replica 1 that frees its slot;
            then build_fleet(n=2) behind FleetGateway with backend 1 lost
            mid-stream and restored: every request completes, a
            resubmitted prompt is a response-LRU hit, and the run equals
            the same run eagerly in tokens, per-backend completions and
            FleetReport; wall per step, modeled span rate and peak
            device memory against dp=1;
   archs  — qwen2-vl-2b (vlm, 28 layers), bamboo-7b (relu mode, 32
            layers) and qwen3-14b (qk-norm, cut to 8 of 40 layers) at
            full width, bf16: phase 4's stream graphed and eagerly
            (identical tokens, ids and TokenStats; L launches per step;
            the profiler's four kernels per layer and step), then
            fused_cold_ffn on layer 0's weights and x from the serve at
            B 1/4/32 against its plain version, and its time per call in
            a CUDA graph beside its bound;
   vlm    — models/vlm.py at qwen2-vl-2b full width: M-RoPE prefill of
            1,024 patch embeddings and 16 text tokens, 8 decode steps
            under the kernel and under the plain chain: finite logits,
            28 launches per step, identical ids but for near ties;
   moe    — the moe family at full width, bf16, no kernel on its path:
            deepseek-moe-16b (whole experts, cut to 2 of 28 layers) at
            fp16 and int8 storage and turbosparse-mixtral-47b (relu
            mode, cut to 1 of 32 layers) on the PHONE plan and on a
            two-level plan (a 100 ms prefetch window: n_expert_hot 128,
            the (L, E, 1+ncc) trace) serve phase 4's stream graphed and
            eagerly: tokens, traces and TokenStats identical, no
            fused_cold_ffn launch; wall, device busy, replay span,
            kernels, storage plane ms per step and peak memory; layer
            0's apply_moe_ffn in fp32 on the card against the CPU at B
            1/4/32 and 64 rows past capacity, dead rows included; a
            pallas engine on a moe config raises;
   plan   — the offline planner's loop at full width, bf16: smollm-135m
            (30 layers) and bamboo-7b (relu mode, cut to 8 of 32 layers)
            profile four (4, 64) batches of the synthetic corpus on the
            card, predictor_quality before and after
            calibrate_predictor (fp64 ridge solve and rank-r truncation
            on the card; recall must rise), ffn_dense and the n_hot = 0
            ffn_hybrid on the reference bench's two plan legs at B 1..32
            (in a CUDA graph) timed into a KernelCalibration whose source
            is the card line, the plan on calibration.hardware(PHONE)
            (identical to PHONE's), each cold call's fused_cold_ffn held
            against its plain version (ids identical; y within the bf16
            tolerance plus `rounding_allowance`, since relu2 on random
            weights gives |y| up to 1e7 and sums that cancel, where one
            bf16 rounding of h moves y by hundreds); layer 0 in fp32 on
            the card against the CPU: counts identical but for
            near-threshold pairs, X within 1e-5 of its scale, the
            calibrated A@B within 1e-6 of a numpy fp64 recompute; then
            permute, and phase 4's
            stream graphed and eagerly (tokens, ids and TokenStats
            identical, L launches in each step whose bucket keeps a cold
            path: on random weights smollm's profiled plan is all hot at
            B >= 2): walls, busy time, and the modeled tok/s of the
            recorded steps repriced under both profiles (the calibrated
            repricing must give the serve's own TokenStats); then
            fused_cold_ffn on layer 0 and x from the serve at each bucket
            that keeps a cold path, against its plain version (the same
            allowance), with its time in a CUDA graph, the plain time and
            the bound;
   tp     — tensor, expert and data parallelism on four gloo ranks that
            share the card (repro_torch.parallel.spawn; NCCL refuses two
            ranks on one device, so no multi-GPU speed is measured), the
            golden's plan of groups=4 scaled per bucket, phase 4's
            stream, eager (gloo collectives cannot be captured), each
            rank building the same seeded weights and keeping its slice:
            smollm-135m in fp32 (4 layers) at tp 1, 2 and 4: tokens, ids
            and TokenStats identical to tp=1 (its trace repriced at n
            shards), effective time within 1.01x; smollm-135m in bf16 (30
            layers) at tp 1, 2 and 4: every (step, layer)'s gathered ids
            equal the unsharded selection on the same x but for near
            ties, 30 fused_cold_ffn launches per step on every rank, and
            layer 0's per-rank kernel over its g_loc groups held against
            its plain version at B 1/4/32 and timed (the ranks in turn);
            bamboo-7b (4 layers; 32 heads, 8 kv heads: attention
            head-sharded, a KV arena of 4 kv heads per rank) at tp 2
            against tp=1, in fp32 as smollm's fp32 and in bf16 as
            smollm's bf16 (its per-rank kernel at D 4096 held with the
            rounding allowance, as phase plan holds relu2);
            deepseek-moe-16b in fp32 (4 layers) at ep=2 against ep=1:
            tokens, traces and TokenStats, no kernel launch; dp=2 x tp=2
            against dp=2 on one rank: tokens; per rank the wall per
            step, the collectives per step and their time (a spy on the
            group's collectives, the card synchronized around each), the
            FFN rows held, the embedding's and head's vocab share (split
            over the ranks), the weights and the serve's peak memory;
   tptrain — training over ranks and grok-1-314b's experts split by
            neurons, on four gloo ranks sharing the card (as phase tp):
            one fp32 train step of smollm-135m at full width (2 layers)
            at dp=2 x tp=2 against one rank from the same seeded weights
            (each rank drawing them leaf by leaf) and batch (loss within
            1e-5 relative, every gathered gradient leaf within 1e-4 of
            its max |g|); 10 steps of launch.train's recipe at full
            width (16 layers, bf16, remat) at dp=2 x tp=2 against one
            rank (each loss within 2e-2 relative, finite, the last below
            the first; per rank the wall and collectives per step, the
            weights, the vocab share, peak memory), then gather_params,
            save_checkpoint and load_checkpoint bit for bit;
            grok-1-314b at full width (D 6144, 8 experts of d_ff 32,768,
            vocab 131,072), its depth cut to 1 layer in fp32 and 2 in
            bf16, at tp=4 against tp=1 on rank 0: phase 4's stream
            eagerly (fp32: tokens, traces and TokenStats identical, the
            tp=1 trace repriced at 4 shards; bf16: agreement counted),
            every layer's apply_moe_ffn on the x of the first steps held
            against tp=1 on the same x (counts identical), no
            fused_cold_ffn launch; per rank the weights, host RSS and card
            peaks, wall and collectives per step;
   train  — the training path: one fp32 train step (LM loss, autograd,
            AdamW) of reduced smollm-135m, deepseek-moe-16b and
            qwen2-vl-2b on the card against the same step on the CPU
            from the same weights and batch (TF32 off; loss within 1e-5
            relative, every gradient leaf within 1e-4 of its max |g|);
            smollm-135m at full width (30 layers, bf16, remat) trained
            40 steps by launch.train.train() on the synthetic corpus with
            the reference bench's recipe (AdamW lr 2e-3, batch 4, seq
            64): finite losses, the last below 0.8x the first, no kernel
            launch, wall per step, tokens/s, peak memory, model FLOPs
            over the bf16 peak; save_checkpoint then load_checkpoint bit
            for bit; the step's forward / backward / optimizer split
            (CUDA events); then the reference bench's engine_setup on the
            loaded model (calibrate_predictor, profile_activations,
            build_plan on PHONE, whose budgets are printed, then the
            pinned make_plan(d_ff, 0.125, 0.10, cs) per bucket and the
            permutation) and phase 4's stream graphed and eagerly
            (tokens, ids and TokenStats identical, 30 fused_cold_ffn
            launches per step), then the kernel on layer 0 and x from the
            serve against its plain version and timed at every bucket;
   families — the ssm, hybrid and encdec families through build_model's
            uniform API (forward, prefill, decode_step) at full width,
            bf16, seeded random weights: mamba2-130m (24 layers),
            recurrentgemma-9b (38 layers) and seamless-m4t-large-v2 (24
            encoder and 24 decoder layers over 4,096 frames), one prefill
            (2,048 tokens, which fill recurrentgemma's local ring; 256
            for seamless) then 16 greedy decode steps at B 1 and 4 under
            make_plan(d_ff, 0.4, 0.2, 128, backend "pallas"): finite
            logits, fused_cold_ffn launched once per FFN layer and step
            (38, 24, 0) and never in the prefill, the ring wrapped;
            prefill time, wall per step, peak memory, device busy per
            step (torch.profiler over 3 more steps); the kernel on layer
            0's weights (geglu R=3 D 4096; gelu R=2 D 1024) and x from the
            decode at B 1/4/32 against its plain version with the
            rounding allowance (which covers CATS gates at zero), timed in
            a CUDA graph beside its bound; prefill + decode equal forward
            in fp32 at full width cut in depth (recurrentgemma across its
            ring's wrap); one fp32 train step of each reduced config,
            card against CPU;
   famtp  — the ssm, hybrid and encdec families over four gloo ranks
            sharing the card (as phase tp), bf16 unless marked, widths
            whole: mamba2-130m whole (24 layers), prefill 64 tokens then
            16 greedy decode steps at B 2 at tp 2 and 4 against tp=1 (fp32:
            tokens identical, logits within 1e-5 of max |logit|; bf16:
            each layer's prefill output on the same x within 1e-2 of max
            |y|; no kernel launch); recurrentgemma-9b at tp=4 and
            seamless-m4t-large-v2 at tp 2 and 4 under make_plan's "pallas"
            plan of groups=4, fused_cold_ffn once per FFN layer and decode
            step on every rank: in fp32 (one rec, rec, attn group; 2
            encoder and 2 decoder layers) tokens and every step's gathered
            ids identical to tp=1's, logits within 1e-5 of max |logit|;
            in bf16 (6 of 38 layers, two whole groups; 4 encoder and 4
            decoder layers)
            each layer's prefill output on the same x within 1e-2 of max
            |y| of the whole model's, the prefill logits' distance and the
            token agreement with tp=1 reported,
            every (step, layer)'s gathered ids against the unsharded
            selection on the same x (near ties aside), layer 0's per-rank
            kernel against its plain version at B 1/4/32 on the rank's
            weights and x from the decode, timed in a CUDA graph beside its
            bound; mamba2-130m training at dp=2 x tp=2 against one rank:
            one fp32 step (loss within 1e-6 relative, gathered gradients
            within 1e-4 of max |g|, the worst printed beside one rank's own
            noise on the batch with its rows reversed), then 10 bf16 steps
            of launch.train's loop at its own recipe (lr 1e-3, batch 8,
            seq 128; losses within 1e-2, the last below the first); per rank
            the wall and collectives per step and the weights;
   examples — the four examples of examples_torch/ (quickstart,
            best_of_n, offloaded_serving, plan_and_inspect) on the card at
            the reference examples' reduced sizes: each finishes, and
            best-of-N's batch timeline decays 4 -> 1;
   analyze — the analysis gate's card tier: the dispatch tier of
            repro_torch.analysis on the card under torch.cuda's sync
            debug mode (graphed steps: no sync, no host read, no
            host-to-device copy), each source's ptxas registers, static
            smem (equal to the smem-budget estimate) and spills, and
            compute-sanitizer's racecheck over fused_cold_ffn (where the
            tool answers "Device not supported" the phase says so and
            checks nothing; any other early end fails);
7. summary — a JSON line of every kernel, then {"ok": true, ...}.

`--only` runs the card and build phases and then the named ones, and
prints no summary and no result line (to time another tree's kernels:
copy this file into its root and run `--only times` or `--only gather`
there; a tree whose fused_cold_ffn launches other kernels than these four
is timed with its own copy of this script, and a tree without
ops.gather_plan has its gather kernels timed without the name check). It
imports the port only (never jax or the JAX package) and runs on the card only:
without one it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.adaptation import bucket_for  # noqa: E402
from repro_torch.core.baselines import POWERINFER2  # noqa: E402
from repro_torch.core.clusters import (  # noqa: E402
    make_plan, scale_plan_for_batch)
from repro_torch.core.io_model import KernelCalibration  # noqa: E402
from repro_torch.core.planner import (  # noqa: E402
    PHONE, build_plan, calibrate_predictor, predictor_quality,
    profile_activations, profile_ffn_inputs)
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, SyntheticTokens, shard_batch)
from repro_torch.kernels import build as kbuild, ops, registry  # noqa: E402
from repro_torch.core.sparse_ffn import (  # noqa: E402
    _apply_bundle, ffn_dense, ffn_hybrid)
from repro_torch.kernels.ref import (  # noqa: E402
    GATE_REL, cats_zero_gates, cluster_gather_ffn_ref, dense_ffn_ref,
    fused_cold_ffn_ref, near_threshold, pick_disagreements)
from repro_torch.launch.serve import (  # noqa: E402
    build_engine, profile_batches)
from repro_torch.launch.train import add_modal_inputs  # noqa: E402
from repro_torch.models.model import build_model, wrap  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    loss_and_grads, make_loss_fn, make_train_step)
from repro_torch.bridge import (  # noqa: E402
    gather_params, load_checkpoint, params_from_numpy, params_to_numpy)
from repro_torch.checkpoint.ckpt import save_checkpoint  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    activation_fn, dtype_of, rms_norm)
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.quant.storage import quantize_bundles  # noqa: E402
from repro_torch.serving.families import serving_family  # noqa: E402
from repro_torch.serving.storage_plane import StoragePlane  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
# main-path shapes of smollm-135m's cold path (planner: n_hot 64, 23 cold
# clusters of 64, kc 1)
MAIN = dict(D=576, r=64, cs=64, G=1, nc_g=23, R=3, kc=1, act="silu",
            mode="cats")
# the serve phase's stream: (prompt length, arrival step)
STREAM = [(16, 0), (16, 0), (32, 3), (24, 6)]
MAX_NEW = 16
CTX = 64                           # KV slots per request: 32 + 16 fit
QUANT = ("int8", "int4-mixed")
# gather/dense timing shapes: one full-width FFN layer (N = d_ff)
GATHER = dict(D=576, N=1536, R=3, cs=64, n_ids=12, act="silu")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# ----------------------------------------------------------- phase 3 ----

TIE_PERIOD = 3    # tied inputs: cluster c's Bp columns copy cluster c % 3's


def tie_columns(bp, G, nc_g, cs):
    """Copy, in every group, cluster c % TIE_PERIOD's Bp column block into
    cluster c's (bp is (r, G*nc_g*cs) numpy): the copies' scores are the
    same sums of the same products, so they tie exactly and the lowest id
    must win each tie."""
    blocks = bp.reshape(bp.shape[0], G, nc_g, cs)
    src = np.arange(nc_g) % TIE_PERIOD
    return blocks[:, :, src].reshape(bp.shape)


def kernel_inputs(B, D, r, cs, G, nc_g, R, dtype, seed, bp_offset=0,
                  ties=False):
    """x, wc, A and Bp; with `bp_offset` > 0, Bp is the column slice
    [:, bp_offset:] of a wider predictor (the engine's layout), so its
    rows start where a 16-byte vector load would not; `ties` makes the
    clusters tie exactly (tie_columns)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    bp = rng.standard_normal((r, bp_offset + G * nc_g * cs)) / np.sqrt(r)
    if ties:
        bp[:, bp_offset:] = tie_columns(bp[:, bp_offset:], G, nc_g, cs)
    return (t(rng.standard_normal((B, D)) * 0.5),
            t(rng.standard_normal((G, nc_g, cs, R, D)) * 0.1),
            t(rng.standard_normal((D, r)) / np.sqrt(D)),
            t(bp)[:, bp_offset:])


def check_case(name, B, dtype, mask_kind="live", seed=0, sd=None,
               bp_offset=0, repeat=False, ties=False, **over):
    """One fused_cold_ffn case against its plain version; `sd` (int8 or
    int4-mixed) runs the quant mode on the codes of the same weights,
    where the ids must be identical, as they must with `ties` (exact
    ties between clusters). `repeat` also runs the kernel a second time
    and requires the same bits."""
    s = dict(MAIN, **over)
    x, wc, A, Bp = kernel_inputs(B, s["D"], s["r"], s["cs"], s["G"],
                                 s["nc_g"], s["R"], dtype, seed, bp_offset,
                                 ties)
    quant = {} if sd is None else quantize_bundles(wc, sd)
    mask = torch.ones(B, dtype=torch.bool, device="cuda")
    if mask_kind == "some":
        mask[1::2] = False
    elif mask_kind == "none":
        mask[:] = False
    return hold_kernel(name, x, wc, A, Bp, mask, s["act"], s["mode"],
                       s["kc"], quant, repeat=repeat,
                       exact=sd is not None or ties, ties=ties)


def rounding_allowance(x, wc, A, Bp, idx, act, mode):
    """(B, D) fp64: how far two fp32 implementations of the picked FFN
    (fused_cold_ffn_ref's chain: fp32 gate/up dots, h rounded to the
    weight dtype, an fp32 down dot) may differ at each output, from fp64
    on the same picks. Each dot lies within GATE_REL * sum|x w| of its
    fp64 value; h over that box (four corners, widened by four fp32
    roundings) rounds to the weight dtype within [rnd(lo), rnd(hi)], so
    the two h may differ by rnd(hi) - rnd(lo). In CATS mode a gate that
    `cats_zero_gates` flags may keep h in one and drop it in the other.
    The down dots add K exact products (h and Wd in the weight dtype) in
    fp32, each within gamma_K = K u / (1 - K u) (u = 2**-24) of the sum
    of their magnitudes. Returns sum_k dh_k |Wd_kd| + 2 gamma_K
    sum_k |h_k Wd_kd|."""
    G, nc_g, cs, R, D = wc.shape
    groups = torch.arange(G, device=x.device)[:, None]
    wsel = wc[groups, idx.long()].reshape(-1, R, D).double()
    xd = x.double()

    def box(j):
        v = xd @ wsel[:, j].T
        e = GATE_REL * (xd.abs() @ wsel[:, j].abs().T)
        return v - e, v + e
    f = activation_fn(act)
    g = box(0)
    a = torch.stack([f(g[0]), f(g[1])])
    u = torch.stack(box(1)) if R == 3 else torch.ones_like(a)
    hs = (a[:, None] * u[None, :]).flatten(0, 1)
    widen = 4 * 2.0 ** -24 * hs.abs().amax(0)
    lo = (hs.amin(0) - widen).to(wc.dtype).double()
    hi = (hs.amax(0) + widen).to(wc.dtype).double()
    dh, h = hi - lo, torch.maximum(lo.abs(), hi.abs())
    if mode == "cats":
        cols = (idx.long() + torch.arange(G, device=x.device)[:, None]
                * nc_g)[:, :, None] * cs + torch.arange(cs, device=x.device)
        keep = ((xd @ A.double()) @ Bp.double()[:, cols.reshape(-1)]) > 0
        for b, k in cats_zero_gates(idx, x, wc, A, Bp).tolist():
            keep[b, k] = True
            dh[b, k] = h[b, k]
        dh, h = dh * keep, h * keep
    K = wsel.shape[0]
    gamma = K * 2.0 ** -24 / (1 - K * 2.0 ** -24)
    wd = wsel[:, -1].abs()
    return dh @ wd + 2 * gamma * (h @ wd)


def hold_kernel(name, x, wc, A, Bp, mask, act, mode, kc, quant=None,
                repeat=False, exact=False, ties=False, rounding=False):
    """fused_cold_ffn on the given inputs against its plain version: ids
    identical but for fp64-confirmed near ties (none at all when
    `exact`), y within the reference's tolerance; with `rounding` (fp
    path only), within it plus `rounding_allowance`, the most two fp32
    implementations may differ by at the outputs of the same picks.
    Returns max |y - plain| (0.0 when a near tie leaves y not
    compared)."""
    quant = quant or {}
    dtype = x.dtype
    run = lambda: ops.fused_cold_ffn(x, wc, A, Bp, activation=act,
                                     mode=mode, kc=kc, active_mask=mask,
                                     **quant)
    y, idx = run()
    if repeat:
        y2, idx2 = run()
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(idx, idx2)):
            raise AssertionError(f"{name}: two runs differ")
    torch.cuda.synchronize()
    yr, ir = fused_cold_ffn_ref(x, wc, A, Bp, mask.float(),
                                activation=act, cats=mode == "cats", kc=kc,
                                **quant)
    near, real = pick_disagreements(idx, ir, x, wc, A, Bp, mask.float())
    if real or (exact and near):
        raise AssertionError(f"{name}: picks differ: {real or near}")
    dead = not bool(mask.any())
    if ties and kc > 1 and not dead:
        first = ir[:, :2].tolist()    # the top cluster and its lowest twin
        if any(b - a != TIE_PERIOD for a, b in first):
            raise AssertionError(f"{name}: no exact tie at the top: {first}")
    if dead and idx.tolist() != [list(range(kc))] * wc.shape[0]:
        raise AssertionError(f"{name}: all-dead batch picked {idx.tolist()}")
    err = float((y - yr).abs().max())
    if near:
        print(f"  {name}: near-tie picks (g, k, kernel, plain) {near}; "
              f"y not compared")
        return 0.0
    tol = TOL[dtype]
    if not rounding:
        if not torch.allclose(y, yr, atol=tol, rtol=tol):
            raise AssertionError(f"{name}: max |y - plain| = {err} over tol "
                                 f"{tol}")
        print(f"  {name}: ids identical"
              f"{', two runs bit-identical' if repeat else ''}"
              f", max |y - plain| = {err:.3e} (tol {tol})")
        return err
    if quant:
        raise ValueError("rounding_allowance covers the fp path only")
    d = (y - yr).abs().double()
    slack = tol + tol * yr.abs().double()
    allow = rounding_allowance(x, wc, A, Bp, ir, act, mode)
    ratio = float((d / (slack + allow)).max())
    if ratio > 1.0:
        raise AssertionError(f"{name}: max |y - plain| = {err}, "
                             f"{ratio:.3g}x past tol {tol} plus the rounding "
                             f"allowance")
    print(f"  {name}: ids identical, max |y - plain| = {err:.3e} (max |y| "
          f"{float(yr.abs().max()):.3e}); {int((d > slack).sum())} of "
          f"{d.numel()} outputs past tol {tol} alone, all within it plus "
          f"the rounding allowance (at most {ratio:.3g} of it)")
    return err


def edge_cases(sd=None):
    """The cases beyond the main path's shapes, in the fp mode (sd None)
    or a quant mode: B past 64, D whose rows are not 16-byte multiples
    (200; 203, odd), Bp at an odd column offset, and two runs at B = 32
    that must agree bit for bit."""
    bf16, tag = torch.bfloat16, "" if sd is None else f"{sd} "
    errs = [check_case(f"{tag}B={B} bf16", B, bf16, seed=B, sd=sd)
            for B in (17, 65, 128, 300)]
    for D in (200, 203):
        errs.append(check_case(f"{tag}D={D} bf16", 16, bf16, D=D, kc=2,
                               seed=D, sd=sd))
    errs.append(check_case(f"{tag}Bp at column offset 65", 8, bf16,
                           bp_offset=65, kc=2, seed=65, sd=sd))
    errs.append(check_case(f"{tag}repeat B=32", 32, bf16, seed=32, sd=sd,
                           repeat=True))
    for B, G, kc in ((1, 1, 2), (32, 3, 2), (32, 1, 23), (1, 3, 23)):
        errs.append(check_case(f"{tag}ties B={B} G={G} kc={kc}", B, bf16,
                               seed=70 + B, sd=sd, ties=True, G=G, kc=kc))
    return errs


def rotated_ms(fn, n, iters=200, warmup=20):
    """CUDA-event time per call of fn(i % n), i = 0, 1, ...: with n weight
    copies, each call reads the next, so no copy is in L2 again when its
    turn comes (n = 1: back to back)."""
    for i in range(warmup):
        fn(i % n)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotated_graph_ms(fn, n, iters=200):
    """Device time per call with launch overhead removed: the same calls
    captured in one CUDA graph, replayed once and timed with events."""
    for i in range(n):                     # warm up outside the capture
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i % n)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / iters


def cuda_time_ms(fn) -> float:
    return rotated_ms(lambda i: fn(), 1)


def graph_time_ms(fn) -> float:
    return rotated_graph_ms(lambda i: fn(), 1)


def roofline(nbytes, ops_, dtype):
    """(ms, what bounds it): the larger of bytes over the card's memory
    rate and operations over its peak rate for the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(B, dtype, sd=None, s=MAIN):
    """Least time for one call at shapes `s` (default the main path's):
    every input byte the call needs read once (the kc picked bundles,
    not the whole cold tensor: fp weights, or int8 codes with fp32 row
    scales and, for int4-mixed, the fp16 sidecar), every output byte
    written once, against the card's memory rate; its operations against
    the peak rate for the type."""
    es = torch.empty((), dtype=dtype).element_size()
    Nc = s["G"] * s["nc_g"] * s["cs"]
    K = s["G"] * s["kc"] * s["cs"]
    w_bytes = {None: es, "int8": 1, "int4-mixed": 1 + 2}[sd] \
        * K * s["R"] * s["D"] + (0 if sd is None else 4 * K * s["R"])
    nbytes = (es * (B * s["D"] + s["D"] * s["r"] + s["r"] * Nc) + w_bytes
              + 4 * B + 4 * B * s["D"] + 4 * s["G"] * s["kc"])
    ops_ = 2 * B * (s["D"] * s["r"] + s["r"] * Nc + K * s["R"] * s["D"])
    return roofline(nbytes, ops_, dtype)


def gate_up_bound(B, dtype, sd=None):
    """Least time for gate_up with its selection at the main path's
    shapes: the picked neurons' gate and up rows (fp weights, or codes
    with their row scales and, for int4-mixed, the sidecar), x, the tile
    maxima, the CATS scores of the picked columns, read once; H and the
    ids written once; the gate and up products."""
    s = MAIN
    es = torch.empty((), dtype=dtype).element_size()
    K = s["G"] * s["kc"] * s["cs"]
    rows = 2 * K                               # gate and up of each neuron
    w_bytes = {None: es, "int8": 1, "int4-mixed": 1 + 2}[sd] * rows * s["D"] \
        + (0 if sd is None else 4 * rows)
    n_chunks = -(-B // 8)
    nbytes = (w_bytes + es * B * s["D"] + 4 * n_chunks * s["G"] * s["nc_g"]
              + 4 * B * K + es * B * K + 4 * s["G"] * s["kc"])
    return roofline(nbytes, 2 * B * rows * s["D"], dtype)


def phase_kernel():
    print("== phase 3: fused_cold_ffn against its plain version")
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    for B in (1, 4, 32, 64):
        errs.append(check_case(f"main B={B} bf16", B, bf16, seed=B))
    errs.append(check_case("kc=4", 8, bf16, kc=4, seed=11))
    errs.append(check_case("kc=23", 8, bf16, kc=23, seed=12))
    errs.append(check_case("G=2", 16, bf16, G=2, nc_g=11, kc=3, seed=13))
    errs.append(check_case("fp32", 16, f32, kc=2, seed=14))
    errs.append(check_case("R=2 gelu", 5, f32, R=2, act="gelu", D=200,
                           r=16, cs=32, nc_g=5, G=2, kc=2, seed=15))
    errs.append(check_case("relu mode relu2", 7, bf16, act="relu2",
                           mode="relu", kc=3, seed=16))
    errs.append(check_case("dead rows", 8, bf16, mask_kind="some", kc=4,
                           seed=17))
    errs.append(check_case("all rows dead", 8, bf16, mask_kind="none",
                           kc=4, seed=18))
    errs += edge_cases()
    return max(errs)


def phase_quant():
    print("== phase 3 (quant): fused_cold_ffn quant mode against its "
          "plain version")
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    for sd in QUANT:
        for B in (1, 4, 32, 64):
            errs.append(check_case(f"{sd} B={B} bf16", B, bf16, seed=B,
                                   sd=sd))
        errs.append(check_case(f"{sd} kc=4", 8, bf16, kc=4, seed=11, sd=sd))
        errs.append(check_case(f"{sd} kc=23", 8, bf16, kc=23, seed=12,
                               sd=sd))
        errs.append(check_case(f"{sd} G=2", 16, bf16, G=2, nc_g=11, kc=3,
                               seed=13, sd=sd))
        errs.append(check_case(f"{sd} fp32", 16, f32, kc=2, seed=14, sd=sd))
        errs.append(check_case(f"{sd} R=2 gelu", 5, f32, R=2, act="gelu",
                               D=200, r=16, cs=32, nc_g=5, G=2, kc=2,
                               seed=15, sd=sd))
        errs.append(check_case(f"{sd} dead rows", 8, bf16, mask_kind="some",
                               kc=4, seed=17, sd=sd))
        errs.append(check_case(f"{sd} all rows dead", 8, bf16,
                               mask_kind="none", kc=4, seed=18, sd=sd))
        errs += edge_cases(sd)
    return max(errs)


SUBKERNELS = ("hidden_kernel", "score_kernel", "gate_up_kernel",
              "down_kernel")
OWN = "(anonymous namespace)::"    # how the profiler names the port's kernels


def own_kernel_us(fn, n=1, iters=200):
    """Device time per call (us) of each kernel of the port's sources that
    `iters` calls of fn(i % n) launch, by torch.profiler, keyed by the
    kernel's name; None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n)
        torch.cuda.synchronize()
    out, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += e.self_device_time_total
        if OWN in e.key:
            name = re.split(r"[<(]", e.key.split(OWN, 1)[1])[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters
    return out if busy else None


def subkernel_us(fn):
    """Device time per call (us) of each of fused_cold_ffn's four kernels;
    None when the profiler saw no device time. Raises if it saw a kernel
    of the port's sources that is not one of the four, or missed one."""
    out = own_kernel_us(lambda i: fn())
    if out is None:
        return None
    if set(out) != set(SUBKERNELS):
        raise AssertionError(f"fused_cold_ffn launched {sorted(out)}, "
                             f"expected {SUBKERNELS}")
    return {k: out[k] for k in SUBKERNELS}


def phase_times():
    """fused_cold_ffn at the main path's shapes, bf16, B 1/4/32, in the fp
    mode and both quant modes: time per call (CUDA events over 200
    calls), the same calls in one CUDA graph, each of the four kernels'
    device time per call (torch.profiler), the plain version's time and
    the card's bound for the call and for gate_up. Keys: (storage dtype,
    B)."""
    print("== phase 3 (times): fused_cold_ffn per call and per kernel")
    bf16, timings = torch.bfloat16, {}
    for sd in ("fp16",) + QUANT:
        for B in (1, 4, 32):
            x, wc, A, Bp = kernel_inputs(
                B, MAIN["D"], MAIN["r"], MAIN["cs"], MAIN["G"], MAIN["nc_g"],
                MAIN["R"], bf16, seed=100 + B)
            q = {} if sd == "fp16" else quantize_bundles(wc, sd)
            mask = torch.ones(B, device="cuda")
            kern = lambda: ops.fused_cold_ffn(x, wc, A, Bp, activation="silu",
                                              mode="cats", kc=1, **q)
            plain = lambda: fused_cold_ffn_ref(x, wc, A, Bp, mask,
                                               activation="silu", cats=True,
                                               kc=1, **q)
            ms, dev_ms = cuda_time_ms(kern), graph_time_ms(kern)
            sub = subkernel_us(kern)
            plain_ms = cuda_time_ms(plain)
            b_ms, b_by = bound(B, bf16, None if sd == "fp16" else sd)
            gu_ms, gu_by = gate_up_bound(B, bf16, None if sd == "fp16" else sd)
            timings[(sd, B)] = dict(ms=ms, graph_ms=dev_ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, subkernel_us=sub,
                                    gate_up_bound_ms=gu_ms)
            parts = "not measured (no CUDA events)" if sub is None else \
                ", ".join(f"{k.removesuffix('_kernel')} {v:.2f}"
                          for k, v in sub.items()) + " us"
            print(f"  {sd} B={B:2d} bf16: kernel {ms * 1e3:.2f} us/call "
                  f"({dev_ms * 1e3:.2f} us in a CUDA graph), plain "
                  f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
                  f"({b_by})")
            print(f"    per call: {parts}; gate_up's bound "
                  f"{gu_ms * 1e3:.3f} us ({gu_by})")
    return timings


def check_gather(B, D, N, R, cs, act, dtype, seed=0):
    """cluster_gather_ffn over half the clusters and dense_ffn over all N
    against their plain versions. Returns the larger max |error|."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    x = t(rng.standard_normal((B, D)) * 0.5)
    w = t(rng.standard_normal((N, R, D)) * 0.1)
    n_clusters = N // cs
    idx = torch.from_numpy(rng.permutation(n_clusters)[
        :max(1, n_clusters // 2)].astype(np.int32)).cuda()
    y = ops.cluster_gather_ffn(x, w, idx, activation=act, cluster_size=cs)
    yd = ops.dense_ffn(x, w, activation=act)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err = 0.0
    for name, a, b in (
            ("cluster_gather_ffn", y, cluster_gather_ffn_ref(
                x, w, idx, activation=act, cluster_size=cs)),
            ("dense_ffn", yd, dense_ffn_ref(x, w, activation=act))):
        if a.dtype != dtype or a.shape != (B, D):
            raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)}")
        a, b = a.float(), b.float()
        e = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=tol, rtol=tol):
            raise AssertionError(f"{name} B={B} D={D} N={N} R={R} {act} "
                                 f"{dtype}: max |y - plain| = {e}")
        err = max(err, e)
    return err


def gather_bound(B, n_neurons, ids, dtype):
    """Bytes: x, the n_neurons bundles read once, the ids, y; operations:
    the gate, up and down products."""
    s = GATHER
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = es * (2 * B * s["D"] + n_neurons * s["R"] * s["D"]) + 4 * ids
    return roofline(nbytes, 2 * B * n_neurons * s["R"] * s["D"], dtype)


def phase_gather():
    print("== phase 3 (gather): cluster_gather_ffn and dense_ffn against "
          "their plain versions")
    acts = [("silu", 3), ("relu2", 3), ("gelu", 2), ("geglu", 3)]
    shapes = [(1, 64, 256, 32), (4, 128, 512, 64), (8, 256, 1024, 128),
              (2, 384, 768, 128)]
    err, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for act, R in acts:
            for B, D, N, cs in shapes:
                err = max(err, check_gather(B, D, N, R, cs, act, dtype,
                                            seed=B * N + cs))
                n += 1
        for B in (1, 32, 300):
            for N in (1536, 1472):
                err = max(err, check_gather(B, 576, N, 3, 64, "silu", dtype,
                                            seed=B + N))
                n += 1
    print(f"  {n} cases (4 activations x 4 reference shapes, B 1/32/300 x "
          f"N 1536/1472, fp32 and bf16): max |y - plain| = {err:.3e}")

    return err, {B: gather_times(B) for B in GATHER_BATCHES}


GATHER_BATCHES = (1, 32, 300)
L2_COLD_BYTES = 64e6     # rotated weight copies per timing: > the 50 MB L2
# the kernels of one call; a tree without ops.gather_plan (an earlier
# design) is timed without this name check
GATHER_KERNELS = ("gather_gate_up_kernel", "gather_down_kernel")


def gather_times(B):
    """cluster_gather_ffn (12 of 24 clusters) and dense_ffn at the
    full-width shapes, bf16, with L2-cold weights: each call takes the
    next of enough weight copies that the calls between two uses of one
    copy read >= 64 MB. Per kernel: eager and CUDA-graph time per call,
    each launch's device time (torch.profiler), the plain version, the
    torch.matmul composition (_apply_bundle over the same rows) eager
    and in a graph, over the same copies, and the card's bound."""
    s, bf16 = GATHER, torch.bfloat16
    rng = np.random.default_rng(200 + B)
    x = torch.from_numpy(rng.standard_normal((B, s["D"])).astype(
        np.float32) * 0.5).to("cuda", bf16)
    idx = torch.from_numpy(rng.permutation(s["N"] // s["cs"])[
        :s["n_ids"]].astype(np.int32)).cuda()
    rows = (idx.long()[:, None] * s["cs"]
            + torch.arange(s["cs"], device="cuda")).reshape(-1)
    check_names = hasattr(ops, "gather_plan")
    out = {}
    for name, n_neurons in (("cluster_gather_ffn", s["n_ids"] * s["cs"]),
                            ("dense_ffn", s["N"])):
        read = n_neurons * s["R"] * s["D"] * 2
        n = int(np.ceil(L2_COLD_BYTES / read)) + 1
        w0 = torch.from_numpy(rng.standard_normal(
            (s["N"], s["R"], s["D"])).astype(np.float32) * 0.1).to("cuda", bf16)
        ws = [w0] + [w0.clone() for _ in range(n - 1)]    # n addresses
        if name == "dense_ffn":
            kern = lambda i: ops.dense_ffn(x, ws[i], activation="silu")
            comp = lambda i: _apply_bundle(ws[i], x, "silu")
            b_ms, b_by = gather_bound(B, s["N"], 0, bf16)
        else:
            kern = lambda i: ops.cluster_gather_ffn(
                x, ws[i], idx, activation="silu", cluster_size=s["cs"])
            comp = lambda i: _apply_bundle(ws[i][rows], x, "silu")
            b_ms, b_by = gather_bound(B, n_neurons, s["n_ids"], bf16)
        plain = (lambda: dense_ffn_ref(x, ws[0], activation="silu")) \
            if name == "dense_ffn" else (lambda: cluster_gather_ffn_ref(
                x, ws[0], idx, activation="silu", cluster_size=s["cs"]))
        t = dict(ms=rotated_ms(kern, n), graph_ms=rotated_graph_ms(kern, n),
                 kernel_us=own_kernel_us(kern, n),
                 plain_ms=cuda_time_ms(plain),
                 composition_ms=rotated_ms(comp, n),
                 composition_graph_ms=rotated_graph_ms(comp, n),
                 bound_ms=b_ms, bound_by=b_by, weight_copies=n)
        t["roofline_share"] = b_ms / t["graph_ms"]
        del ws, w0
        if t["roofline_share"] > 1.0:
            raise AssertionError(
                f"{name} B={B}: {t['graph_ms'] * 1e3:.3f} us in a graph beats "
                f"the bound {b_ms * 1e3:.3f} us: a fault of the timing "
                f"harness (weights not L2-cold), not a result")
        seen = t["kernel_us"]
        if check_names and seen is not None and set(seen) != set(GATHER_KERNELS):
            raise AssertionError(f"{name} B={B}: the profiler saw "
                                 f"{sorted(seen)}, expected {GATHER_KERNELS}")
        parts = "not measured (no CUDA events)" if seen is None else \
            ", ".join(f"{k} {v:.2f}" for k, v in seen.items()) + " us"
        print(f"  {name} B={B:3d} bf16 (D 576, N 1536, R 3"
              f"{', 12 of 24 clusters' if 'gather' in name else ''}; "
              f"L2-cold over {n} weight copies): kernel "
              f"{t['ms'] * 1e3:.2f} us/call ({t['graph_ms'] * 1e3:.2f} us "
              f"in a CUDA graph, {t['roofline_share']:.1%} of the bound "
              f"{b_ms * 1e3:.3f} us, {b_by}), plain {t['plain_ms'] * 1e3:.2f} "
              f"us, torch.matmul composition (_apply_bundle, not one "
              f"library call) {t['composition_ms'] * 1e3:.2f} us "
              f"({t['composition_graph_ms'] * 1e3:.2f} us in a CUDA graph)")
        print(f"    per call: {parts}")
        out[name] = t
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- phase 4 ----

def check_logits(engine):
    if not bool(torch.isfinite(engine._last).all()):
        raise AssertionError("non-finite logits after a decode step")


def serve_stream(engine, vocab, seed=0):
    """Submit STREAM at temperature 0, staggered on the engine's steps
    (each request arrives at the modeled clock of its step), then
    run_until_drained. Returns (tokens per request, per-step stats,
    per-step synchronized wall seconds)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n, _ in STREAM]
    uids, stats, walls = [None] * len(STREAM), [], []
    for k in range(max(a for _, a in STREAM) + 1):
        for i, (_, arrive) in enumerate(STREAM):
            if arrive == k:
                uids[i] = engine.submit(prompts[i], max_new=MAX_NEW,
                                        arrival_time=engine.clock_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stats.append(r.stats)
        check_logits(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = engine.run_until_drained()
    torch.cuda.synchronize()
    drain = time.perf_counter() - t0
    check_logits(engine)
    walls += [drain / len(rep.stats)] * len(rep.stats)
    toks = [engine.sched.sequences[u].generated for u in uids]
    return toks, stats + rep.stats, walls


class ReplayEvents:
    """CUDA events around every CUDA graph replay inside the `with`: the
    device time of the graphed decode steps, whether or not the profiler
    sees the kernels inside a graph."""

    def __enter__(self):
        self.pairs, orig = [], torch.cuda.CUDAGraph.replay
        self._orig = orig

        def replay(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            orig(graph)
            end.record()
            self.pairs.append((start, end))
        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def profile_steps(engine, vocab, batch=4, n_new=5):
    """torch.profiler over the decode steps of `batch` fresh requests
    (admission and prefill stay outside the window): wall and device time
    per step, kernels per step, and the kernels that take the most device
    time; for a graphed engine also CUDA events around the replays.
    Reports "not measured" when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    for _ in range(batch):
        engine.submit(rng.integers(0, vocab, 16).astype(np.int32),
                      max_new=n_new, arrival_time=engine.clock_s)
    engine.step()                          # admits and prefills all four
    torch.cuda.synchronize()
    steps = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            ReplayEvents() as replays:
        t0 = time.perf_counter()
        while engine.step() is not None:
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3   # ms
    out = dict(wall_ms_per_step=wall * 1e3 / steps,
               replays=len(replays.pairs),
               replay_ms_per_step=replays.ms() / steps if replays.pairs
               else None)
    print(f"  profile: {steps} decode steps at batch <= {batch}, wall "
          f"{out['wall_ms_per_step']:.2f} ms/step")
    if out["replays"]:
        print(f"  CUDA events around the {out['replays']} graph replays: "
              f"{out['replay_ms_per_step']:.3f} ms/step on the device")
    if busy == 0.0:
        print("  profile: device time not measured (no CUDA events)")
        return out
    cold = [e for e in dev if any(f"::{k}" in e.key for k in SUBKERNELS)]
    out.update(device_ms_per_step=busy / steps,
               kernels_per_step=sum(e.count for e in dev) / steps,
               cold_kernels_per_step=sum(e.count for e in cold) / steps,
               cold_ms_per_step=sum(e.self_device_time_total
                                    for e in cold) / 1e3 / steps)
    print(f"  profile: device busy {out['device_ms_per_step']:.3f} ms/step "
          f"({busy / (wall * 1e3):.1%} of wall), "
          f"{out['kernels_per_step']:.0f} kernels/step, of them "
          f"{out['cold_kernels_per_step']:.0f} fused_cold_ffn kernels "
          f"({out['cold_ms_per_step']:.3f} ms/step)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:6.0f}/step  {e.key[:70]}")
    return out


# Best-of-N on one prompt: four samples, cancelled one by one after steps
# 3, 6 and 9, so the batch decays 4 -> 3 -> 2 -> 1 down the bucket ladder
BON = dict(n=4, prompt_len=16, max_new=12, schedule={3: 1, 6: 1, 9: 1})
BON_BATCHES = [4] * 4 + [3] * 3 + [2] * 3 + [1] * 2


def serve_run(sd, graphs):
    """One full-width engine (graphed, the default, or eager): the
    staggered STREAM, then the Best-of-N decay, then a profile; the
    launch count is set to 0 before and read after each of the first
    two."""
    gc.collect()              # free the previous run's engine first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, cfg = build_engine("smollm-135m", reduced=False,
                               backend="pallas", ctx_budget=CTX,
                               storage_dtype=sd,
                               cuda_graphs=None if graphs else False)
    if engine.cuda_graphs != graphs:
        raise AssertionError(f"cuda_graphs is {engine.cuda_graphs}")
    if (engine.model.layers[0].ffn.quant is None) != (sd == "fp16"):
        raise AssertionError(f"{sd}: quantized containers missing or stray")
    # each step's trace, and the host seconds the storage plane (numpy,
    # on the CPU) takes to price it
    plane, traces, price = [], [], engine.storage.step

    def timed(trace, *a, **k):
        traces.append(np.array(trace).tolist())
        t0 = time.perf_counter()
        out = price(trace, *a, **k)
        plane.append(time.perf_counter() - t0)
        return out
    engine.storage.step = timed
    ops.fused_cold_ffn.launches = 0
    toks, stats, walls = serve_stream(engine, cfg.vocab_size)
    launches = ops.fused_cold_ffn.launches
    peak = torch.cuda.max_memory_allocated()
    hist = list(engine.sched.batch_history)
    plane_ms = float(np.mean(plane) * 1e3)
    prompt = np.repeat(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, BON["prompt_len"])).astype(np.int32),
        BON["n"], axis=0)
    prompt[:, -1] = np.arange(BON["n"])        # four different samples
    ops.fused_cold_ffn.launches = 0
    bon = engine.generate(prompt, max_new=BON["max_new"], temperature=0.0,
                          completion_schedule=BON["schedule"])
    torch.cuda.synchronize()
    bon_launches = ops.fused_cold_ffn.launches
    check_logits(engine)
    prof = profile_steps(engine, cfg.vocab_size)
    # a graphed replay's launch count is the capture's; hold it against
    # the kernels the profiler saw on the card (four per layer and step)
    want = len(SUBKERNELS) * cfg.num_layers
    if prof.get("cold_kernels_per_step") != want:
        raise AssertionError(f"the profiler saw "
                             f"{prof.get('cold_kernels_per_step')} "
                             f"fused_cold_ffn kernels per step, not {want}")
    captures = sum(getattr(fn, "captures", 0)
                   for _, fn in engine.decoder._cache.values())
    switches = engine.decoder.switches
    engine.close()
    steps = len(stats)
    for t in toks:
        if len(t) != MAX_NEW or not all(0 <= v < cfg.vocab_size for v in t):
            raise AssertionError(f"bad request output {t}")
    if max(hist) != len(STREAM) or len(set(hist)) < 3:
        raise AssertionError(f"stream did not cross buckets: {hist}")
    bon_batches = [s.batch for s in bon.stats]
    if bon_batches != BON_BATCHES:
        raise AssertionError(f"Best-of-N batches {bon_batches}")
    for name, n, k in (("stream", launches, steps),
                       ("Best-of-N", bon_launches, len(bon.stats))):
        if n != cfg.num_layers * k:
            raise AssertionError(f"{name}: {n} kernel launches for {k} "
                                 f"steps of {cfg.num_layers} layers")
    w = np.array(walls) * 1e3
    return dict(
        launches=launches, steps=steps, bon_launches=bon_launches,
        bon_steps=len(bon.stats), wall_ms_first=float(w[0]),
        wall_ms_median=float(np.median(w)), wall_ms_mean=float(w.mean()),
        wall_ms_mean_after_first=float(w[1:].mean()), plane_ms=plane_ms,
        peak_bytes=peak, batch_history=hist, bon_batches=bon_batches,
        profile=prof, captures=captures, switches=switches,
        num_layers=cfg.num_layers, d_model=cfg.d_model,
        param_dtype=cfg.param_dtype, vocab=cfg.vocab_size,
        outputs=dict(tokens=toks, traces=traces, stats=stats,
                     bon_tokens=bon.tokens.tolist(), bon_stats=bon.stats))


def report_run(name, r):
    p = r["profile"]
    dev = p.get("device_ms_per_step")
    print(f"  {name}: fused_cold_ffn launches {r['launches']} = "
          f"{r['num_layers']} x {r['steps']} steps, Best-of-N "
          f"{r['bon_launches']} = {r['num_layers']} x {r['bon_steps']} "
          f"(batches {r['bon_batches']}); {r['captures']} graphs captured, "
          f"{r['switches']} bucket switches")
    print(f"    wall per decode step (synchronized): first "
          f"{r['wall_ms_first']:.2f} ms, median {r['wall_ms_median']:.2f} "
          f"ms, mean {r['wall_ms_mean']:.2f} ms, mean after the first "
          f"{r['wall_ms_mean_after_first']:.2f} ms")
    if dev is None:
        print("    device time per step: not measured by the profiler")
    else:
        print(f"    device time per step (torch.profiler): {dev:.3f} ms, "
              f"{dev / p['wall_ms_per_step']:.1%} of the profiled step's "
              f"wall, {dev / r['wall_ms_median']:.1%} of the median wall; "
              f"{p['kernels_per_step']:.0f} kernels per step")
    if p["replay_ms_per_step"] is not None:
        print(f"    device time per step (CUDA events around the replays): "
              f"{p['replay_ms_per_step']:.3f} ms, "
              f"{p['replay_ms_per_step'] / r['wall_ms_median']:.1%} of the "
              f"median wall")
    print(f"    storage plane (host) {r['plane_ms']:.2f} ms per step; peak "
          f"device memory {r['peak_bytes'] / 2**20:.1f} MiB")


# the context budget of the memory check: a realistic serving context
MEM_CTX = 2048


def serve_memory(batches=(1, 4, 64)):
    """A graphed full-width engine at ctx_budget MEM_CTX serves
    generate() at each batch in turn: the KV arena holds the rows of the
    batch's bucket (it grows with the batch, never to max_slots ahead of
    it). Reports its bytes and the peak device memory of each call."""
    gc.collect()
    torch.cuda.empty_cache()
    engine, cfg = build_engine("smollm-135m", reduced=False,
                               backend="pallas", ctx_budget=MEM_CTX)
    rng = np.random.default_rng(5)
    out = {}
    for b in batches:
        torch.cuda.reset_peak_memory_stats()
        engine.generate(rng.integers(0, cfg.vocab_size, (b, 16)).astype(
            np.int32), max_new=4, temperature=0.0)
        torch.cuda.synchronize()
        check_logits(engine)
        arena = engine.arena
        if arena.capacity != bucket_for(b, engine.decoder.buckets):
            raise AssertionError(f"B={b}: arena of {arena.capacity} rows")
        out[b] = dict(capacity=arena.capacity,
                      arena_bytes=sum(t.numel() * t.element_size()
                                      for t in arena.storage.values()),
                      peak_bytes=torch.cuda.max_memory_allocated())
        print(f"  memory at ctx_budget {MEM_CTX}, B={b}: KV arena "
              f"{out[b]['capacity']} rows, "
              f"{out[b]['arena_bytes'] / 2**20:.1f} MiB; peak device "
              f"memory {out[b]['peak_bytes'] / 2**20:.1f} MiB")
    engine.close()
    return out


def phase_serve(sd="fp16"):
    """The full-width stream served twice, with one CUDA graph per
    decode bucket (the default) and eagerly: tokens, per-step cluster
    ids and every TokenStats field must be identical, and the launch
    count 30 per step in both."""
    print(f"== phase 4: serve smollm-135m at full width through the kernel, "
          f"storage dtype {sd}, graphed and eager")
    runs = {"graph": serve_run(sd, True), "eager": serve_run(sd, False)}
    g, e = runs["graph"], runs["eager"]
    print(f"  {g['num_layers']} layers, d_model {g['d_model']}, "
          f"{g['param_dtype']}; {g['steps']} decode steps, batch sizes "
          f"{g['batch_history']}")
    for key, val in g["outputs"].items():
        if val != e["outputs"][key]:
            raise AssertionError(f"{sd}: graphed and eager {key} differ")
    if g["batch_history"] != e["batch_history"] or g["captures"] < 4:
        raise AssertionError(f"{sd}: histories {g['batch_history']} / "
                             f"{e['batch_history']}, {g['captures']} graphs")
    print(f"  graphed and eager: tokens, {len(g['outputs']['traces'])} "
          f"per-step cluster-id traces and every TokenStats field "
          f"identical, Best-of-N included")
    for name, r in runs.items():
        report_run(name, r)
    stats = g["outputs"]["stats"]
    modeled = sum(s.batch for s in stats) / sum(s.effective_s for s in stats)
    print(f"  modeled decode rate (storage plane, PHONE profile): "
          f"{modeled:.2f} tok/s")
    out = {k: v for k, v in g.items() if k != "outputs"}
    out["eager"] = {k: v for k, v in e.items() if k != "outputs"}
    if sd == "fp16":
        out["memory"] = serve_memory()
    return out


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def prepared(cfg, backend="pallas", sd="fp16", make_model=None, hw=PHONE):
    """The family's model on the card (seed 0), its plan on the PHONE
    profile (or `hw`) and the prepared weights, as build_engine makes
    them."""
    fam = serving_family(cfg)
    model = (make_model or fam.make_model)(cfg, device="cuda", seed=0)
    plan = fam.build_plan(cfg, hw=hw, backend=backend, storage_dtype=sd)
    return fam.prepare_params(model, plan), plan


# ----------------------------------------------------------- phase 5 ----

def parity_run(cfg, backend, sd="fp16"):
    free_cuda()
    model, plan = prepared(cfg, backend, sd)
    engine = ServeEngine(cfg, model, plan, temperature=0.0, seed=0,
                         backend=backend, ctx_budget=CTX)
    traces = []
    price = engine.storage.step

    def record(trace, *a, **k):            # keep each step's trace
        traces.append(np.array(trace))
        return price(trace, *a, **k)
    engine.storage.step = record
    toks, stats, _ = serve_stream(engine, cfg.vocab_size, seed=1)
    engine.close()
    return toks, traces, stats


def phase_parity(sd="fp16", arch="smollm-135m"):
    cfg = get_config(arch).replace(
        num_layers=4, param_dtype="float32", compute_dtype="float32")
    print(f"== phase 5: pallas and jnp backends, {arch} at full width "
          f"(D {cfg.d_model}, {cfg.sparse_ffn.mode} mode), fp32, 4 layers, "
          f"storage dtype {sd}")
    pt, ptr, pst = parity_run(cfg, "pallas", sd)
    jt, jtr, jst = parity_run(cfg, "jnp", sd)
    if pt != jt:
        raise AssertionError("backends disagree on tokens")
    if len(ptr) != len(jtr) or any(not np.array_equal(a, b)
                                   for a, b in zip(ptr, jtr)):
        raise AssertionError("backends disagree on (L, G, kc) traces")
    if pst != jst:
        raise AssertionError("backends disagree on TokenStats")
    print(f"  {len(pst)} steps: tokens, TokenStats and {len(ptr)} traces "
          f"of shape {ptr[0].shape} identical")


# ----------------------------------------------------------- phase 6 ----

def phase_api(batch=4):
    """The kernel API over every layer of the full-width bf16 model: the
    counts of cluster_gather_ffn and dense_ffn are set to 0 just before
    and read just after. fused_cold_ffn (relu mode) picks each layer's
    clusters; cluster_gather_ffn_grouped over those picks must give its
    output, and dense_ffn must match its plain version."""
    print("== phase 6: the kernel API at full width (30 layers, bf16)")
    cfg = get_config("smollm-135m")
    model, plan = prepared(cfg)
    p = plan.plan_for_batch(batch)
    G, cs, n_hot = p.groups, p.cluster_size, p.n_hot
    kc = 4                                # several clusters per layer
    rng = np.random.default_rng(5)
    # x is scaled so that the outputs are of unit size, the size the
    # reference's tolerances are set for: the bundles are drawn at
    # 1/sqrt(R), and at x ~ N(0, 0.5) outputs reach 1e3, where one bf16
    # step of h between two fp32 summation orders moves y by ~0.1
    x = torch.from_numpy(rng.standard_normal((batch, cfg.d_model)).astype(
        np.float32) * 0.02).to("cuda", torch.bfloat16)
    tol = TOL[torch.bfloat16]
    err = 0.0
    ops.cluster_gather_ffn.launches = ops.dense_ffn.launches = 0
    for layer in model.layers:
        w = layer.ffn.w
        N, R, D = w.shape
        nc_g = (N - n_hot) // G // cs
        wc = w[n_hot:].reshape(G, nc_g, cs, R, D)
        yf, idx = ops.fused_cold_ffn(x, wc, layer.ffn.pred_A,
                                     layer.ffn.pred_B[:, n_hot:],
                                     activation=cfg.activation, mode="relu",
                                     kc=kc)
        yg = ops.cluster_gather_ffn_grouped(x, wc, idx,
                                            activation=cfg.activation)
        yd = ops.dense_ffn(x, w, activation=cfg.activation)
        for name, a, b in (("gather vs fused", yg.float(), yf),
                           ("dense vs plain", yd.float(), dense_ffn_ref(
                               x, w, activation=cfg.activation).float())):
            if not torch.allclose(a, b, atol=tol, rtol=tol):
                raise AssertionError(f"{name}: max |diff| = "
                                     f"{float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
    torch.cuda.synchronize()
    launches = dict(cluster_gather_ffn=ops.cluster_gather_ffn.launches,
                    dense_ffn=ops.dense_ffn.launches)
    if set(launches.values()) != {cfg.num_layers}:
        raise AssertionError(f"kernel API launches {launches}, expected "
                             f"{cfg.num_layers} each")
    print(f"  {cfg.num_layers} layers: launches {launches}; gather over "
          f"the fused picks and dense_ffn agree, max |diff| = {err:.3e}")
    return launches


# ------------------------------------------------------- phase fleet ----

# the fleet phase's stream: (prompt length, arrival on the modeled clock
# in ms), eight greedy requests of MAX_NEW tokens
FLEET_STREAM = [(16, 0.0), (16, 0.0), (24, 0.0), (32, 1.0), (16, 2.0),
                (24, 3.0), (16, 5.0), (32, 7.0)]


def fleet_prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n, _ in FLEET_STREAM]


def graph_buffers(engine):
    """Every captured graph of an engine's decoder: (captures, the
    pointers of the buffers each was captured on, the decoder's pool)."""
    steps = [fn for _, fn in engine.decoder._cache.values()]
    if not steps or any(getattr(fn, "graph", None) is None for fn in steps):
        raise AssertionError("a bucket's step is not a captured graph")
    ptrs = {p for fn in steps for p, _ in fn._bound}
    return sum(fn.captures for fn in steps), ptrs, engine.decoder._pool


def dp_serve(engine, prompts, which=None):
    """FLEET_STREAM's requests `which` (default all) through `engine`, all
    submitted up front at their modeled arrival times, stepped to the end
    with a synchronized wall per step. Returns (tokens by uid, uids,
    per-step walls)."""
    which = range(len(prompts)) if which is None else which
    uids = [engine.submit(prompts[i], max_new=MAX_NEW,
                          arrival_time=FLEET_STREAM[i][1] * 1e-3)
            for i in which]
    walls = []
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine.step()
        torch.cuda.synchronize()
        if r is None:
            break
        walls.append(time.perf_counter() - t0)
        check_logits_of(r, engine)
    toks = {u: list(engine.sched.sequences[u].generated) for u in uids}
    return toks, uids, walls


def check_logits_of(r, engine):
    rep = engine.replicas[r.replica] if engine.replicas else engine
    check_logits(rep)


def phase_fleet():
    """dp replicas and the fleet gateway at full width (smollm-135m, 30
    layers, bf16, the kernel, graphed): (a) ServeEngine(dp=2) against two
    independent dp=1 engines on the routed streams, its graphs per
    replica, 30 launches per replica step, a cancel on replica 1 that
    frees its slot there, and peak device memory against dp=1; (b)
    build_fleet(n=2) through FleetGateway with backend 1 lost mid-stream
    and restored, a response-LRU hit, and the same run eagerly: identical
    tokens, per-backend completions and FleetReport."""
    print("== phase fleet: dp=2 replicas and the fleet gateway, "
          "smollm-135m at full width")
    free_cuda()
    cfg = get_config("smollm-135m")
    model, plan = prepared(cfg)
    model_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    prompts = fleet_prompts(cfg.vocab_size)
    kw = dict(backend="pallas", temperature=0.0, seed=0, ctx_budget=CTX)
    L = cfg.num_layers

    base = torch.cuda.memory_allocated()       # the model
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, model, plan, dp=2, **kw)
    ops.fused_cold_ffn.launches = 0
    toks, uids, walls = dp_serve(eng, prompts)
    launches = ops.fused_cold_ffn.launches
    peak_dp2 = torch.cuda.max_memory_allocated() - base
    held_dp2 = torch.cuda.memory_allocated() - base
    steps = len(walls)
    if launches != L * steps:
        raise AssertionError(f"dp=2: {launches} launches for {steps} "
                             f"replica steps of {L} layers")
    assignment = dict(eng.router.assignment)
    if {r for r, _ in assignment.values()} != {0, 1}:
        raise AssertionError(f"dp=2 routed everything to one replica: "
                             f"{assignment}")
    caps, ptrs, pools = zip(*(graph_buffers(r) for r in eng.replicas))
    if ptrs[0] & ptrs[1] or pools[0] is pools[1] or min(caps) < 1:
        raise AssertionError("dp=2 replicas share captured buffers or a "
                             "pool, or one captured nothing")
    span_tok_s = sum(len(t) for t in toks.values()) / eng.clock_s
    # the cancel: two requests, one per replica; after both are admitted,
    # replica 1's is cancelled and its slot goes back to its free list
    rep1 = eng.replicas[1]
    new = [eng.submit(p, max_new=MAX_NEW) for p in prompts[:2]]
    while not rep1.sched.running:
        eng.step()
    local = rep1.sched.running[0]
    slot, free_before = rep1.arena.slot_of[local], rep1.arena.n_free
    eng.cancel([eng.router.to_global(1, local)])
    if local in rep1.arena.slot_of or slot not in rep1.arena.free \
            or rep1.arena.n_free != free_before + 1:
        raise AssertionError("cancel on replica 1 did not free its slot")
    eng.run_until_drained()
    if any(not eng.sched.sequences[u].finished for u in new):
        raise AssertionError("the stream after the cancel did not drain")
    eng.close()
    del eng, rep1
    free_cuda()

    want, peak_dp1, walls1 = {}, 0, []
    for r in (0, 1):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # a replica's storage plane holds a 1/2 share of the resident
        # cache; so does this one, or its modeled clock, and with it
        # when later arrivals are admitted, would differ
        one = ServeEngine(cfg, model, plan, n_replicas=2, **kw)
        mine = [g for g, (rep, _) in sorted(assignment.items()) if rep == r]
        got, local, w1 = dp_serve(one, prompts, mine)
        walls1 += w1
        peak_dp1 = max(peak_dp1, torch.cuda.max_memory_allocated() - base)
        held_dp1 = torch.cuda.memory_allocated() - base
        want.update({g: got[u] for u, g in zip(local, mine)})
        one.close()
        del one
        free_cuda()
    if [toks[u] for u in uids] != [want[g] for g in range(len(uids))]:
        raise AssertionError("dp=2 tokens differ from the two routed dp=1 "
                             "engines'")
    w, w1 = np.array(walls) * 1e3, np.array(walls1) * 1e3
    print(f"  (a) dp=2: {len(uids)} requests routed "
          f"{[r for r, _ in assignment.values()]}; tokens identical to two "
          f"independent dp=1 engines on the routed streams; {caps[0]} / "
          f"{caps[1]} graphs captured per replica over disjoint buffers "
          f"and their own pools; fused_cold_ffn launches {launches} = "
          f"{L} x {steps} replica steps; a cancel on replica 1 freed "
          f"slot {slot} there")
    print(f"    wall per step (synchronized): first {w[0]:.2f} ms, median "
          f"{np.median(w):.2f} ms, mean after the first {w[1:].mean():.2f} "
          f"ms (the two dp=1 engines: median {np.median(w1):.2f} ms over "
          f"{len(w1)} steps); modeled span rate {span_tok_s:.2f} tok/s")
    print(f"    device memory above the model's {model_bytes / 2**20:.1f} "
          f"MiB (shared), peak / held after the stream: dp=2 "
          f"{peak_dp2 / 2**20:.1f} / {held_dp2 / 2**20:.1f} MiB, dp=1 "
          f"{peak_dp1 / 2**20:.1f} / {held_dp1 / 2**20:.1f} MiB")
    del model
    free_cuda()

    runs = {g: fleet_run(g, prompts) for g in (True, False)}
    gr, ea = runs[True], runs[False]
    for key in ("tokens", "completed", "report", "hit"):
        if gr[key] != ea[key]:
            raise AssertionError(f"fleet: graphed and eager {key} differ")
    rep = gr["report"]
    print(f"  (b) fleet of 2 (build_fleet): {rep['n_completed']}/"
          f"{rep['n_submitted']} completed, {rep['n_retries']} retries "
          f"after backend 1 was lost at {gr['lost_at'] * 1e3:.3f} ms and "
          f"restored 10 ms later, per-backend completions "
          f"{gr['completed']}; the resubmitted prompt was a response-LRU "
          f"hit with identical tokens; graphed and eager identical in "
          f"tokens, completions and FleetReport")
    for name, r in (("graphed", gr), ("eager", ea)):
        print(f"    {name}: launches {r['launches']} = {L} x {r['steps']} "
              f"backend steps; wall {r['wall_ms_per_step']:.2f} ms per "
              f"backend step (each engine's graph captures included); "
              f"modeled span rate {rep['throughput_tok_s']:.2f} tok/s; "
              f"peak device memory {r['peak_bytes'] / 2**20:.1f} MiB")
    return dict(dp2=dict(launches=launches, steps=steps,
                         wall_ms_median=float(np.median(w)),
                         wall_ms_median_dp1=float(np.median(w1)),
                         span_tok_s=span_tok_s, peak_bytes=peak_dp2,
                         peak_bytes_dp1=peak_dp1, held_bytes=held_dp2,
                         held_bytes_dp1=held_dp1, model_bytes=model_bytes),
                fleet={k: {kk: v for kk, v in r.items()
                           if kk not in ("tokens", "report", "hit")}
                       for k, r in (("graph", gr), ("eager", ea))},
                fleet_report={k: rep[k] for k in (
                    "n_submitted", "n_completed", "n_retries", "span_s",
                    "throughput_tok_s")})


def fleet_run(graphs, prompts):
    """FLEET_STREAM through build_fleet("smollm-135m", 2) at full width:
    backend 1 is lost after its second decode step and restored 10 ms
    later on the fleet clock; then prompt 0 again, which must be a response-LRU
    hit."""
    from repro_torch.launch.serve import build_fleet
    from repro_torch.serving.gateway import FleetReport
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    gw, cfg = build_fleet(
        "smollm-135m", 2, reduced=False, backend="pallas",
        engine_kwargs=dict(temperature=0.0, ctx_budget=CTX,
                           cuda_graphs=None if graphs else False),
        heartbeat_s=1e-3, cache_capacity=16)
    if any(b.handle.engine.cuda_graphs != graphs for b in gw.backends):
        raise AssertionError("fleet engines: wrong cuda_graphs")
    uids = [gw.submit(p, max_new=MAX_NEW, arrival_time=t * 1e-3)
            for p, (_, t) in zip(prompts, FLEET_STREAM)]
    ops.fused_cold_ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while gw.backends[1].n_steps < 2:       # backend 1 is decoding
        gw.step()
    lost_at = gw.clock_s
    gw.fail_backend(1, at=lost_at)
    gw.restore_backend(1, at=lost_at + 1e-2)
    rep = gw.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.fused_cold_ffn.launches
    steps = sum(b.n_steps for b in gw.backends)
    if launches != cfg.num_layers * steps:
        raise AssertionError(f"fleet: {launches} launches for {steps} "
                             f"backend steps")
    if not (rep.drained and rep.n_completed == len(uids)
            and rep.n_rejected == 0 and rep.n_retries >= 1):
        raise AssertionError(f"fleet: {rep.n_completed}/{len(uids)} "
                             f"completed, {rep.n_rejected} rejected, "
                             f"{rep.n_retries} retries")
    hit = gw.submit(prompts[0], max_new=MAX_NEW, arrival_time=gw.clock_s)
    gw.run_until_drained()
    req = gw.requests
    if not req[hit].cache_hit or req[hit].tokens != req[uids[0]].tokens:
        raise AssertionError("fleet: the resubmitted prompt was no LRU hit")
    peak = torch.cuda.max_memory_allocated()
    gw.close()
    report = {f.name: getattr(rep, f.name)
              for f in dataclasses.fields(FleetReport)}
    report.update(ttft_hit=None if rep.ttft_hit is None
                  else rep.ttft_hit.tolist(),
                  ttft_miss=None if rep.ttft_miss is None
                  else rep.ttft_miss.tolist(),
                  rejected=len(rep.rejected),
                  throughput_tok_s=rep.throughput_tok_s)
    return dict(tokens=[list(req[u].tokens) for u in uids],
                completed=[b["completed"] for b in rep.per_backend],
                report=report, hit=list(req[hit].tokens), lost_at=lost_at,
                launches=launches, steps=steps,
                wall_ms_per_step=wall * 1e3 / steps, peak_bytes=peak)


# ------------------------------------------------------- phase archs ----

# (arch, layers kept): the paper's widths; qwen3-14b is cut from 40 to 8
# layers to keep the phase inside the script's time limit
ARCHS = (("qwen2-vl-2b", None), ("bamboo-7b", None), ("qwen3-14b", 8))
ARCH_BATCHES = (1, 4, 32)


def arch_cfg(arch, layers):
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def arch_serve(cfg, model, plan, graphs, spy=None, backend="pallas",
               profile_new=5, profiled=False):
    """Phase 4's stream through one engine (graphed or eager), then a
    profile; the launch count is set to 0 before the stream and read
    after. `spy` = (module, name, function) replaces that module's
    function during the stream. Under "pallas" every layer launches
    fused_cold_ffn once per step (four kernels in the profile), and every
    bucket the stream and the profile reach must keep a cold path; with
    `profiled` (a plan profiled on random weights, which may make every
    neuron of a bucket hot) only the steps whose bucket keeps one launch
    it. The moe family's plain path ("jnp") launches it never. The
    storage plane's calls are recorded (`calls`) for repricing."""
    free_cuda()                 # the previous engine's pools and buffers
    engine = ServeEngine(cfg, model, plan, backend=backend, temperature=0.0,
                         seed=0, ctx_budget=CTX,
                         cuda_graphs=None if graphs else False)
    traces, calls, plane, price = [], [], [], engine.storage.step

    def record(trace, *a, **k):
        traces.append(np.array(trace).tolist())
        calls.append((np.array(trace), a, k))
        t0 = time.perf_counter()
        out = price(trace, *a, **k)
        plane.append(time.perf_counter() - t0)
        return out
    engine.storage.step = record
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cold_ffn.launches = 0
    if spy is not None:
        mod, name, fn = spy
        inner = getattr(mod, name)
        setattr(mod, name, fn)
    try:
        toks, stats, walls = serve_stream(engine, cfg.vocab_size)
    finally:
        if spy is not None:
            setattr(mod, name, inner)
    launches = ops.fused_cold_ffn.launches
    peak = torch.cuda.max_memory_allocated()
    cold = [cold_path(cfg, plan, engine, s.batch) for s in stats]
    cold_prof = cold_path(cfg, plan, engine, 4)     # the profile's batch
    per_step = cfg.num_layers if backend == "pallas" else 0
    if per_step and not profiled and not (all(cold) and cold_prof):
        raise AssertionError(f"{cfg.name}: {len(cold) - sum(cold)} of "
                             f"{len(stats)} steps (or the profile's) in a "
                             f"bucket with no cold path under {backend!r}")
    if launches != per_step * sum(cold):
        raise AssertionError(f"{cfg.name}: {launches} launches for "
                             f"{sum(cold)} of {len(stats)} steps with a cold "
                             f"path, {cfg.num_layers} layers, under "
                             f"{backend!r}")
    prof = profile_steps(engine, cfg.vocab_size, n_new=profile_new)
    want = len(SUBKERNELS) * per_step * cold_prof
    if prof.get("cold_kernels_per_step") != want:
        raise AssertionError(f"{cfg.name}: the profiler saw "
                             f"{prof.get('cold_kernels_per_step')} "
                             f"fused_cold_ffn kernels per step, not {want}")
    engine.close()
    w = np.array(walls) * 1e3
    return dict(outputs=(toks, traces, stats), calls=calls,
                launches=launches, steps=len(stats), cold_steps=sum(cold),
                wall_ms_median=float(np.median(w)),
                wall_ms_first=float(w[0]), peak_bytes=peak, profile=prof,
                plane_ms=float(np.mean(plane) * 1e3))


def x_spy(model):
    """A spy for arch_serve that records layer 0's FFN input, the
    kernel's x, as rows (D,). Returns (spy, the list of recorded
    tensors)."""
    from repro_torch.models import blocks
    w0, xs, inner = model.layers[0].ffn.w, [], blocks.ffn_apply

    def spy(w, pred, x, *a, **k):
        if w is w0:
            xs.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return inner(w, pred, x, *a, **k)
    return (blocks, "ffn_apply", spy), xs


def cold_path(cfg, plan, engine, batch) -> bool:
    """Whether a step of `batch` live rows runs the cold path (one
    fused_cold_ffn call per layer under "pallas"): its bucket's plan
    keeps cold clusters and gathers some. A plan profiled on random
    weights may make every neuron hot."""
    p = plan.plan_for_batch(bucket_for(batch, engine.decoder.buckets))
    return p.n_hot < cfg.d_ff and p.clusters_per_group > 0


def layer_operands(ffn, p):
    """fused_cold_ffn's operands of the FFN module `ffn` under bucket plan
    p: the cold clusters (G, nc_g, cs, R, D) and the predictor's A and
    cold slice."""
    N, R, D = ffn.w.shape
    wc = ffn.w[p.n_hot:].reshape(p.groups, -1, p.cluster_size, R, D)
    return wc, ffn.pred_A, ffn.pred_B[:, p.n_hot:]


def arch_kernel(cfg, ffn, plan_for, xs, batches=ARCH_BATCHES,
                rounding=False):
    """fused_cold_ffn on the weights of the FFN module `ffn` (layer 0's)
    and rows of x recorded from the serve, at each B of `batches` under
    the bucket plan `plan_for(B)`, against its plain version (phase 3's
    check; `rounding` as hold_kernel's), then its time per call in a
    CUDA graph beside its bound."""
    out = {}
    mode = cfg.sparse_ffn.mode
    for B in batches:
        p = plan_for(B)
        wc, A, Bp = layer_operands(ffn, p)
        kc = p.clusters_per_group
        x = xs[:B].contiguous()
        mask = torch.ones(B, dtype=torch.bool, device="cuda")
        G, nc_g, cs, R, D = wc.shape
        name = f"{cfg.name} layer 0 B={B} (D {D}, cs {cs}, nc_g {nc_g}, kc {kc})"
        err = hold_kernel(name, x, wc, A, Bp, mask, cfg.activation, mode, kc,
                          rounding=rounding)
        kern = lambda: ops.fused_cold_ffn(x, wc, A, Bp,
                                          activation=cfg.activation,
                                          mode=mode, kc=kc)
        plain = lambda: fused_cold_ffn_ref(x, wc, A, Bp, mask.float(),
                                           activation=cfg.activation,
                                           cats=mode == "cats", kc=kc)
        s = dict(D=D, r=A.shape[1], cs=cs, G=G, nc_g=nc_g, R=R, kc=kc)
        b_ms, b_by = bound(B, x.dtype, s=s)
        t = dict(ms=cuda_time_ms(kern), graph_ms=graph_time_ms(kern),
                 plain_ms=cuda_time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=err, shape=s)
        print(f"    B={B:2d}: kernel {t['ms'] * 1e3:.2f} us/call "
              f"({t['graph_ms'] * 1e3:.2f} us in a CUDA graph, L2-warm), "
              f"plain {t['plain_ms'] * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by})")
        out[B] = t
    return out


def phase_archs():
    """The paper's widths through the serving engine and the kernel:
    qwen2-vl-2b (vlm, 28 layers), bamboo-7b (relu mode, relu2, 32
    layers, untied head) and qwen3-14b (qk-norm, cut to 8 of 40 layers),
    bf16 weights, fp16 storage. Each serves phase 4's stream graphed and
    eagerly (tokens, per-step ids and TokenStats identical, L launches
    per step, the profiler's four kernels per layer and step), then
    fused_cold_ffn on its layer-0 weights and x from the serve."""
    out = {}
    for arch, layers in ARCHS:
        free_cuda()
        cfg = arch_cfg(arch, layers)
        cut = "" if layers is None else \
            f", cut to {layers} of {get_config(arch).num_layers} layers"
        print(f"== phase archs: {arch} at full width (D {cfg.d_model}, "
              f"d_ff {cfg.d_ff}, {cfg.num_layers} layers{cut}, "
              f"{cfg.param_dtype}, {cfg.activation}, "
              f"{cfg.sparse_ffn.mode} mode)")
        model, plan = prepared(cfg)
        spy, xs = x_spy(model)
        runs = {"graph": arch_serve(cfg, model, plan, True),
                "eager": arch_serve(cfg, model, plan, False, spy)}
        g, e = runs["graph"], runs["eager"]
        for name, a, b in zip(("tokens", "traces", "TokenStats"),
                              g["outputs"], e["outputs"]):
            if a != b:
                raise AssertionError(f"{arch}: graphed and eager {name} "
                                     f"differ")
        p1 = plan.plan_for_batch(1)
        print(f"  plan (PHONE, B=1): n_hot {p1.n_hot}, k_cold {p1.k_cold}, "
              f"cs {p1.cluster_size}, {p1.groups} group(s); graphed and "
              f"eager: tokens, {g['steps']} per-step ids and every "
              f"TokenStats field identical; launches {g['launches']} = "
              f"{cfg.num_layers} x {g['steps']} in both")
        for name, r in runs.items():
            p = r["profile"]
            dev = p.get("device_ms_per_step")
            dev_s = "not measured" if dev is None else f"{dev:.3f} ms"
            print(f"  {name}: wall per step median {r['wall_ms_median']:.2f} "
                  f"ms (first {r['wall_ms_first']:.2f}); device busy per "
                  f"step {dev_s}; storage plane {r['plane_ms']:.2f} ms per "
                  f"step (host); peak device memory "
                  f"{r['peak_bytes'] / 2**20:.1f} MiB")
        rows = torch.cat(xs)
        if rows.shape[0] < max(ARCH_BATCHES):
            raise AssertionError(f"{arch}: {rows.shape[0]} rows of x")
        kt = arch_kernel(cfg, model.layers[0].ffn, plan.plan_for_batch, rows)
        out[arch] = dict(
            layers=cfg.num_layers, launches=g["launches"], steps=g["steps"],
            kernels=kt, **{f"{k}_{m}": runs[m][k] for m in runs
                           for k in ("wall_ms_median", "peak_bytes",
                                     "plane_ms")},
            device_ms_per_step={m: runs[m]["profile"].get(
                "device_ms_per_step") for m in runs})
        del model, rows, xs, spy
    free_cuda()
    return out


# --------------------------------------------------------- phase vlm ----

VLM_TEXT, VLM_STEPS = 16, 8


def vlm_decode(cfg, model, plan, patches, tokens, backend, feed=None):
    """models/vlm.py: prefill of the patches and text, then VLM_STEPS
    decode steps (greedy, or the tokens `feed`) under the hybrid FFN with
    `backend`. Returns (tokens fed, per-step ids (L, G, kc), per-step x
    of every layer's FFN)."""
    from repro_torch.models import blocks, vlm
    P = cfg.num_image_tokens
    logits, cache = vlm.prefill(model, tokens, patches,
                                max_len=P + VLM_TEXT + VLM_STEPS)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("vlm prefill: non-finite logits")
    step = vlm.make_decode_step(cfg, collect_indices=True)
    p = dataclasses.replace(plan.plan_for_batch(1), backend=backend)
    seen, inner = [], blocks.ffn_apply

    def record(w, pred, x, *a, **k):
        seen.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return inner(w, pred, x, *a, **k)
    fed, ids, xs = [], [], []
    blocks.ffn_apply = record
    try:
        for s in range(VLM_STEPS):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None] \
                if feed is None else feed[s]
            seen.clear()
            logits, cache, cidx = step(model, nxt, cache, p)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"vlm decode step {s}: non-finite "
                                     f"logits")
            fed.append(nxt)
            ids.append(cidx.cpu())
            xs.append(list(seen))
    finally:
        blocks.ffn_apply = inner
    return fed, ids, xs


def vlm_run(cfg, patches, tokens):
    """The M-RoPE model at `cfg`'s dtype: the decode under the kernel,
    then under the plain chain fed the same tokens. Returns (launches,
    per-step pallas ids, jnp ids, the two runs' per-layer x, plan,
    model)."""
    from repro_torch.models import vlm
    free_cuda()
    model, plan = prepared(cfg, make_model=vlm.make_model)
    ops.fused_cold_ffn.launches = 0
    fed, ids_p, xs_p = vlm_decode(cfg, model, plan, patches, tokens,
                                  "pallas")
    torch.cuda.synchronize()
    launches = ops.fused_cold_ffn.launches
    if launches != cfg.num_layers * VLM_STEPS:
        raise AssertionError(f"vlm: {launches} launches")
    _, ids_j, xs_j = vlm_decode(cfg, model, plan, patches, tokens, "jnp",
                                feed=fed)
    return launches, ids_p, ids_j, xs_p, xs_j, plan.plan_for_batch(1), model


def phase_vlm():
    """qwen2-vl-2b's M-RoPE model (models/vlm.py) at full width, 28
    layers: prefill of 1,024 seeded patch embeddings and 16 text tokens,
    then 8 decode steps under the fused kernel ("pallas") and under the
    plain chain ("jnp", fed the same tokens). In bf16: logits finite, 28
    launches per step, and at every (step, layer) the kernel's picks
    identical to the plain chain's on the same x but for fp64-confirmed
    near ties (the two decodes' x drift apart in bf16, so their own
    picks are counted, not held). In fp32: the two decodes' picks
    identical at every (step, layer) but for near ties."""
    print("== phase vlm: qwen2-vl-2b M-RoPE prefill (1,024 patches + 16 "
          "text tokens) and 8 decode steps at full width")
    cfg = get_config("qwen2-vl-2b")
    rng = np.random.default_rng(31)
    patches = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        * 0.1).cuda()
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, VLM_TEXT)).astype(np.int32)).cuda()
    mask = torch.ones(1, device="cuda")
    pairs = [(s, l) for s in range(VLM_STEPS) for l in range(cfg.num_layers)]
    t0 = time.perf_counter()
    launches, ids_p, ids_j, xs_p, _, p1, model = vlm_run(cfg, patches, tokens)
    near_same_x = []
    for s, l in pairs:
        wc, A, Bp = layer_operands(model.layers[l].ffn, p1)
        _, ir = fused_cold_ffn_ref(xs_p[s][l], wc, A, Bp, mask,
                                   activation=cfg.activation,
                                   cats=cfg.sparse_ffn.mode == "cats",
                                   kc=p1.clusters_per_group)
        near, real = pick_disagreements(ids_p[s][l], ir, xs_p[s][l], wc, A,
                                        Bp, mask)
        if real:
            raise AssertionError(f"vlm bf16 step {s} layer {l}: the kernel "
                                 f"picked {real} against the plain chain "
                                 f"on the same x")
        near_same_x += [(s, l)] * bool(near)
    agree = sum(torch.equal(ids_p[s][l], ids_j[s][l]) for s, l in pairs)
    del model
    wall = time.perf_counter() - t0
    print(f"  bf16: logits finite; fused_cold_ffn launches {launches} = "
          f"{cfg.num_layers} x {VLM_STEPS}; the kernel's picks identical to "
          f"the plain chain's on the same x at every (step, layer) "
          f"(near ties at {near_same_x}); the two decodes' own picks agree "
          f"at {agree} of {len(pairs)} (x drifts in bf16); {wall:.2f} s")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    launches32, ids_p, ids_j, xs_p, xs_j, p1, model = vlm_run(
        cfg32, patches, tokens)
    near32 = []
    for s, l in pairs:
        a, b = ids_p[s][l], ids_j[s][l]
        if torch.equal(a, b):
            continue
        wc, A, Bp = layer_operands(model.layers[l].ffn, p1)
        verdicts = [pick_disagreements(a, b, x[s][l], wc, A, Bp, mask)
                    for x in (xs_p, xs_j)]
        if all(real for _, real in verdicts):
            raise AssertionError(f"vlm fp32 step {s} layer {l}: pallas picks "
                                 f"{a.tolist()}, jnp {b.tolist()}: no near "
                                 f"tie")
        near32.append((s, l))
    del model
    free_cuda()
    print(f"  fp32: logits finite; launches {launches32}; the pallas and "
          f"jnp decodes' picks identical at {len(pairs) - len(near32)} of "
          f"{len(pairs)} (step, layer), near ties at {near32}")
    return dict(launches=launches, steps=VLM_STEPS, bf16_agree=agree,
                pairs=len(pairs), near_same_x=near_same_x,
                fp32_near=near32, launches_fp32=launches32)

# --------------------------------------------------------- phase moe ----

# PHONE's prefetch window (2 ms at 4 GB/s) holds 325 bundles of D 4096,
# fewer than turbosparse-mixtral-47b's shared expert (14,336 rows): its
# two-level plan then has no per-expert hot prefix and its trace is
# (L, E). This window of 100 ms holds the shared expert and one 128-row
# cluster per routed expert (n_expert_hot 128): the (L, E, 1+ncc) trace.
WINDOW = dataclasses.replace(PHONE, name="snapdragon-8gen3, 100 ms window",
                             attn_time_s=0.1)
# (arch, layers kept, (storage dtype, hardware profile) served): the
# paper's widths, cut in depth to fit the script's time limit
MOE = (("deepseek-moe-16b", 2, (("fp16", PHONE), ("int8", PHONE))),
       ("turbosparse-mixtral-47b", 1, (("fp16", PHONE), ("fp16", WINDOW))))
MOE_BATCHES = (1, 4, 32)
MOE_OVERFLOW = 64          # rows of the capacity-overflow case
MOE_NEAR = 1e-4            # |g| of an fp64 recompute within a flip


def moe_weights_bytes(cfg) -> int:
    """Bytes of expert weights (routed and shared) one decode step reads:
    the expert GEMMs run densely over every expert's capacity buffer."""
    R = 2 if cfg.activation == "gelu" else 3
    n = (cfg.num_experts + cfg.num_shared_experts) * cfg.d_ff
    return cfg.num_layers * n * R * cfg.d_model * 2


def moe_copy(cfg, moe, device):
    """An fp32 MoEFFN on `device` holding `moe`'s weights."""
    from repro_torch.models.moe import MoEFFN
    out = MoEFFN(cfg, torch.float32, device)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(getattr(moe, name).float())
    return out


def moe_near_flips(cfg, moe, x, active, C, p):
    """(E, ncc) count of the cold (slot, neuron) activations of occupied
    capacity slots whose gate pre-activation g, recomputed in fp64 on the
    CPU from the dispatch buffer, lies within MOE_NEAR of relu's
    threshold 0: the entries two fp32 summation orders may count
    differently (an empty slot's g is exactly 0 on both)."""
    from repro_torch.models import moe as moe_mod
    if cfg.sparse_ffn.mode != "relu":
        raise ValueError("near-threshold counts are for relu mode")
    buf, (slot, keep, _), *_ = moe_mod._dispatch_group(x, moe.router, cfg,
                                                      C, active)
    E = buf.shape[0]
    occ = torch.zeros(E * C, dtype=torch.bool)
    occ[slot[keep].long()] = True
    wg = moe.experts[:, :, 0].double()                  # (E, f, D)
    g = torch.bmm(buf.double(), wg.transpose(1, 2))     # (E, C, f)
    near = ((g.abs() <= MOE_NEAR)
            & occ.reshape(E, C, 1)).sum(dim=1)          # (E, f)
    n_hot_e, cs = p.n_expert_hot, p.cluster_size
    ncc = (cfg.d_ff - n_hot_e) // cs
    return near[:, n_hot_e:].reshape(-1, ncc, cs).sum(dim=-1)


def moe_layer_check(cfg, model, plan, xs):
    """apply_moe_ffn on layer 0 in fp32, on the card and on the CPU, on
    the same weights and rows of x recorded from the serve: B 1, 4 and
    32, then MOE_OVERFLOW rows whose first three quarters repeat one row
    (every copy routes to the same experts, past their capacity); every
    third row dead. tope, slot, keep and the expert counts identical, the
    two-level (relu-mode) cold counts identical but for activations whose
    fp64 g lies within MOE_NEAR of 0; y within 2e-4 of its own scale
    (max |y_card - y_cpu| / max |y_cpu|: the reference init gives outputs
    of order 1e3 to 1e4 at unit-rms x)."""
    from repro_torch.models import moe as moe_mod
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    dev = moe_copy(cfg32, model.layers[0].moe, "cuda")
    cpu = moe_copy(cfg32, model.layers[0].moe, "cpu")
    rows = xs.float()
    over = torch.cat([rows[:1].expand(3 * MOE_OVERFLOW // 4, -1),
                      rows[1:MOE_OVERFLOW // 4 + 1]])
    E, k = cfg.num_experts, cfg.experts_per_token
    out, flips = {}, 0
    for name, x in [(f"B={b}", rows[:b]) for b in MOE_BATCHES] + \
            [(f"overflow T={MOE_OVERFLOW}", over)]:
        T = x.shape[0]
        active = torch.arange(T) % 3 != 2
        C = moe_mod._capacity(T, k, E, cfg.moe_capacity_factor)
        p = plan.plan_for_batch(T)
        got = {}
        for where, moe in (("cuda", dev), ("cpu", cpu)):
            xd, ad = x.to(where), active.to(where)
            gates = torch.softmax(xd @ moe.router, dim=-1)
            disp = moe_mod.moe_dispatch(gates, k, C, ad)
            y, _, tr = moe_mod.apply_moe_ffn(moe, xd, cfg32, plan=p,
                                             active_mask=ad,
                                             collect_trace=True)
            got[where] = [t.cpu() for t in (*disp, y, tr)]
        (te, _, sl, kp, y, tr), (te0, _, sl0, kp0, y0, tr0) = \
            got["cuda"], got["cpu"]
        for what, a, b in (("tope", te, te0), ("slot", sl, sl0),
                           ("keep", kp, kp0)):
            if not torch.equal(a, b):
                raise AssertionError(f"{cfg.name} {name}: {what} differs "
                                     f"between the card and the CPU")
        if name.startswith("overflow") and bool(kp0.all()):
            raise AssertionError(f"{cfg.name} {name}: no entry dropped")
        if tr.dim() == 1:
            same = torch.equal(tr, tr0)
            n_flip = 0
        else:
            near = moe_near_flips(cfg32, cpu, x.cpu(), active, C, p)
            diff = (tr[:, 1:] - tr0[:, 1:]).abs()
            same = torch.equal(tr[:, 0], tr0[:, 0]) and bool(
                (diff <= near).all())
            n_flip = int(diff.sum())
        if not same:
            raise AssertionError(f"{cfg.name} {name}: traces differ "
                                 f"beyond near-threshold activations")
        scale = float(y0.abs().max())
        err = float((y - y0).abs().max())
        if err > 2e-4 * scale:
            raise AssertionError(f"{cfg.name} {name}: max |y diff| {err:.3e}"
                                 f" at output scale {scale:.3e}")
        flips += n_flip
        out[name] = dict(T=T, C=C, dropped=int((~kp0).sum()),
                         max_abs_err=err, scale=scale, near_flips=n_flip)
        print(f"    layer 0 {name}: C {C}, {out[name]['dropped']} entries "
              f"not kept, {int((~active).sum())} dead rows; tope/slot/keep "
              f"and trace {tuple(tr.shape)} identical"
              + (f" but {n_flip} near-threshold counts" if n_flip else "")
              + f"; max |y diff| {err:.3e} at scale {scale:.3e}")
    del dev, cpu
    free_cuda()
    return out


def moe_serve_pair(cfg, sd, hw):
    """The model of `cfg` at storage dtype `sd`, on the planner's plan
    under profile `hw`, serving phase 4's stream graphed and eagerly
    (the eager run records layer 0's MoE input). Returns (model, plan,
    runs, recorded rows of x)."""
    from repro_torch.models import moe as moe_mod
    free_cuda()
    t0 = time.perf_counter()
    model, plan = prepared(cfg, backend="jnp", sd=sd, hw=hw)
    torch.cuda.synchronize()
    p1 = plan.plan_for_batch(1)
    print(f"  {sd}, {hw.name}: model built and prepared in "
          f"{time.perf_counter() - t0:.1f} s; plan at B=1: n_hot {p1.n_hot}, "
          f"k_cold {p1.k_cold}, cluster size {p1.cluster_size}, "
          f"n_expert_hot {p1.n_expert_hot}")
    xs, inner, moe0 = [], moe_mod.apply_moe_ffn, model.layers[0].moe

    def spy(moe, x, *a, **k):              # layer 0's MoE input
        if moe is moe0:
            xs.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return inner(moe, x, *a, **k)
    runs = {"graph": arch_serve(cfg, model, plan, True, backend="jnp",
                                profile_new=3),
            "eager": arch_serve(cfg, model, plan, False,
                                (moe_mod, "apply_moe_ffn", spy),
                                backend="jnp", profile_new=3)}
    g, e = runs["graph"], runs["eager"]
    for name, a, b in zip(("tokens", "traces", "TokenStats"),
                          g["outputs"], e["outputs"]):
        if a != b:
            raise AssertionError(f"{cfg.name} {sd}: graphed and eager "
                                 f"{name} differ")
    shape = np.array(g["outputs"][1][0]).shape
    print(f"  {sd}: graphed and eager: tokens, {g['steps']} per-step traces "
          f"{shape} and every TokenStats field identical; fused_cold_ffn "
          f"launches {g['launches']} in both")
    for name, r in runs.items():
        p = r["profile"]
        dev = p.get("device_ms_per_step")
        rep = p.get("replay_ms_per_step")
        print(f"    {name}: wall per step median {r['wall_ms_median']:.2f} ms "
              f"(first {r['wall_ms_first']:.2f}); device busy per step "
              + ("not measured" if dev is None else f"{dev:.3f} ms")
              + ("" if rep is None else f", replay span {rep:.3f} ms")
              + f"; {p.get('kernels_per_step', 0):.0f} kernels per step; "
              f"storage plane {r['plane_ms']:.2f} ms per step (host); peak "
              f"device memory {r['peak_bytes'] / 2**30:.2f} GiB")
    return model, plan, runs, torch.cat(xs)


def phase_moe():
    """The moe family at full width, bf16, random weights from seed 0, on
    the planner's plan under the PHONE profile: deepseek-moe-16b (whole
    experts, 2 of 28 layers) at fp16 and int8 storage, and
    turbosparse-mixtral-47b (two-level, relu mode, 1 of 32 layers). Each
    serves phase 4's stream graphed and eagerly (tokens, traces and
    TokenStats identical, no fused_cold_ffn launch), then layer 0's
    apply_moe_ffn runs in fp32 on the card against the CPU; a pallas
    engine on a moe config raises before any step."""
    out = {}
    for arch, layers, served in MOE:
        cfg = get_config(arch).replace(num_layers=layers)
        nbytes = moe_weights_bytes(cfg)
        print(f"== phase moe: {arch} at full width (D {cfg.d_model}, "
              f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-"
              f"{cfg.experts_per_token}, {cfg.num_shared_experts} shared, "
              f"{cfg.activation}, {cfg.sparse_ffn.mode} mode, "
              f"{'two-level' if cfg.moe_intra_expert else 'whole experts'}"
              f"), cut to {layers} of {get_config(arch).num_layers} layers, "
              f"{cfg.param_dtype}; expert weights read per step "
              f"{nbytes / 1e9:.2f} GB, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms")
        res = dict(layers=layers, weight_bytes_per_step=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, serve={})
        for sd, hw in served:
            key = sd if hw is PHONE else f"{sd}, {hw.name}"
            model, plan, runs, xs = moe_serve_pair(cfg, sd, hw)
            res["serve"][key] = {
                m: dict(launches=r["launches"], steps=r["steps"],
                        wall_ms_median=r["wall_ms_median"],
                        wall_ms_first=r["wall_ms_first"],
                        plane_ms=r["plane_ms"], peak_bytes=r["peak_bytes"],
                        **{k: r["profile"].get(k) for k in (
                            "device_ms_per_step", "replay_ms_per_step",
                            "kernels_per_step", "wall_ms_per_step")})
                for m, r in runs.items()}
            if sd == "fp16":
                if xs.shape[0] < MOE_OVERFLOW // 4 + 1:
                    raise AssertionError(f"{arch}: {xs.shape[0]} rows of x")
                res.setdefault("plan_b1", {})[key] = dataclasses.asdict(
                    plan.plan_for_batch(1))
                res.setdefault("layer0", {})[key] = moe_layer_check(
                    cfg, model, plan, xs)
                try:
                    ServeEngine(cfg, model, plan, backend="pallas")
                except ValueError as e:
                    print(f"  ServeEngine(..., backend='pallas') raises "
                          f"before any step: {e}")
                else:
                    raise AssertionError(f"{arch}: a pallas engine was "
                                         f"built")
            del model, xs
            free_cuda()
        out[arch] = res
    return out


# ------------------------------------------------------------ phase plan ----

# (arch, layers kept): the offline planner's loop at full width, bf16;
# bamboo-7b is cut from 32 to 8 layers to keep the script inside half
# its time limit
PLAN_MODELS = (("smollm-135m", None), ("bamboo-7b", 8))
PLAN_BUCKETS = (1, 2, 4, 8, 16, 32)
RIDGE = 1e-2                 # calibrate_predictor's default


def plan_tokens(cfg, device):
    """The profiling corpus: four (4, 64) batches of the seeded synthetic
    pipeline on `device`."""
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=0))
    return [shard_batch(data.batch(), device)["tokens"] for _ in range(4)]


def kernel_rows(cfg, model, X0, source):
    """The reference's kernel calibration (benchmarks/bench_kernels.py) on
    the card: at each bucket, on both of its plan legs (the serving
    operating point, hot 0.125 / cold 0.10, and the cold-heavy 0.125 /
    0.50, scaled to the bucket by scale_plan_for_batch), ffn_dense and
    the n_hot = 0 ffn_hybrid (the fused kernel), on layer 0's weights and
    profiled FFN inputs, each in a CUDA graph timed with CUDA events; rows
    carry the reference's work counts (2*B*n*R*D flops,
    total_cold*R*D*bytes gathered). Each cold call's fused_cold_ffn is
    first held against its plain version on the same operands."""
    ffn = model.layers[0].ffn
    N, R, D = ffn.w.shape
    es = ffn.w.element_size()
    cs = cfg.sparse_ffn.cluster_size
    rows = []
    for (leg, cold_ratio), B in itertools.product(
            (("op", 0.10), ("deep", 0.50)), PLAN_BUCKETS):
        base = make_plan(N, 0.125, cold_ratio, cs)
        cold = dataclasses.replace(scale_plan_for_batch(base, N, B, cs),
                                   n_hot=0, backend="pallas")
        x = X0[:B].contiguous()
        wc, A, Bp = layer_operands(model.layers[0].ffn, cold)
        kc = cold.clusters_per_group
        err = hold_kernel(
            f"{cfg.name} {leg} B={B} (nc_g {wc.shape[1]}, kc {kc})", x, wc,
            A, Bp, torch.ones(B, dtype=torch.bool, device=x.device),
            cfg.activation, cfg.sparse_ffn.mode, kc, rounding=True)
        t_dense = graph_time_ms(lambda: ffn_dense(ffn.w, x, cfg.activation))
        t_cold = graph_time_ms(lambda: ffn_hybrid(
            ffn.w, ffn.pred, x, cfg.activation, cfg.sparse_ffn.mode, cold))
        n_cold = cold.total_cold
        r = dict(leg=leg, batch=B, D=D, N=N, cs=cs, k_cold=cold.k_cold,
                 t_dense_s=t_dense / 1e3, t_pallas_cold_s=t_cold / 1e3,
                 dense_flops=2.0 * B * N * R * D,
                 cold_flops=2.0 * B * n_cold * R * D,
                 gather_bytes=float(n_cold * R * D * es), source=source,
                 max_abs_err=err)
        rows.append(r)
        print(f"    {leg:4s} B={B:2d}: ffn_dense {t_dense * 1e3:8.2f} us "
              f"({r['dense_flops'] / t_dense / 1e9:.2f} TFLOP/s), cold path "
              f"(n_hot 0, {n_cold} of {N} neurons) {t_cold * 1e3:8.2f} us "
              f"({r['cold_flops'] / t_cold / 1e9:.3f} TFLOP/s, "
              f"{r['gather_bytes'] / t_cold / 1e6:.1f} GB/s gathered)")
    return rows


def layer0_fp32(model, cfg, device):
    """A one-layer fp32 copy of the model (embedding, layer 0, head) on
    `device`."""
    from repro_torch.models.dense import DenseModel
    cfg1 = cfg.replace(num_layers=1, param_dtype="float32",
                       compute_dtype="float32")
    m = DenseModel(cfg1, torch.device(device))
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(src[name])
    return cfg1, m


def layer0_checks(cfg, model, tokens):
    """Layer 0 in fp32, card against the CPU, same weights and tokens:
    counts identical but for near-threshold pairs (`near_threshold`, with
    the measured difference of the two X), X within 1e-5 of its scale, H
    identical but for flagged pairs, and the card's calibrated A@B within
    1e-6 relative of a numpy fp64 recompute from the card's X and H."""
    cfg1, dev = layer0_fp32(model, cfg, "cuda")
    _, cpu = layer0_fp32(model, cfg, "cpu")
    toks_cpu = [t.cpu() for t in tokens]
    c_dev, n = profile_activations(dev, cfg1, tokens)
    c_cpu, _ = profile_activations(cpu, cfg1, toks_cpu)
    X, H = (a[0].cpu() for a in profile_ffn_inputs(dev, cfg1, tokens))
    X0, H0 = (a[0] for a in profile_ffn_inputs(cpu, cfg1, toks_cpu))
    dx = float((X - X0).abs().max())
    scale = float(X0.abs().max())
    if dx > 1e-5 * scale:
        raise AssertionError(f"{cfg.name} layer 0: X differs by {dx:.3e}, "
                             f"past 1e-5 of its scale {scale:.3e}")
    flags = near_threshold(X0, cpu.layers[0].ffn.w, cfg.activation,
                           cfg.sparse_ffn.mode, dx=dx)
    h_diff = H != H0
    if bool(h_diff[~flags].any()):
        raise AssertionError(f"{cfg.name} layer 0: H differs at "
                             f"{int(h_diff[~flags].sum())} unflagged pairs")
    per = flags.sum(0).numpy()
    diff = np.abs(c_dev[0] - c_cpu[0])
    if (diff > per).any() or (diff[per == 0] != 0).any():
        raise AssertionError(f"{cfg.name} layer 0: counts differ past the "
                             f"flags at {np.nonzero(diff > per)[0][:8]}")
    del cpu
    t0 = time.perf_counter()
    calibrate_predictor(dev, cfg1, tokens)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    ffn = dev.layers[0].ffn
    got = (ffn.pred_A.double() @ ffn.pred_B.double()).cpu().numpy()
    t0 = time.perf_counter()
    Xd = X.double().numpy()
    Y = H.numpy().astype(np.float64) * 2.0 - 1.0
    T, D = Xd.shape
    W = np.linalg.solve(Xd.T @ Xd + RIDGE * T * np.eye(D), Xd.T @ Y)
    r = min(cfg.sparse_ffn.predictor_rank, *W.shape)
    if W.shape[0] <= W.shape[1]:
        U = np.linalg.eigh(W @ W.T)[1][:, ::-1][:, :r]
        want = U @ (U.T @ W)
    else:
        V = np.linalg.eigh(W.T @ W)[1][:, ::-1][:, :r]
        want = (W @ V) @ V.T
    t_host = time.perf_counter() - t0
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if rel > 1e-6:
        raise AssertionError(f"{cfg.name} layer 0: calibrated A@B off the "
                             f"fp64 recompute by {rel:.3e} relative")
    out = dict(n_tokens=n, flagged=int(flags.sum()),
               h_differ=int(h_diff.sum()),
               counts_differ=int((diff != 0).sum()), x_max_diff=dx,
               x_scale=scale, ab_rel_err=rel, card_calibrate_s=t_card,
               host_recompute_s=t_host)
    print(f"  layer 0 in fp32, card against CPU ({n} tokens): X within "
          f"{dx:.3e} of scale {scale:.3e}; {out['flagged']} near-threshold "
          f"pairs, H differs at {out['h_differ']}, counts at "
          f"{out['counts_differ']} neurons (all flagged); calibrated A@B "
          f"within {rel:.3e} of the numpy fp64 recompute (card "
          f"{t_card:.2f} s, host {t_host:.2f} s)")
    return out


def modeled_rate(cfg, model, plan, calls, hw):
    """Decode tok/s of a serve's recorded storage-plane calls, repriced
    in order through a fresh plane on hardware profile `hw` (the engine's
    other defaults), and the repriced TokenStats."""
    plane = StoragePlane(cfg, model, plan, spec=POWERINFER2, hw=hw)
    try:
        stats = [plane.step(t, *a, **k) for t, a, k in calls]
    finally:
        plane.close()
    return sum(s.batch for s in stats) / sum(
        s.effective_s for s in stats), stats


def plan_serves(cfg, model, plan):
    """The calibrated plan served graphed and eagerly (the eager serve
    records layer 0's x): tokens, ids and TokenStats identical. The
    modeled rate under each profile reprices the graphed serve's
    storage-plane calls: under the calibrated one it must give the
    serve's own TokenStats, under PHONE it is PHONE's rate for the same
    steps (the two plans are asserted identical)."""
    spy, xs = x_spy(model)
    runs = {"graph": arch_serve(cfg, model, plan, True, profiled=True),
            "eager": arch_serve(cfg, model, plan, False, spy,
                                profiled=True)}
    g = runs["graph"]["outputs"]
    for name, a, b in zip(("tokens", "traces", "TokenStats"), g,
                          runs["eager"]["outputs"]):
        if a != b:
            raise AssertionError(f"{cfg.name}: graphed and eager {name} of "
                                 f"the calibrated plan differ")
    # the stream's steps, then the profile's: reprice the stream's
    calls = runs["graph"]["calls"][:len(g[2])]
    rate, again = modeled_rate(cfg, model, plan, calls, plan.hardware)
    if again != g[2]:
        raise AssertionError(f"{cfg.name}: repricing the serve's calls "
                             f"did not give its TokenStats")
    rates = {"calibrated": rate,
             "PHONE": modeled_rate(cfg, model, plan, calls, PHONE)[0]}
    for name, r in runs.items():
        dev = r["profile"].get("device_ms_per_step")
        print(f"    {name}: wall per step median {r['wall_ms_median']:.2f} "
              f"ms (first {r['wall_ms_first']:.2f}); device busy per step "
              + ("not measured" if dev is None else f"{dev:.3f} ms")
              + f"; storage plane {r['plane_ms']:.2f} ms per step (host); "
              f"launches {r['launches']} = {cfg.num_layers} x "
              f"{r['cold_steps']} of {r['steps']} steps with a cold path")
    print(f"    modeled decode rate of these steps: {rates['calibrated']:.2f} "
          f"tok/s under the calibrated profile, {rates['PHONE']:.2f} tok/s "
          f"under PHONE")
    for r in runs.values():
        del r["calls"]
    return runs, rates, torch.cat(xs)


def phase_plan(card):
    """The offline planner's loop at full width, bf16, random weights from
    seed 0: profile the synthetic corpus, predictor_quality before and
    after calibrate_predictor, time the kernels into a KernelCalibration,
    plan on the calibrated profile, check layer 0 in fp32 on the card
    against the CPU, permute, serve graphed and eagerly through
    fused_cold_ffn, then hold the kernel on layer 0 at each bucket whose
    plan keeps a cold path, on x from the serve."""
    out = {}
    for arch, layers in PLAN_MODELS:
        free_cuda()
        cfg = arch_cfg(arch, layers)
        cut = "" if layers is None else \
            f", cut to {layers} of {get_config(arch).num_layers} layers"
        print(f"== phase plan: {arch} at full width (D {cfg.d_model}, d_ff "
              f"{cfg.d_ff}, {cfg.num_layers} layers{cut}, {cfg.param_dtype}, "
              f"{cfg.activation}, {cfg.sparse_ffn.mode} mode, rank "
              f"{cfg.sparse_ffn.predictor_rank})")
        fam = serving_family(cfg)
        model = fam.make_model(cfg, device="cuda", seed=0)
        tokens = plan_tokens(cfg, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, n_tok = profile_activations(model, cfg, tokens)
        t_profile = time.perf_counter() - t0
        freqs = (counts / n_tok).astype(np.float32)
        q0 = predictor_quality(model, cfg, tokens)
        t0 = time.perf_counter()
        X, H = profile_ffn_inputs(model, cfg, tokens)
        torch.cuda.synchronize()
        t_inputs = time.perf_counter() - t0
        del X, H
        t0 = time.perf_counter()
        calibrate_predictor(model, cfg, tokens)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        q1 = predictor_quality(model, cfg, tokens)
        print(f"  profile of {n_tok} tokens {t_profile:.3f} s; mean "
              f"activation frequency {freqs.mean():.4f}; calibrate_predictor "
              f"{t_cal:.2f} s ({t_cal / cfg.num_layers:.3f} s per layer, of "
              f"it {t_inputs:.3f} s profile_ffn_inputs); predictor recall "
              f"{q0:.4f} before, {q1:.4f} after")
        if not q1 > q0:
            raise AssertionError(f"{arch}: calibration did not raise the "
                                 f"predictor's recall ({q0} -> {q1})")
        phone_plan = build_plan(cfg, freqs, hw=PHONE, backend="pallas")
        X0 = profile_ffn_inputs(model, cfg, tokens[:1])[0][0]
        print(f"  kernel calibration on layer 0 ({card}):")
        rows = kernel_rows(cfg, model, X0, card)
        cal = KernelCalibration.from_rows(rows)
        hw = cal.hardware(PHONE)
        plan = build_plan(cfg, freqs, hw=hw, backend="pallas")
        if plan.plans != phone_plan.plans or not np.array_equal(
                plan.neuron_order, phone_plan.neuron_order):
            raise AssertionError(f"{arch}: the calibrated profile moved the "
                                 f"plan")
        p1 = plan.plan_for_batch(1)
        cold_buckets = [b for b, p in sorted(plan.plans.items())
                        if p.n_hot < cfg.d_ff and p.clusters_per_group > 0]
        print(f"  KernelCalibration: dense {cal.dense_flops_per_s / 1e12:.3f} "
              f"TFLOP/s, sparse {cal.sparse_flops_per_s / 1e12:.4f} TFLOP/s, "
              f"gather {cal.gather_bytes_per_s / 1e9:.2f} GB/s; PHONE "
              f"{PHONE.dense_engine_flops / 1e12:.3f} / "
              f"{PHONE.sparse_engine_flops / 1e12:.4f} TFLOP/s; plan "
              f"identical under both (B=1: n_hot {p1.n_hot}, k_cold "
              f"{p1.k_cold}, cs {p1.cluster_size}; buckets with a cold "
              f"path {cold_buckets} of {sorted(plan.plans)})")
        layer0 = layer0_checks(cfg, model, tokens)
        model = fam.prepare_params(model, plan)
        runs, rates, xs = plan_serves(cfg, model, plan)
        if xs.shape[0] < max(cold_buckets, default=0):
            raise AssertionError(f"{arch}: {xs.shape[0]} rows of x")
        print(f"  fused_cold_ffn on layer 0 of the calibrated plan, x from "
              f"the serve, at the buckets with a cold path:")
        kt = arch_kernel(cfg, model.layers[0].ffn, plan.plan_for_batch, xs,
                         cold_buckets, rounding=True)
        out[arch] = dict(
            layers=cfg.num_layers, n_tokens=n_tok, profile_s=t_profile,
            calibrate_s=t_cal, calibrate_s_per_layer=t_cal / cfg.num_layers,
            profile_inputs_s=t_inputs, recall_before=q0, recall_after=q1,
            rows=rows, calibration=dataclasses.asdict(cal), layer0=layer0,
            plan_b1=dataclasses.asdict(p1), cold_buckets=cold_buckets,
            launches=runs["graph"]["launches"], kernels=kt,
            modeled_tok_s=rates,
            serve={m: dict(wall_ms_median=r["wall_ms_median"],
                           wall_ms_first=r["wall_ms_first"],
                           plane_ms=r["plane_ms"], steps=r["steps"],
                           launches=r["launches"],
                           cold_steps=r["cold_steps"],
                           device_ms_per_step=r["profile"].get(
                               "device_ms_per_step"),
                           replay_ms_per_step=r["profile"].get(
                               "replay_ms_per_step"))
                   for m, r in runs.items()})
        del model, xs
    free_cuda()
    return out


# ------------------------------------------------------------ phase tp ----

# gloo ranks that share the one card (NCCL refuses two ranks on one
# device): right, and launched at the per-rank shapes; no multi-GPU speed
TP_WORLD = 4
TP_BUCKETS = (1, 2, 4, 8, 16, 32, 64)  # the plan's buckets, scaled
TP_BATCHES = (1, 4, 32)                # the per-rank kernel's holds
# (key, arch, layers kept (None: all), dtype, tp sizes, per-rank kernel)
TP_DENSE = (("smollm fp32", "smollm-135m", 4, "float32", (1, 2, 4), False),
            ("smollm bf16", "smollm-135m", None, "bfloat16", (1, 2, 4),
             True),
            ("bamboo fp32", "bamboo-7b", 4, "float32", (1, 2), False),
            ("bamboo bf16", "bamboo-7b", 4, "bfloat16", (1, 2), True))
TP_MOE = ("deepseek-moe-16b", 4, "float32")


# this rank's collectives so far and their seconds (spy_collectives)
TP_COLL = {"calls": 0, "seconds": 0.0}


def spy_collectives():
    """Wrap every ShardGroup collective of this process so that it adds
    its call and its seconds to TP_COLL, the device idle before and
    after it, so that the time is the collective's alone. The library's
    collectives wait on nothing of their own; this spy's waits are the
    smoke's."""
    from repro_torch.parallel import ShardGroup

    def timed(fn):
        def run(self, *a, **k):
            if self.size == 1:
                return fn(self, *a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            TP_COLL["seconds"] += time.perf_counter() - t0
            TP_COLL["calls"] += 1
            return out
        return run
    for name in ("all_reduce_f32", "all_gather_ids", "all_gather_cols",
                 "gather_objects", "broadcast", "broadcast_object"):
        setattr(ShardGroup, name, timed(getattr(ShardGroup, name)))


def vocab_bytes(model) -> int:
    """Bytes of the embedding and the untied head a model holds."""
    return sum(t.numel() * t.element_size() for t in (model.embed,
                                                        model.lm_head)
               if t is not None)


def tp_plan(cfg, groups=4):
    """The reference golden's plan (tests/test_distributed.py:166-171):
    the planner's neuron order, make_plan(d_ff, 0.25, 0.25, cs, groups)
    scaled to each bucket."""
    plan = build_plan(cfg, hw=PHONE)
    cs = cfg.sparse_ffn.cluster_size
    base = make_plan(cfg.d_ff, 0.25, 0.25, cs, groups=groups)
    plan.plans = {b: scale_plan_for_batch(base, cfg.d_ff, b, cs)
                  for b in TP_BUCKETS}
    return plan


def tp_cfg(arch, layers, dtype):
    return arch_cfg(arch, layers).replace(param_dtype=dtype,
                                          compute_dtype=dtype)


def tp_model(cfg, plan=None):
    """The family's model on the card from seed 0 (the same weights on
    every rank) and its plan (default the family's on PHONE), prepared as
    build_engine prepares them."""
    fam = serving_family(cfg)
    model = fam.make_model(cfg, device="cuda", seed=0)
    plan = plan or fam.build_plan(cfg, hw=PHONE)
    return fam.prepare_params(model, plan), plan


def tp_serve(engine, record_x=None):
    """Phase 4's stream through `engine` on this rank: tokens, per-step
    stats, the storage plane's calls, walls and collectives (medians per
    step: the first step also opens the group's connections), launches,
    the weights held and the serve's peak above them. With `record_x` (the
    decoding model) every (step, layer)'s FFN input and live mask are
    recorded."""
    from repro_torch.models import blocks
    calls, price = [], engine.storage.step
    engine.storage.step = lambda tr, p, b, c: (
        calls.append((np.array(tr), p, b, c)) or price(tr, p, b, c))
    xs, inner = [], blocks.ffn_apply
    if record_x is not None:
        layer_of = {id(l.ffn.w): i for i, l in enumerate(record_x.layers)}

        def spy(w, pred, x, act, scfg, plan, *a, **k):
            if plan is not None:
                xs.append((layer_of[id(w)],
                           x.detach().reshape(-1, x.shape[-1]).clone(),
                           k["active_mask"].clone()))
            return inner(w, pred, x, act, scfg, plan, *a, **k)
        blocks.ffn_apply = spy
    per_step, step = [], engine.step

    def counted():
        """engine.step, with the step's collectives and their seconds"""
        c0, s0 = TP_COLL["calls"], TP_COLL["seconds"]
        out = step()
        if out is not None:
            per_step.append((TP_COLL["calls"] - c0, TP_COLL["seconds"] - s0))
        return out
    engine.step = counted
    ops.fused_cold_ffn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        toks, stats, walls = serve_stream(engine, engine.cfg.vocab_size)
    finally:
        blocks.ffn_apply = inner
    steps = len(stats)
    calls_ps, secs_ps = np.array(per_step, dtype=float).T
    return dict(
        toks=toks, stats=stats, calls=calls, xs=xs, steps=steps,
        launches=ops.fused_cold_ffn.launches,
        wall_ms=float(np.median(walls) * 1e3),
        coll_per_step=float(np.median(calls_ps)),
        coll_ms_per_step=float(np.median(secs_ps) * 1e3),
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        weight_bytes=sum(t.numel() * t.element_size()
                         for t in itertools.chain(engine.model.parameters(),
                                                  engine.model.buffers())))


def tp_same_x(cfg, model, run):
    """Every (step, layer) of `run`: the group's gathered ids against the
    unsharded selection (the plain version over the whole model's layer)
    on the same x and live mask, identical but for fp64-confirmed near
    ties. Returns the near-tie positions."""
    L, near_at = cfg.num_layers, []
    for i, (l, x, mask) in enumerate(run["xs"]):
        s = i // L
        trace, p = run["calls"][s][:2]
        wc, A, Bp = layer_operands(model.layers[l].ffn, p)
        ids = torch.from_numpy(trace[l]).to(x.device)
        _, ir = fused_cold_ffn_ref(x, wc, A, Bp, mask.float(),
                                   activation=cfg.activation,
                                   cats=cfg.sparse_ffn.mode == "cats",
                                   kc=p.clusters_per_group)
        near, real = pick_disagreements(ids, ir, x, wc, A, Bp, mask.float())
        if real:
            raise AssertionError(f"{cfg.name} step {s} layer {l}: the "
                                 f"group picked {real} against the "
                                 f"unsharded selection on the same x")
        near_at += [(s, l)] * bool(near)
    return near_at


def tp_rank_kernel(cfg, ffn, plan_for, shard, xs, rounding=None):
    """This rank's fused_cold_ffn on the FFN module `ffn`'s (layer 0's)
    g_loc groups and rows of x from its serve or decode, at each B of
    TP_BATCHES under the plan `plan_for(B)`, against its plain version
    (hold_kernel; with the rounding allowance for relu2, or as
    `rounding` says); then its time per call (eager and in a CUDA
    graph), the plain version's and the bound. The ranks time in turn,
    the others waiting at a barrier, so no two share the card."""
    from repro_torch.parallel import cold_range
    _, R, D = ffn.w.shape
    mode = cfg.sparse_ffn.mode
    if rounding is None:
        rounding = cfg.activation == "relu2"
    out, calls = {}, {}
    for B in TP_BATCHES:
        p = plan_for(B)
        sl = ffn.rows.local(*cold_range(p, cfg.d_ff, shard.rank,
                                        shard.size))
        g_loc, cs, kc = p.groups // shard.size, p.cluster_size, \
            p.clusters_per_group
        wc = ffn.w[sl].reshape(g_loc, -1, cs, R, D)
        A, Bp = ffn.pred_A, ffn.pred_B[:, sl]
        x = xs[:B].contiguous()
        mask = torch.ones(B, dtype=torch.bool, device=x.device)
        name = (f"rank {shard.rank} of {shard.size}, layer 0 B={B} (g_loc "
                f"{g_loc}, nc_g {wc.shape[1]}, cs {cs}, kc {kc})")
        # relu2 on random weights: |y| up to 1e4 from sums that cancel,
        # held as phase plan holds bamboo (plus `rounding_allowance`)
        err = hold_kernel(name, x, wc, A, Bp, mask, cfg.activation, mode, kc,
                          rounding=rounding)
        s = dict(D=D, r=A.shape[1], cs=cs, G=g_loc, nc_g=wc.shape[1], R=R,
                 kc=kc)
        out[B] = dict(max_abs_err=err, shape=s, g_loc=g_loc)
        calls[B] = (
            lambda x=x, wc=wc, Bp=Bp, kc=kc: ops.fused_cold_ffn(
                x, wc, A, Bp, activation=cfg.activation, mode=mode, kc=kc),
            lambda x=x, wc=wc, Bp=Bp, kc=kc, m=mask.float():
                fused_cold_ffn_ref(x, wc, A, Bp, m, activation=cfg.activation,
                                   cats=mode == "cats", kc=kc))
    for r in range(shard.size):
        if r == shard.rank:
            for B, t in out.items():
                call, plain = calls[B]
                b_ms, b_by = bound(B, xs.dtype, s=t["shape"])
                t.update(ms=cuda_time_ms(call), graph_ms=graph_time_ms(call),
                         plain_ms=cuda_time_ms(plain), bound_ms=b_ms,
                         bound_by=b_by)
        torch.distributed.barrier(group=shard.group)
    return out


def tp_dense(world, groups, arch, layers, dtype, sizes, kernel=False):
    """One dense-family model at full width, the golden's plan of groups=4,
    phase 4's stream at each tp of `sizes` (pallas, eager) on ranks
    [0, tp). In fp32 the parent holds every tp's tokens, traces and
    TokenStats (the tp=1 trace repriced at n_shards = tp) to tp=1's; in
    bf16 rank 0 holds every (step, layer)'s ids to the unsharded selection
    on the same x (near ties aside) and the decodes' agreement is counted.
    Each rank launches fused_cold_ffn once per layer and step."""
    from repro_torch.bridge import shard_model
    cfg = tp_cfg(arch, layers, dtype)
    exact = dtype == "float32"
    # a rank outside every group of the case builds nothing
    model, plan = tp_model(cfg, tp_plan(cfg)) \
        if groups[max(sizes)].member else (None, None)
    runs = {}
    for n in sizes:
        torch.distributed.barrier(group=world.group)
        grp = groups[n]
        if not grp.member:
            continue
        free_cuda()
        local = shard_model(model, plan, grp)
        engine = ServeEngine(cfg, local, plan, backend="pallas",
                             temperature=0.0, seed=0, ctx_budget=CTX,
                             cuda_graphs=False,
                             shard=grp if n > 1 else None)
        run = tp_serve(engine, record_x=None if exact else local)
        engine.close()
        rows = local.layers[0].ffn.rows
        run.update(policy=engine.graph_policy, kv_heads=local.kv_heads,
                   ffn_rows=cfg.d_ff if rows is None else len(rows.ids),
                   vocab_bytes=vocab_bytes(local))
        if run["launches"] != cfg.num_layers * run["steps"]:
            raise AssertionError(f"{cfg.name} tp={n} rank {grp.rank}: "
                                 f"{run['launches']} fused_cold_ffn "
                                 f"launches for {run['steps']} steps of "
                                 f"{cfg.num_layers} layers")
        if not exact:
            t0 = time.perf_counter()
            run["near"] = tp_same_x(cfg, model, run) if grp.rank == 0 \
                else None
            run["same_x_s"] = time.perf_counter() - t0
            if kernel and n > 1:
                xs0 = torch.cat([x for l, x, _ in run["xs"] if l == 0])
                run["kernel"] = tp_rank_kernel(cfg, local.layers[0].ffn,
                                               plan.plan_for_batch, grp, xs0)
        if n == 1:
            run["share"] = tp_ffn_share(cfg, plan, sizes[1:])
        if n == 1 and exact:
            # the tp=1 trace repriced at n shards: the stats tp=n must show
            run["repriced"] = {}
            for m in sizes[1:]:
                plane = StoragePlane(cfg, model, plan, spec=POWERINFER2,
                                     n_shards=m)
                run["repriced"][m] = [plane.step(tr, p, b, c)
                                      for tr, p, b, c in run["calls"]]
                plane.close()
        run["traces"] = [c[0] for c in run.pop("calls")]
        run.pop("xs")
        runs[n] = run
        del local, engine
    return cfg, runs


def tp_ffn_share(cfg, plan, sizes):
    """The share of a layer's FFN rows that each rank holds (the union
    over the plan's buckets, `parallel.shard_layout`) at each tp of
    `sizes`, under `plan` (the golden's groups=4) and under the family's
    PHONE plan (groups=1: the cold region whole on every rank)."""
    from repro_torch.parallel import shard_layout
    plans = {"groups=4": plan, "PHONE plan": build_plan(cfg, hw=PHONE)}
    return {(name, n): [len(shard_layout(cfg, p, r, n).ffn.ids) / cfg.d_ff
                        for r in range(n)]
            for name, p in plans.items() for n in sizes}


def tp_moe(groups, arch, layers, dtype):
    """An moe model at full width, ep=1 on rank 0 and ep=2 on ranks
    [0, 2); the parent holds ep=2's tokens, traces and TokenStats (the
    ep=1 trace repriced at n_shards = 2) to ep=1's. Ranks 2 and 3 build
    nothing."""
    from repro_torch.bridge import shard_model
    cfg = tp_cfg(arch, layers, dtype)
    runs = {}
    if not groups[2].member:
        return cfg, runs
    model, plan = tp_model(cfg)
    for n in (1, 2):
        grp = groups[n]
        if n == 2:                    # rank 1 waits out rank 0's ep=1
            torch.distributed.barrier(group=grp.group)
        if not grp.member:
            continue
        free_cuda()
        local = shard_model(model, plan, grp)
        if n == 2:                    # the rank serves its slice alone
            model = None
            free_cuda()
        engine = ServeEngine(cfg, local, plan, temperature=0.0, seed=0,
                             ctx_budget=CTX, cuda_graphs=False,
                             shard=grp if n > 1 else None)
        run = tp_serve(engine)
        engine.close()
        run["experts"] = local.layers[0].moe.experts.shape[0]
        if n == 1:
            plane = StoragePlane(cfg, model, plan, spec=POWERINFER2,
                                 n_shards=2)
            run["repriced"] = [plane.step(tr, p, b, c)
                               for tr, p, b, c in run["calls"]]
            plane.close()
        run["traces"] = [c[0] for c in run.pop("calls")]
        run.pop("xs")
        runs[n] = run
        del local, engine
    return cfg, runs


def tp_dp(world, cfg):
    """dp=2 x tp=2 over the four ranks against dp=2 on rank 0 alone:
    FLEET_STREAM's prompts, all arriving at once (as the reference's dp
    golden has them: tp=2 planes price another modeled clock, so
    staggered arrivals would meet other batches), their tokens for the
    parent to hold."""
    from repro_torch.bridge import shard_model
    from repro_torch.parallel import ShardGroup
    model, plan = tp_model(cfg, tp_plan(cfg))
    prompts = fleet_prompts(cfg.vocab_size)
    out = {}
    for name in ("dp2", "dp2tp2"):
        torch.distributed.barrier(group=world.group)
        if name == "dp2" and world.rank != 0:
            continue
        free_cuda()
        grid = name == "dp2tp2"
        local = shard_model(model, plan, ShardGroup(world.rank % 2, 2)) \
            if grid else model
        engine = ServeEngine(cfg, local, plan, backend="pallas",
                             temperature=0.0, seed=0, ctx_budget=CTX,
                             cuda_graphs=False, dp=2,
                             shard=world if grid else None)
        spent = lambda: TP_COLL["seconds"]
        uids = [engine.submit(p, max_new=MAX_NEW, arrival_time=i * 1e-6)
                for i, p in enumerate(prompts)]
        walls, colls = [], []
        while True:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), spent()
            r = engine.step()
            torch.cuda.synchronize()
            if r is None:
                break
            walls.append(time.perf_counter() - t0)
            colls.append(spent() - c0)
        out[name] = dict(
            toks={u: list(engine.sched.sequences[u].generated)
                  for u in uids},
            replicas=sorted({a for a, _ in engine.router.assignment.values()}),
            wall_ms=float(np.median(walls) * 1e3), steps=len(walls),
            coll_ms_per_step=float(np.median(colls) * 1e3))
        engine.close()
    return out


def tp_rank(world):
    """Every case of phase tp on this rank of the gloo world (all ranks on
    cuda:0); its results for the parent to hold and print."""
    from repro_torch.parallel import replica_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    spy_collectives()
    groups = {n: replica_groups(world, TP_WORLD // n, n)[0]
              for n in (1, 2, 4)}
    out, secs = {}, {}
    for key, arch, layers, dtype, sizes, kernel in TP_DENSE:
        t0 = time.perf_counter()
        cfg, runs = tp_dense(world, groups, arch, layers, dtype, sizes,
                             kernel)
        out[key] = dict(cfg=(cfg.name, cfg.num_layers, cfg.d_model,
                             cfg.num_heads, cfg.num_kv_heads), runs=runs)
        secs[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, runs = tp_moe(groups, *TP_MOE)
    out["moe"] = dict(cfg=(cfg.name, cfg.num_layers, cfg.d_model,
                           cfg.num_experts), runs=runs)
    secs["moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dp"] = tp_dp(world, tp_cfg("smollm-135m", 4, "float32"))
    secs["dp"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def tp_hold_dense(key, runs):
    """Hold one TP_DENSE case's per-rank results (see tp_dense) and print
    them; the summary's rows by tp."""
    base = runs[0][1]
    exact = "fp32" in key
    rows = {}
    for n in sorted(runs[0]):
        per = [r[n] for r in runs if n in r]
        if len(per) != n:
            raise AssertionError(f"{key} tp={n}: {len(per)} ranks ran")
        r0 = per[0]
        for i, r in enumerate(per):
            if r["toks"] != r0["toks"] or any(
                    not np.array_equal(a, b)
                    for a, b in zip(r["traces"], r0["traces"])):
                raise AssertionError(f"{key} tp={n}: rank {i} decoded "
                                     f"other tokens or ids than rank 0")
        same_toks = r0["toks"] == base["toks"]
        same_ids = sum(np.array_equal(a, b)
                       for a, b in zip(r0["traces"], base["traces"]))
        pairs = sum(len(t) for t in base["traces"])
        same_pairs = sum(np.array_equal(a[l], b[l]) for a, b in
                         zip(r0["traces"], base["traces"])
                         for l in range(min(len(a), len(b))))
        if exact:
            if not same_toks or same_ids != len(base["traces"]) \
                    or len(r0["traces"]) != len(base["traces"]):
                raise AssertionError(f"{key} tp={n}: tokens or ids differ "
                                     f"from tp=1")
            if n > 1:
                want = [dataclasses.asdict(s) for s in base["repriced"][n]]
                if [dataclasses.asdict(s) for s in r0["stats"]] != want:
                    raise AssertionError(f"{key} tp={n}: TokenStats differ "
                                         f"from the tp=1 trace repriced at "
                                         f"{n} shards")
                e1 = sum(s.effective_s for s in base["stats"])
                en = sum(s.effective_s for s in r0["stats"])
                if en > 1.01 * e1 or any(
                        abs(s.io_total_s - sum(h.io_s for h in s.shards))
                        > 1e-12 for s in r0["stats"]):
                    raise AssertionError(f"{key} tp={n}: per-shard "
                                         f"accounting ({en} s against {e1})")
            verdict = "tokens, ids and TokenStats identical to tp=1"
        else:
            verdict = (f"ids = the unsharded selection on the same x at every "
                       f"(step, layer) (near ties at {r0['near']}); tokens "
                       f"{'identical to' if same_toks else 'differ from'} "
                       f"tp=1's, ids identical at {same_pairs} of {pairs} "
                       f"(step, layer) (x drifts in bf16)")
        print(f"    tp={n}: {r0['policy']}; kv heads per rank "
              f"{r0['kv_heads']}; FFN rows per rank "
              + ", ".join(str(r["ffn_rows"]) for r in per)
              + f" of {base['ffn_rows']}; {verdict}")
        for i, r in enumerate(per):
            print(f"      rank {i}: wall {r['wall_ms']:.2f} ms/step (median "
                  f"of {r['steps']}), collectives {r['coll_per_step']:.1f} "
                  f"per step taking {r['coll_ms_per_step']:.2f} ms, "
                  f"fused_cold_ffn {r['launches'] // r['steps']} per step, "
                  f"weights {r['weight_bytes'] / 2**20:.1f} MiB (embedding "
                  f"and head {r['vocab_bytes'] / 2**20:.1f} MiB) + serve "
                  f"peak {r['peak_bytes'] / 2**20:.1f} MiB")
            for B, t in r.get("kernel", {}).items():
                print(f"      rank {i} layer 0 B={B:2d} (g_loc {t['g_loc']}): "
                      f"kernel {t['ms'] * 1e3:.2f} us "
                      f"({t['graph_ms'] * 1e3:.2f} in a graph), plain "
                      f"{t['plain_ms'] * 1e3:.2f} us, bound "
                      f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), max "
                      f"|y - plain| {t['max_abs_err']:.3e}")
        rows[n] = dict(
            launches=r0["launches"], steps=r0["steps"],
            ffn_rows=[r["ffn_rows"] for r in per],
            launches_per_step_per_rank=r0["launches"] // r0["steps"],
            tokens_identical=same_toks, ids_identical_steps=same_ids,
            ids_identical_pairs=[same_pairs, pairs],
            wall_ms=[r["wall_ms"] for r in per],
            coll_per_step=[r["coll_per_step"] for r in per],
            coll_ms_per_step=[r["coll_ms_per_step"] for r in per],
            weight_mib=[r["weight_bytes"] / 2**20 for r in per],
            vocab_mib=[r["vocab_bytes"] / 2**20 for r in per],
            peak_mib=[r["peak_bytes"] / 2**20 for r in per],
            kernel={i: r["kernel"] for i, r in enumerate(per)
                    if "kernel" in r})
    for (name, n), share in base["share"].items():
        print(f"    FFN rows a rank holds at tp={n} under the {name}: "
              + ", ".join(f"{f:.3f}" for f in share) + " of the layer's")
    return rows


def phase_tp(card):
    """Tensor, expert and data parallelism over gloo ranks that share the
    card; the ranks hold what they can alone (launches, the per-rank
    kernel, ids on the same x) and this process holds the ranks against
    each other and against tp=1. A failing rank fails the phase."""
    from repro_torch.parallel import spawn
    print(f"== phase tp: {TP_WORLD} gloo ranks sharing the card (the "
          f"collectives pass through the host: no multi-GPU speed)")
    free_cuda()
    t0 = time.perf_counter()
    ranks = spawn(tp_rank, TP_WORLD, device="cuda", threads=2, timeout=600)
    print(f"  {card}")
    out = {}
    for key, *_ in TP_DENSE:
        name, L, D, H, KV = ranks[0][key]["cfg"]
        print(f"  {key}: {name} (D {D}, {L} layers, {H} heads / {KV} kv), "
              f"plan groups=4, phase 4's stream, pallas, eager")
        out[key] = tp_hold_dense(key, [r[key]["runs"] for r in ranks])
    name, L, D, E = ranks[0]["moe"]["cfg"]
    one, two = ranks[0]["moe"]["runs"][1], \
        [r["moe"]["runs"][2] for r in ranks[:2]]
    want = [dataclasses.asdict(s) for s in one["repriced"]]
    for r in two:
        if r["toks"] != one["toks"] or len(r["traces"]) != len(
                one["traces"]) or any(not np.array_equal(a, b) for a, b in
                                      zip(r["traces"], one["traces"])) \
                or [dataclasses.asdict(s) for s in r["stats"]] != want:
            raise AssertionError(f"{name} ep=2: tokens, traces or "
                                 f"TokenStats differ from ep=1's")
        if r["launches"] or r["experts"] != E // 2:
            raise AssertionError(f"{name} ep=2: {r['launches']} kernel "
                                 f"launches, {r['experts']} experts held")
    print(f"  moe: {name} (D {D}, {E} experts, {L} layers, fp32), ep=2: "
          f"tokens, traces and TokenStats identical to ep=1's (repriced at "
          f"2 shards); {E // 2} experts per rank; no fused_cold_ffn launch")
    for i, r in enumerate([one] + two):
        print(f"    {'ep=1' if i == 0 else f'ep=2 rank {i - 1}'}: wall "
              f"{r['wall_ms']:.2f} ms/step, collectives "
              f"{r['coll_ms_per_step']:.2f} ms/step, weights "
              f"{r['weight_bytes'] / 2**30:.2f} GiB + serve peak "
              f"{r['peak_bytes'] / 2**20:.1f} MiB")
    out["moe"] = dict(wall_ms=[r["wall_ms"] for r in [one] + two],
                      coll_ms_per_step=[r["coll_ms_per_step"]
                                        for r in [one] + two])
    dp = [r["dp"] for r in ranks]
    ref = dp[0]["dp2"]
    for i, d in enumerate(dp):
        if d["dp2tp2"]["toks"] != ref["toks"] \
                or d["dp2tp2"]["replicas"] != [0, 1]:
            raise AssertionError(f"dp=2 x tp=2 rank {i}: tokens differ from "
                                 f"dp=2's or a replica stood idle")
    print(f"  dp=2 x tp=2 (smollm-135m fp32, 4 layers): tokens of "
          f"{len(ref['toks'])} requests identical to dp=2 on one rank; wall "
          f"{ref['wall_ms']:.2f} ms per replica step (dp=2) against "
          + ", ".join(f"{d['dp2tp2']['wall_ms']:.2f}" for d in dp)
          + " ms (dp=2 x tp=2, ranks 0-3; collectives "
          + ", ".join(f"{d['dp2tp2']['coll_ms_per_step']:.2f}" for d in dp)
          + " ms per step)")
    out["dp"] = dict(dp2_wall_ms=ref["wall_ms"],
                     grid_wall_ms=[d["dp2tp2"]["wall_ms"] for d in dp])
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase tp {out['seconds']:.1f} s; rank 0's seconds by case: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items())
          + "; of them the same-x holds "
          + ", ".join(f"{k} tp={n} {r['same_x_s']:.1f}"
                      for k, *_ in TP_DENSE
                      for n, r in ranks[0][k]["runs"].items()
                      if "same_x_s" in r))
    return out


# ------------------------------------------------------- phase tptrain ----

# training over a dp x tp grid and grok-1-314b's experts split by neurons,
# on gloo ranks sharing the card (as phase tp)
TPT_WORLD, TPT_DP, TPT_TP = 4, 2, 2
# depths cut (never widths) to keep the phase within 150 s on a slow host
TPT_PARITY_LAYERS = 2           # the fp32 step, the grid against one rank
TPT_TRAIN_LAYERS = 16           # launch.train's recipe at full width
TPT_STEPS = 10
TPT_LOSS_REL = 2e-2             # each bf16 step's loss against one rank's
# grok-1-314b at full width, depth cut to what four ranks sharing the card
# hold: (key, layers, dtype)
GROK = (("fp32", 1, "float32"), ("bf16", 2, "bfloat16"))
GROK_SAME_X_STEPS = 3           # steps whose every layer's x is held


def rss_bytes() -> int:
    """This process's resident host memory now (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostPeak:
    """The peak of this process's resident host memory while the `with`
    runs, sampled every 10 ms on a thread: the kernel under the card's
    sandbox keeps no VmHWM, and ru_maxrss would carry the parent's
    resident set from before the spawn's exec."""

    def __enter__(self):
        self.peak, self._stop = rss_bytes(), threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def on_card(module):
    """Raise unless every parameter of `module` lives on the card."""
    off = {p.device.type for p in module.parameters()} - {"cuda"}
    if off:
        raise AssertionError(f"a rank holds parameters on {off}, not the "
                             f"card")


def worst_leaf(want: dict, got: dict, path: str = "") -> tuple:
    """(max |got - want| over max |want| of the worst leaf, its path) of
    two gradient trees of one layout."""
    worst = (0.0, "")
    for k, w in want.items():
        if isinstance(w, dict):
            worst = max(worst, worst_leaf(w, got[k], f"{path}{k}."))
            continue
        if w.shape != got[k].shape:
            raise AssertionError(f"gradient {path}{k}: shape "
                                 f"{got[k].shape}, one rank's {w.shape}")
        worst = max(worst, (float(np.abs(got[k] - w).max())
                            / max(float(np.abs(w).max()), 1e-30),
                            path + k))
    return worst


def same_tree(a, b) -> bool:
    """Two numpy parameter trees (`params_to_numpy`'s) equal bit for
    bit, dtypes included."""
    if a.dtypes != b.dtypes:
        return False

    def walk(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(walk(x[k], y[k]) for k in x)
        return x.dtype == y.dtype and np.array_equal(x, y)
    return walk(a.tree, b.tree)


def tpt_parity(world, rows, cols):
    """One fp32 train step's loss and gradients of smollm-135m at full
    width cut to TPT_PARITY_LAYERS layers: the dp x tp grid against one
    rank (world rank 0, the others waiting), the same seeded weights and
    batch. Holds on rank 0; returns the loss, the errors, the seconds."""
    cfg = tp_cfg(TRAIN_ARCH, TPT_PARITY_LAYERS, "float32")
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                       TRAIN_BATCH, seed=0)).batch()
    out, t0 = {}, time.perf_counter()
    if world.rank == 0:
        one = build_model(cfg, "cuda", seed=0)
        loss, grads = loss_and_grads(one, one.params(),
                                     shard_batch(batch, "cuda"))
        want = (float(loss), params_to_numpy(one.module, grads).tree)
        del one, grads
    out["one_s"] = time.perf_counter() - t0
    torch.distributed.barrier(group=world.group)
    t1 = time.perf_counter()
    model = build_model(cfg, "cuda", seed=0, shard=rows)
    on_card(model.module)
    loss, grads = loss_and_grads(model, model.params(), shard_batch(
        batch, "cuda", cols.rank, TPT_DP), cols)
    out["step_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tree = gather_params(model.module, rows, values=grads) \
        if cols.rank == 0 else None
    out["gather_s"] = time.perf_counter() - t1
    out["loss"] = float(loss)
    if world.rank == 0:
        rel = abs(out["loss"] - want[0]) / abs(want[0])
        worst = worst_leaf(want[1], tree.tree)[0]
        if rel > TRAIN_LOSS_REL or worst > TRAIN_GRAD_REL:
            raise AssertionError(f"dp x tp train step: loss {out['loss']} "
                                 f"against {want[0]} ({rel:.3e}), worst "
                                 f"gradient {worst:.3e} of its max")
        out.update(loss_one=want[0], loss_rel=rel, grad_worst_rel=worst)
    out["seconds"] = time.perf_counter() - t0
    return out


def tpt_run(cfg, shard=None, data=None, lr=None, batch=None, seq=None):
    """launch.train's loop (`run`) at batch x seq (default TRAIN_BATCH x
    TRAIN_SEQ), lr (default TRAIN_LR), TPT_STEPS steps on the card, each
    step's synchronized wall
    and collectives recorded by a spy on make_train_step; the kernel
    launches of the steps and the peak device memory."""
    import repro_torch.launch.train as ltrain
    inner, walls, colls = ltrain.make_train_step, [], []
    lr, batch, seq = (TRAIN_LR if lr is None else lr,
                      TRAIN_BATCH if batch is None else batch,
                      TRAIN_SEQ if seq is None else seq)

    def timed_step(model, opt, **kw):
        step = inner(model, opt, **kw)

        def go(*a):
            c0, s0 = TP_COLL["calls"], TP_COLL["seconds"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(*a)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            colls.append((TP_COLL["calls"] - c0, TP_COLL["seconds"] - s0))
            return res
        return go
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    ltrain.make_train_step = timed_step
    try:
        model, losses = ltrain.run(cfg, torch.device("cuda"),
                                   steps=TPT_STEPS, batch_size=batch,
                                   seq_len=seq, lr=lr,
                                   log_every=0, seed=0, shard=shard,
                                   data=data)
    finally:
        ltrain.make_train_step = inner
    on_card(model.module)
    c, secs = np.array(colls, dtype=float).T
    return model, dict(
        losses=losses, wall_ms=float(np.median(walls[1:]) * 1e3),
        first_ms=walls[0] * 1e3, coll_per_step=float(np.median(c[1:])),
        coll_ms_per_step=float(np.median(secs[1:]) * 1e3),
        launches=sum(ops.launch_counts().values()),
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.module.parameters()),
        vocab_bytes=vocab_bytes(model.module),
        peak_bytes=torch.cuda.max_memory_allocated())


def tpt_train(world, rows, cols):
    """smollm-135m at full width (TPT_TRAIN_LAYERS layers, bf16, remat):
    TPT_STEPS steps on one rank (world rank 0, the others waiting), then
    on the dp x tp grid from the same seeded weights and batches; the
    trained slices gathered, saved and loaded back on rank 0 bit for
    bit."""
    cfg = get_config(TRAIN_ARCH).replace(num_layers=TPT_TRAIN_LAYERS)
    t0 = time.perf_counter()
    one = None
    if world.rank == 0:
        model, one = tpt_run(cfg)
        del model
    torch.distributed.barrier(group=world.group)
    model, out = tpt_run(cfg, rows, cols)
    out["seconds_steps"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    tree = gather_params(model.module, rows) if cols.rank == 0 else None
    out["gather_s"] = time.perf_counter() - t1
    if out["launches"]:
        raise AssertionError(f"rank {world.rank}: the train steps launched "
                             f"{out['launches']} kernels")
    if world.rank == 0:
        import tempfile
        losses, base = np.array(out["losses"]), np.array(one["losses"])
        rel = np.abs(losses - base) / np.abs(base)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and (rel <= TPT_LOSS_REL).all()):
            raise AssertionError(f"dp x tp losses {losses} against one "
                                 f"rank's {base}")
        with tempfile.TemporaryDirectory() as d:
            t1 = time.perf_counter()
            save_checkpoint(d, tree, step=TPT_STEPS)
            back = params_to_numpy(load_checkpoint(d, cfg, "cuda"))
            out["checkpoint_s"] = time.perf_counter() - t1
        if not same_tree(tree, back):
            raise AssertionError("the gathered checkpoint did not load back "
                                 "bit for bit")
        out.update(one=one, loss_rel=rel.tolist())
    del model, tree
    free_cuda()
    return out


def tpt_grok_engine(cfg, model, plan, shard):
    """An eager engine for phase 4's stream over `shard` (None: one
    rank)."""
    return ServeEngine(cfg, model, plan, temperature=0.0, seed=0,
                       ctx_budget=CTX, cuda_graphs=False, shard=shard)


def tpt_grok_serve(cfg, engine, record):
    """Phase 4's stream through `engine` (tp_serve), with every layer's
    apply_moe_ffn input of the first GROK_SAME_X_STEPS steps recorded
    when `record`; the engine is closed after."""
    from repro_torch.models import moe as tmoe
    xs, inner, steps = [], tmoe.apply_moe_ffn, [0]
    step = engine.step

    def counted():
        out = step()
        steps[0] += 1
        return out

    def spy(moe, x, cfg_, plan=None, active_mask=None, **k):
        if record and steps[0] < GROK_SAME_X_STEPS:
            xs.append((len(xs) % cfg.num_layers, x.detach().clone(),
                       None if active_mask is None else active_mask.clone()))
        return inner(moe, x, cfg_, plan=plan, active_mask=active_mask, **k)
    tmoe.apply_moe_ffn, engine.step = spy, counted
    try:
        run = tp_serve(engine)
    finally:
        tmoe.apply_moe_ffn = inner
    engine.close()
    run.update(xs=xs, card_peak=torch.cuda.max_memory_allocated())
    run["traces"] = [c[0] for c in run["calls"]]
    run["stats"] = [dataclasses.asdict(x) for x in run["stats"]]
    return run


def tpt_grok(world, four, layers, dtype):
    """grok-1-314b at full width cut to `layers`: every rank builds its
    tp=4 slice, rank 0 serves tp=1 (the others waiting), then tp=4
    serves (each engine's storage plane holds a host fp32 copy of the
    experts it is given, so rank 0 frees its tp=1 plane first); every
    recorded (step, layer)'s
    apply_moe_ffn on the same x held against tp=1 (max |dy| within the
    dtype's tolerance of max |y|, counts identical); tokens, traces and
    stats returned for the parent to hold."""
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import shard_layout
    cfg = tp_cfg("grok-1-314b", layers, dtype)
    plan = serving_family(cfg).build_plan(cfg, hw=PHONE)
    t0 = time.perf_counter()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    local = tmoe.make_model(cfg, "cuda", seed=0, layout=shard_layout(
        cfg, plan, four.rank, TPT_WORLD))
    on_card(local)
    whole, one = None, None
    if world.rank == 0:
        with HostPeak() as peak:
            whole = tmoe.make_model(cfg, "cuda", seed=0)
            one = tpt_grok_serve(cfg, tpt_grok_engine(cfg, whole, plan,
                                                      None), False)
        one["host_peak"] = peak.peak
        if dtype == "float32":
            # the tp=1 trace repriced at 4 shards (the plane prices from
            # the config, the plan and the trace; its bundles come from
            # this rank's slice, which the pricing never reads)
            plane = StoragePlane(cfg, local, plan, spec=POWERINFER2,
                                 n_shards=TPT_WORLD)
            one["repriced"] = [dataclasses.asdict(plane.step(tr, p, b, c))
                               for tr, p, b, c in one["calls"]]
            plane.close()
        for k in ("calls", "xs"):
            one.pop(k)
        gc.collect()             # the tp=1 plane's host copy goes first
    torch.distributed.barrier(group=world.group)
    t1 = time.perf_counter()
    with HostPeak() as peak:
        run = tpt_grok_serve(cfg, tpt_grok_engine(cfg, local, plan, four),
                             True)
    run.pop("calls")
    run["host_peak"] = peak.peak
    run["serve_s"] = time.perf_counter() - t1
    # the same x through apply_moe_ffn over the ranks and on rank 0 whole
    worst, held = 0.0, 0
    for l, x, mask in run.pop("xs"):
        y, _, tr = tmoe.apply_moe_ffn(local.layers[l].moe, x, cfg,
                                      active_mask=mask, collect_trace=True,
                                      shard=four)
        if whole is not None:
            y1, _, tr1 = tmoe.apply_moe_ffn(whole.layers[l].moe, x, cfg,
                                            active_mask=mask,
                                            collect_trace=True)
            # the ranks' partial outputs are each rounded to the dtype
            # before their fp32 sum: held at the tolerance of max |y|
            d = float((y.float() - y1.float()).abs().max())
            scale = float(y1.float().abs().max())
            if not torch.equal(tr, tr1) or d > TOL[y.dtype] * scale:
                raise AssertionError(f"grok {dtype} layer {l}: tp=4 "
                                     f"apply_moe_ffn differs from tp=1 on the "
                                     f"same x (max |dy| {d} of max |y| "
                                     f"{scale})")
            worst = max(worst, d / max(scale, 1e-30))
            held += 1
    run.update(one=one, same_x=held, same_x_err=worst,
               experts=tuple(local.layers[0].moe.experts.shape),
               vocab_bytes=vocab_bytes(local),
               seconds=time.perf_counter() - t0)
    del whole, local
    free_cuda()
    return run


def tpt_rank(world):
    """Every case of phase tptrain on this rank of the gloo world (all
    ranks on cuda:0); its results for the parent to hold and print."""
    from repro_torch.parallel import grid, replica_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    spy_collectives()
    t0 = time.perf_counter()
    # every rank opens its CUDA context and cuBLAS handle now, while rank
    # 0 runs the one-rank cases alone
    a = torch.ones((8, 8), device=world.device)
    float((a @ a).sum())
    rows, cols = grid(world, TPT_DP, TPT_TP)
    four = replica_groups(world, 1, TPT_WORLD)[0]
    out = {"parity": tpt_parity(world, rows, cols),
           "train": tpt_train(world, rows, cols)}
    for key, layers, dtype in GROK:
        torch.distributed.barrier(group=world.group)
        out[key] = tpt_grok(world, four, layers, dtype)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_tptrain(card):
    """Training over a dp x tp grid and grok-1-314b at tp=4 on gloo ranks
    sharing the card; the ranks hold what they can alone (the step and
    the same-x holds on rank 0) and this process holds the grok streams
    against tp=1. A failing rank fails the phase."""
    from repro_torch.parallel import spawn
    print(f"== phase tptrain: {TPT_WORLD} gloo ranks sharing the card "
          f"(dp={TPT_DP} x tp={TPT_TP} training; grok-1-314b at "
          f"tp={TPT_WORLD}; {card})")
    free_cuda()
    free, total = torch.cuda.mem_get_info()
    print(f"  the card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"free; this process keeps {torch.cuda.memory_reserved() / 2**30:.2f}"
          f" GiB reserved")
    t0 = time.perf_counter()
    ranks = spawn(tpt_rank, TPT_WORLD, device="cuda", threads=2,
                  timeout=900)
    print(f"  ranks ran {time.perf_counter() - t0:.1f} s (rank 0 from its "
          f"start: {ranks[0]['seconds']:.1f} s)")
    p = ranks[0]["parity"]
    print(f"  {TRAIN_ARCH} fp32 ({TPT_PARITY_LAYERS} layers, full width) "
          f"one step at dp={TPT_DP} x tp={TPT_TP} against one rank: loss "
          f"{p['loss']:.7f} / {p['loss_one']:.7f} ({p['loss_rel']:.2e} "
          f"relative), worst gathered gradient {p['grad_worst_rel']:.2e} of "
          f"its max |g| ({p['seconds']:.1f} s: one rank "
          f"{p['one_s']:.1f}, the grid's build and step {p['step_s']:.1f}, "
          f"the gather {p['gather_s']:.1f})")
    tr = [r["train"] for r in ranks]
    one = tr[0]["one"]
    print(f"  {TRAIN_ARCH} bf16 ({TPT_TRAIN_LAYERS} layers, remat) {TPT_STEPS} steps of "
          f"({TRAIN_BATCH}, {TRAIN_SEQ}), lr {TRAIN_LR}: losses "
          + ", ".join(f"{v:.4f}" for v in tr[0]["losses"])
          + f"; one rank " + ", ".join(f"{v:.4f}" for v in one["losses"])
          + f" (worst {max(tr[0]['loss_rel']):.2e} relative); "
          f"checkpoint of the gathered model {tr[0]['checkpoint_s']:.2f} s, "
          f"bit for bit; 0 kernel launches")
    print(f"    one rank: wall {one['wall_ms']:.2f} ms/step (first "
          f"{one['first_ms']:.2f}), weights {one['weight_bytes'] / 2**20:.1f} "
          f"MiB (embedding {one['vocab_bytes'] / 2**20:.1f}), peak "
          f"{one['peak_bytes'] / 2**20:.1f} MiB")
    for i, r in enumerate(tr):
        print(f"    rank {i}: wall {r['wall_ms']:.2f} ms/step (first "
              f"{r['first_ms']:.2f}), collectives {r['coll_per_step']:.0f} "
              f"per step taking {r['coll_ms_per_step']:.2f} ms, weights "
              f"{r['weight_bytes'] / 2**20:.1f} MiB (embedding "
              f"{r['vocab_bytes'] / 2**20:.1f}), peak "
              f"{r['peak_bytes'] / 2**20:.1f} MiB"
              + (f", gather {r['gather_s']:.2f} s" if i < TPT_TP else ""))
    out = {"parity": p, "train": dict(
        losses=tr[0]["losses"], one_losses=one["losses"],
        loss_rel=tr[0]["loss_rel"], one_wall_ms=one["wall_ms"],
        wall_ms=[r["wall_ms"] for r in tr],
        coll_per_step=[r["coll_per_step"] for r in tr],
        coll_ms_per_step=[r["coll_ms_per_step"] for r in tr],
        weight_mib=[r["weight_bytes"] / 2**20 for r in tr],
        vocab_mib=[r["vocab_bytes"] / 2**20 for r in tr],
        peak_mib=[r["peak_bytes"] / 2**20 for r in tr],
        one_weight_mib=one["weight_bytes"] / 2**20,
        one_vocab_mib=one["vocab_bytes"] / 2**20,
        launches=sum(r["launches"] for r in tr))}
    for key, layers, dtype in GROK:
        runs = [r[key] for r in ranks]
        base = runs[0]["one"]
        for i, r in enumerate(runs):
            if r["launches"] or base["launches"]:
                raise AssertionError(f"grok {key}: fused_cold_ffn launched "
                                     f"on the moe path")
            if r["toks"] != runs[0]["toks"] or any(
                    not np.array_equal(a, b)
                    for a, b in zip(r["traces"], runs[0]["traces"])):
                raise AssertionError(f"grok {key} rank {i}: other tokens or "
                                     f"traces than rank 0")
        r0 = runs[0]
        same_toks = r0["toks"] == base["toks"]
        same_tr = sum(np.array_equal(a, b)
                      for a, b in zip(r0["traces"], base["traces"]))
        if dtype == "float32":
            if not same_toks or same_tr != len(base["traces"]) \
                    or len(r0["traces"]) != len(base["traces"]) \
                    or r0["stats"] != base["repriced"]:
                raise AssertionError(f"grok {key}: tokens, traces or "
                                     f"TokenStats differ from tp=1's")
            verdict = ("tokens, traces and TokenStats identical to tp=1 "
                       "(its trace repriced at 4 shards)")
        else:
            verdict = (f"tokens {'identical to' if same_toks else 'differ from'}"
                       f" tp=1's, traces identical at {same_tr} of "
                       f"{len(base['traces'])} steps (x drifts in bf16)")
        E, f_loc, R, D = r0["experts"]
        print(f"  grok-1-314b {key} ({layers} layer(s), D {D}, {E} experts "
              f"of {f_loc} of {f_loc * TPT_WORLD} rows per rank), phase 4's "
              f"stream, eager, tp={TPT_WORLD}: {verdict}; apply_moe_ffn on "
              f"the same x at {r0['same_x']} (step, layer): counts "
              f"identical, max |dy| {r0['same_x_err']:.3e} of max |y|; no "
              f"fused_cold_ffn launch ({r0['seconds']:.1f} s)")
        for name, r in [("tp=1", base)] + [(f"rank {i}", r)
                                           for i, r in enumerate(runs)]:
            print(f"    {name}: wall {r['wall_ms']:.2f} ms/step (median of "
                  f"{r['steps']}), collectives {r['coll_per_step']:.0f} per "
                  f"step taking {r['coll_ms_per_step']:.2f} ms, weights "
                  f"{r['weight_bytes'] / 2**30:.3f} GiB, card peak "
                  f"{r['card_peak'] / 2**30:.2f} GiB, host RSS peak of "
                  f"the serve {r['host_peak'] / 2**30:.2f} GiB")
        out[key] = dict(
            layers=layers, tokens_identical=same_toks,
            traces_identical=[same_tr, len(base["traces"])],
            same_x=r0["same_x"], same_x_err=r0["same_x_err"],
            launches=r0["launches"], one_wall_ms=base["wall_ms"],
            wall_ms=[r["wall_ms"] for r in runs],
            coll_per_step=[r["coll_per_step"] for r in runs],
            coll_ms_per_step=[r["coll_ms_per_step"] for r in runs],
            weight_gib=[r["weight_bytes"] / 2**30 for r in runs],
            one_weight_gib=base["weight_bytes"] / 2**30,
            card_peak_gib=[r["card_peak"] / 2**30 for r in runs],
            host_peak_gib=[r["host_peak"] / 2**30 for r in runs],
            seconds=r0["seconds"])
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase tptrain {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------- phase train ----

# card against CPU: reduced configs in fp32, one train step from the same
# seeded weights and batch
TRAIN_PARITY = ("smollm-135m", "deepseek-moe-16b", "qwen2-vl-2b")
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
# full width: benchmarks/common.py::_train_with_cfg's recipe
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = (
    "smollm-135m", 40, 4, 64, 2e-3)
TRAIN_BAR = 0.8              # last loss below this share of the first
TRAIN_BUCKETS = (1, 2, 4, 8, 16, 32)   # engine_setup's pinned plans


def train_parity(cfg):
    """One train step of `cfg` (reduced, fp32) on the card against the
    same step on the CPU, from the same weights (seed 0, drawn on the CPU)
    and batch: loss within TRAIN_LOSS_REL relative, every gradient leaf
    within TRAIN_GRAD_REL of its max |g|; then the step itself (AdamW on
    each device) gives the same loss and finite parameters."""
    cpu = build_model(cfg, device="cpu", seed=0)
    host = params_to_numpy(cpu.module)
    card = wrap(params_from_numpy(host.tree, cfg, "cuda", dtypes=host.dtypes))
    rng = np.random.default_rng(0)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 32, 2, seed=0))
    batch = add_modal_inputs(data.batch(), cfg, rng)
    out = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        b = shard_batch(batch, name)
        loss, grads = loss_and_grads(m, m.params(), b)
        opt = AdamW(lr=TRAIN_LR)
        w = m.params()
        _, _, met = make_train_step(m, opt)(w, opt.init(w), b)
        if not (float(met["loss"]) == float(loss) and all(
                bool(torch.isfinite(p).all()) for p in w.values())):
            raise AssertionError(f"{cfg.name} on {name}: the step's loss "
                                 f"moved or a parameter is not finite")
        out[name] = float(loss), {k: None if g is None else g.cpu()
                                  for k, g in grads.items()}
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"{cfg.name}: card loss {l_card} vs CPU "
                             f"{l_cpu}, {rel:.3e} relative")
    worst = 0.0
    for k, g in g_cpu.items():
        if g is None or g_card[k] is None:
            if (g is None) != (g_card[k] is None):
                raise AssertionError(f"{cfg.name}: {k} has a gradient on "
                                     f"one device only")
            continue
        e = float((g_card[k] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        worst = max(worst, e)
        if e > TRAIN_GRAD_REL:
            raise AssertionError(f"{cfg.name}: gradient of {k} off by "
                                 f"{e:.3e} of its max")
    print(f"  {cfg.name} (reduced, fp32): loss card {l_card:.7f}, CPU "
          f"{l_cpu:.7f} ({rel:.2e} relative); {len(g_cpu)} gradient leaves, "
          f"worst {worst:.2e} of its max |g|")
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=rel,
                grad_worst_rel=worst)


def train_full(cfg):
    """repro_torch.launch.train.train() at full width on the card, each
    step's synchronized wall recorded by a spy on make_train_step (the
    batch's host preparation left out); the peak device memory above what
    was allocated when it started; the kernel launches of the steps."""
    import repro_torch.launch.train as ltrain
    inner, walls = ltrain.make_train_step, []

    def timed_step(model, opt, **kw):
        step = inner(model, opt, **kw)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return run
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    ltrain.make_train_step = timed_step
    try:
        model, losses = ltrain.train(
            TRAIN_ARCH, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, reduced=False, lr=TRAIN_LR, log_every=10,
            seed=0, device="cuda")
    finally:
        ltrain.make_train_step = inner
    launched = ops.launch_counts()
    if any(launched.values()):
        raise AssertionError(f"the train steps launched {launched}: the "
                             f"reference trains through no Pallas kernel")
    return (model, losses, walls, torch.cuda.max_memory_allocated() - base,
            launched)


def step_split(model, batch, n=3):
    """The train step's device time split into forward (the loss),
    backward (autograd) and optimizer (AdamW's update and the write into
    the parameters), CUDA events around each, medians of n steps from a
    fresh AdamW state."""
    opt = AdamW(lr=TRAIN_LR)
    params = model.params()
    state = opt.init(params)
    loss_fn = make_loss_fn(model)
    rows = []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params.values():
            p.requires_grad_(True)
        ev[0].record()
        loss = loss_fn(batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        ev[2].record()
        for p in params.values():
            p.requires_grad_(False)
        new, state = opt.update(dict(zip(params, grads)), state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del loss, grads, new
    med = np.median(np.array(rows), axis=0)
    return dict(forward_ms=float(med[0]), backward_ms=float(med[1]),
                optimizer_ms=float(med[2]))


def same_params(a, b) -> bool:
    """Every parameter of two models bit-identical."""
    pb = dict(b.named_parameters())
    for name, p in a.named_parameters():
        q = pb[name]
        if p.dtype != q.dtype or not torch.equal(
                p.view(torch.int16) if p.dtype == torch.bfloat16 else p,
                q.view(torch.int16) if q.dtype == torch.bfloat16 else q):
            return False
    return True


def trained_plan(cfg, model):
    """benchmarks/common.py::engine_setup on the trained model:
    calibrate_predictor and profile_activations on four (4, 64) batches,
    build_plan on PHONE (printed: the trained model's own budgets), then
    the budgets pinned to make_plan(d_ff, 0.125, 0.10, cs) scaled per
    bucket, and the hot-first permutation."""
    batches = profile_batches(cfg, "cuda", 0)
    calibrate_predictor(model, cfg, batches)
    q = predictor_quality(model, cfg, batches)
    counts, n_tok = profile_activations(model, cfg, batches)
    freqs = (counts / n_tok).astype(np.float32)
    plan = build_plan(cfg, freqs, hw=PHONE, backend="pallas")
    unpinned = {b: dict(n_hot=p.n_hot, kc=p.clusters_per_group,
                        k_cold=p.k_cold) for b, p in sorted(plan.plans.items())}
    cs = cfg.sparse_ffn.cluster_size
    print(f"  trained plan on PHONE ({n_tok} profiled tokens, mean "
          f"activation frequency {freqs.mean():.4f}, predictor recall "
          f"{q:.4f}), n_hot / kc of {cfg.d_ff // cs} clusters of {cs} per "
          f"bucket: " + ", ".join(f"B={b} {v['n_hot']}/{v['kc']}"
                                  for b, v in unpinned.items()))
    base = make_plan(cfg.d_ff, 0.125, 0.10, cs, backend="pallas")
    plan.plans = {b: scale_plan_for_batch(base, cfg.d_ff, b, cs)
                  for b in TRAIN_BUCKETS}
    print("  pinned (engine_setup): " + ", ".join(
        f"B={b} {p.n_hot}/{p.clusters_per_group}"
        for b, p in sorted(plan.plans.items())))
    model = serving_family(cfg).prepare_params(model, plan)
    return model, plan, dict(unpinned=unpinned, mean_frequency=float(
        freqs.mean()), recall=q, n_tokens=n_tok)


def phase_train(card):
    """The training path on the card: (1) one fp32 train step of reduced
    smollm-135m, deepseek-moe-16b and qwen2-vl-2b against the CPU; (2)
    smollm-135m at full width (30 layers, bf16, remat) trains 40 steps
    through launch.train.train() on the synthetic corpus with the
    reference bench's recipe: finite losses, the last below 0.8x the
    first; (3) save_checkpoint then load_checkpoint gives every parameter
    back bit for bit; the step's forward / backward / optimizer split;
    (4) the loaded model is calibrated, profiled, planned (the unpinned
    budgets printed, then engine_setup's pinned ones), permuted and
    served graphed and eagerly through fused_cold_ffn (tokens, ids and
    TokenStats identical, 30 launches per cold step), and the kernel on
    layer 0 and x from the serve is held against its plain version and
    timed at every bucket."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: fp32 products would not be fp32")
    out = {"parity": {}}
    print("== phase train: one fp32 step, card against CPU")
    for arch in TRAIN_PARITY:
        out["parity"][arch] = train_parity(get_config(arch).reduced())
    cfg = get_config(TRAIN_ARCH)
    print(f"== phase train: {TRAIN_ARCH} at full width (D {cfg.d_model}, "
          f"{cfg.num_layers} layers, {cfg.param_dtype}, remat "
          f"{cfg.remat}), {TRAIN_STEPS} steps of ({TRAIN_BATCH}, "
          f"{TRAIN_SEQ}) tokens, lr {TRAIN_LR} ({card})")
    model, losses, walls, peak, launched = train_full(cfg)
    if not (np.isfinite(losses).all()
            and losses[-1] < TRAIN_BAR * losses[0]):
        raise AssertionError(f"{TRAIN_ARCH}: losses {losses[0]} -> "
                             f"{losses[-1]}, not below {TRAIN_BAR}x")
    if any(p.requires_grad for p in model.module.parameters()):
        raise AssertionError("the trained model's parameters require grad")
    n_params = sum(p.numel() for p in model.module.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = float(np.median(walls[5:]))
    flops = 6.0 * n_params * tokens
    mfu = flops / wall / PEAK_OPS_PER_S[torch.bfloat16]
    curve = {i: losses[i] for i in (0, 10, 20, TRAIN_STEPS - 1)}
    print(f"  loss " + ", ".join(f"step {i} {v:.4f}" for i, v in
                                 curve.items())
          + f"; wall per step median of steps 5-{TRAIN_STEPS} "
          f"{wall * 1e3:.2f} ms (first {walls[0] * 1e3:.2f}), "
          f"{tokens / wall:.1f} tokens/s; {n_params} parameters, model "
          f"FLOPs 6*N*tokens {flops / 1e12:.3f} TFLOP per step = "
          f"{mfu * 100:.3f}% of the dense bf16 peak; peak device memory "
          f"{peak / 2**20:.1f} MiB above the start's; kernel launches in the "
          f"steps {launched}")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(d, params_to_numpy(model.module), step=TRAIN_STEPS)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_checkpoint(d, cfg, "cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if not same_params(model.module, served):
        raise AssertionError("the checkpoint did not round-trip bit for bit")
    print(f"  checkpoint: save {t_save:.2f} s, load {t_load:.2f} s, every "
          f"parameter bit-identical")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                      seed=1))
    split = step_split(model, shard_batch(data.batch(), "cuda"))
    print(f"  one step's device time: forward {split['forward_ms']:.2f} ms, "
          f"backward {split['backward_ms']:.2f} ms, optimizer "
          f"{split['optimizer_ms']:.2f} ms (CUDA events, median of 3)")
    del model
    free_cuda()
    served, plan, planned = trained_plan(cfg, served)
    spy, xs = x_spy(served)
    runs = {"graph": arch_serve(cfg, served, plan, True),
            "eager": arch_serve(cfg, served, plan, False, spy)}
    g, e = runs["graph"], runs["eager"]
    for name, a, b in zip(("tokens", "traces", "TokenStats"), g["outputs"],
                          e["outputs"]):
        if a != b:
            raise AssertionError(f"trained {TRAIN_ARCH}: graphed and eager "
                                 f"{name} differ")
    for name, r in runs.items():
        dev = r["profile"].get("device_ms_per_step")
        print(f"  served {name}: wall per step median "
              f"{r['wall_ms_median']:.2f} ms (first {r['wall_ms_first']:.2f}"
              f"); device busy per step "
              + ("not measured" if dev is None else f"{dev:.3f} ms")
              + f"; storage plane {r['plane_ms']:.2f} ms per step (host); "
              f"launches {r['launches']} = {cfg.num_layers} x "
              f"{r['cold_steps']} of {r['steps']} steps")
    rows = torch.cat(xs)
    if rows.shape[0] < max(TRAIN_BUCKETS):
        raise AssertionError(f"{rows.shape[0]} rows of x from the serve")
    print(f"  fused_cold_ffn on layer 0 of the trained, pinned plan, x from "
          f"the serve:")
    kt = arch_kernel(cfg, served.layers[0].ffn, plan.plan_for_batch, rows,
                     TRAIN_BUCKETS)
    out.update(
        arch=TRAIN_ARCH, layers=cfg.num_layers, steps=TRAIN_STEPS,
        losses=losses, loss_curve=curve, wall_ms_median=wall * 1e3,
        wall_ms=[w * 1e3 for w in walls], tokens_per_s=tokens / wall,
        n_params=n_params, model_flops_share=mfu, peak_bytes=peak,
        split_ms=split, checkpoint_s=dict(save=t_save, load=t_load),
        plan=planned, launches=g["launches"], kernels=kt,
        launches_train_step=launched,
        serve={m: dict(wall_ms_median=r["wall_ms_median"],
                       plane_ms=r["plane_ms"], steps=r["steps"],
                       launches=r["launches"], cold_steps=r["cold_steps"],
                       device_ms_per_step=r["profile"].get(
                           "device_ms_per_step"))
               for m, r in runs.items()})
    del served, rows, xs, spy
    free_cuda()
    return out


# ------------------------------------------------------ phase families ----

# (arch, prompt length): the ssm, hybrid and encdec families whole, at
# full width in bf16; recurrentgemma-9b's prompt fills its 2,048-slot
# local ring, so that the decode wraps it
FAMILIES = (("mamba2-130m", 2048), ("recurrentgemma-9b", 2048),
            ("seamless-m4t-large-v2", 256))
FAMILY_BATCHES = (1, 4)
FAMILY_STEPS = 16
# decode against forward in fp32 at full width, cut in depth: (arch,
# layers kept, prompt, batch); recurrentgemma-9b keeps one group and the
# two remainder layers, and its 2,048-token prompt makes the decode wrap
# the local ring
FAMILY_CONSISTENCY = (("mamba2-130m", 4, 64, 2),
                      ("recurrentgemma-9b", 5, 2048, 1),
                      ("seamless-m4t-large-v2", 2, 32, 2))
CONSISTENCY_TOL = dict(atol=5e-3, rtol=1e-3)   # test_decode_consistency's


def family_cfg(arch, layers=None):
    """The config, cut to `layers` decoder (and encoder) layers."""
    cfg = get_config(arch)
    if layers is None:
        return cfg
    kw = {"num_layers": layers}
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = layers
    return cfg.replace(**kw)


def family_plan(cfg):
    """make_plan of the config's sparse FFN under backend "pallas" (hot
    0.4, cold-active 0.2, clusters of 128 at recurrentgemma-9b's and
    seamless's widths), or None where there is no FFN (mamba2)."""
    s = cfg.sparse_ffn
    if not (s.enabled and cfg.d_ff):
        return None
    return make_plan(cfg.d_ff, s.hot_ratio, s.cold_active_ratio,
                     s.cluster_size, backend="pallas")


def family_batch(cfg, B, S, seed=0):
    """Uniform token ids (B, S) on the card and, for encdec, frame
    embeddings (B, num_frames, D) * 0.1, from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.num_frames, cfg.d_model),
                                      generator=g, device="cuda") * 0.1
    return batch


def decode_ffn(model):
    """The FFN modules that a decode step runs under the plan, in order:
    every block's of the hybrid, every decoder layer's of the encdec."""
    m = model.module
    layers = m.dec_layers if model.cfg.family == "encdec" else m.layers
    return [l.ffn for l in layers if hasattr(l, "ffn")]


def ffn_x_spy(ffn0):
    """A spy on blocks.ffn_apply that records the FFN input rows (D,) of
    `ffn0`'s calls under a plan (the decode's, the kernel's x)."""
    from repro_torch.models import blocks
    xs, inner = [], blocks.ffn_apply

    def spy(w, pred, x, activation, sparse_cfg, plan, *a, **k):
        if w is ffn0.w and plan is not None:
            xs.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return inner(w, pred, x, activation, sparse_cfg, plan, *a, **k)
    return (blocks, "ffn_apply", spy), xs


def family_decode(model, plan, B, S, spy=None):
    """One prefill of S tokens (B rows) through the Model API, then
    FAMILY_STEPS greedy decode steps under `plan`: each step's
    synchronized wall, the prefill's, the peak device memory above the
    start's, and fused_cold_ffn's launches, counted from 0 before the
    prefill and (with every other kernel's, which must stay 0) before the
    decode."""
    cfg = model.cfg
    batch = family_batch(cfg, B, S)
    free_cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cold_ffn.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(model.module, batch, S + FAMILY_STEPS)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = ops.fused_cold_ffn.launches
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    walls, toks = [], []
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    if spy is not None:
        mod, name, fn = spy
        inner = getattr(mod, name)
        setattr(mod, name, fn)
    try:
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(model.module, tok, cache, plan)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if logits.shape != (B, 1, cfg.vocab_padded) or not bool(
                    torch.isfinite(logits[..., :cfg.vocab_size]).all()):
                raise AssertionError(f"{cfg.name} B={B}: decode logits "
                                     f"{tuple(logits.shape)} not finite")
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(tok[:, 0].tolist())
    finally:
        if spy is not None:
            setattr(mod, name, inner)
    counts = ops.launch_counts()
    launches = counts.pop("fused_cold_ffn")
    per_step = len(decode_ffn(model)) if plan is not None else 0
    if prefill_launches or launches != per_step * FAMILY_STEPS or any(
            counts.values()):
        raise AssertionError(f"{cfg.name} B={B}: fused_cold_ffn launched "
                             f"{prefill_launches} times in the prefill and "
                             f"{launches} in {FAMILY_STEPS} decode steps, "
                             f"expected 0 and {per_step} per step; other "
                             f"kernels {counts}")
    if not bool((cache["length"] == S + FAMILY_STEPS).all()):
        raise AssertionError(f"{cfg.name}: cache length "
                             f"{cache['length'].tolist()}")
    if cfg.family == "hybrid":
        # the ring of W slots holds positions S - W .. S + steps - 1, the
        # decode's in the first slots: it wrapped
        W = cfg.local_window
        j = torch.arange(W, device=cache["kv_pos"].device)
        want = torch.where(j < FAMILY_STEPS, S + j, S - W + j)
        if S % W or not bool((cache["kv_pos"] == want).all()):
            raise AssertionError(f"{cfg.name}: the local ring did not wrap "
                                 f"as expected")
    w = np.array(walls) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    return dict(prefill_ms=t_prefill * 1e3,
                wall_ms_median=float(np.median(w)), wall_ms_first=float(w[0]),
                wall_ms=w.tolist(), peak_bytes=peak, launches=launches,
                launches_per_step=launches // FAMILY_STEPS, tokens=toks,
                profile=family_profile(model, plan, cache, tok))


def family_profile(model, plan, cache, tok, n=3):
    """torch.profiler over n more decode steps on the same cache: device
    busy time, kernels and fused_cold_ffn's kernels per step, and the
    kernels that take the most device time; "not measured" when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            logits, cache = model.decode_step(model.module, tok, cache, plan)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    if busy == 0.0:
        print("    profile: device time not measured (no CUDA events)")
        return dict(wall_ms_per_step=wall)
    cold = [e for e in dev if any(f"::{k}" in e.key for k in SUBKERNELS)]
    out = dict(wall_ms_per_step=wall, device_ms_per_step=busy,
               kernels_per_step=sum(e.count for e in dev) / n,
               cold_kernels_per_step=sum(e.count for e in cold) / n,
               cold_ms_per_step=sum(e.self_device_time_total
                                    for e in cold) / 1e3 / n,
               top={e.key[:60]: e.self_device_time_total / 1e3 / n
                    for e in sorted(dev, key=lambda e:
                                    -e.self_device_time_total)[:5]})
    print(f"    B={tok.shape[0]}, profile of {n} more steps: wall {wall:.2f} "
          f"ms/step, device busy "
          f"{busy:.3f} ms/step ({busy / wall:.1%}), "
          f"{out['kernels_per_step']:.0f} kernels/step, of them "
          f"{out['cold_kernels_per_step']:.0f} fused_cold_ffn kernels "
          f"({out['cold_ms_per_step']:.3f} ms/step); most device time: "
          + "; ".join(f"{v:.3f} ms {k}" for k, v in out["top"].items()))
    return out


def family_consistency(arch, layers, prompt, B):
    """prefill(prompt) + FAMILY_STEPS decode steps equal forward in fp32
    (TF32 off) at full width cut to `layers`, as
    tests/test_decode_consistency.py holds the reference: the logits of
    positions prompt .. prompt + steps - 2 within its tolerance."""
    cfg = family_cfg(arch, layers).replace(param_dtype="float32",
                                           compute_dtype="float32")
    free_cuda()
    model = build_model(cfg, "cuda", seed=0)
    S = prompt + FAMILY_STEPS
    batch = family_batch(cfg, B, S, seed=1)
    with torch.no_grad():
        full = model.forward(model.module, batch)[:, prompt:-1]
    _, cache = model.prefill(model.module, dict(
        batch, tokens=batch["tokens"][:, :prompt]), S)
    outs = []
    for t in range(prompt, S - 1):
        lg, cache = model.decode_step(model.module,
                                      batch["tokens"][:, t:t + 1], cache)
        outs.append(lg)
    dec = torch.cat(outs, 1)[..., :cfg.vocab_size]    # past it: -1e30
    full = full[..., :cfg.vocab_size]
    err = float((dec - full).abs().max())
    if not torch.allclose(dec, full, **CONSISTENCY_TOL):
        raise AssertionError(f"{arch} ({layers} layers, fp32): decode "
                             f"differs from forward by {err}")
    print(f"  {arch} at full width cut to {layers} layers, fp32, B={B}: "
          f"prefill {prompt} + {FAMILY_STEPS - 1} decode steps equal "
          f"forward, max |diff| {err:.3e} (max |logit| "
          f"{float(full.abs().max()):.3f}; atol 5e-3, rtol 1e-3)")
    del model, full, dec, outs, cache
    return err


def phase_families(card):
    """The ssm, hybrid and encdec families on the card through
    build_model's uniform API: (1) each at full width in bf16
    (mamba2-130m, 24 layers; recurrentgemma-9b, 38 layers; seamless,
    24 encoder and 24 decoder layers over 4,096 frames), one prefill then
    FAMILY_STEPS greedy decode steps at B 1 and 4 under make_plan's
    "pallas" plan: finite logits, fused_cold_ffn launched once per FFN
    layer and step (38, 24, 0) and never in the prefill, recurrentgemma's
    local ring wrapped; the prefill's time, the wall per step, the peak
    memory and the device busy time of 3 more steps; then the kernel on
    layer 0's weights and x from the decode at B 1/4/32 against its
    plain version (ids identical but for
    near ties; y within the bf16 tolerance plus `rounding_allowance`,
    which covers the CATS gates at zero) and timed in a CUDA graph beside
    its bound; (2) decode against forward in fp32 at full width, cut in
    depth; (3) one fp32 train step of each reduced config, card against
    CPU."""
    out = {"serve": {}, "consistency": {}, "train": {}}
    for arch, prompt in FAMILIES:
        free_cuda()
        cfg = family_cfg(arch)
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda", seed=0)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        plan = family_plan(cfg)
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.module.parameters())
        enc = f"{cfg.num_encoder_layers} encoder + " \
            if cfg.num_encoder_layers else ""
        print(f"== phase families: {arch} at full width (D {cfg.d_model}, "
              f"{enc}{cfg.num_layers} layers, d_ff {cfg.d_ff}, "
              f"{cfg.param_dtype}, {n_bytes / 1e9:.2f} GB of weights, built "
              f"in {t_build:.1f} s), prompt {prompt}"
              + ("" if plan is None else
                 f"; plan n_hot {plan.n_hot}, kc {plan.clusters_per_group} "
                 f"of {(cfg.d_ff - plan.n_hot) // plan.cluster_size} "
                 f"clusters of {plan.cluster_size}"))
        runs, xs = {}, []
        ffns = decode_ffn(model)
        for B in FAMILY_BATCHES:
            spy, rows = ffn_x_spy(ffns[0]) if ffns else (None, [])
            r = family_decode(model, plan, B, prompt, spy)
            xs += rows
            runs[B] = r
            print(f"  B={B}: prefill {r['prefill_ms']:.1f} ms; decode wall "
                  f"per step median {r['wall_ms_median']:.2f} ms (first "
                  f"{r['wall_ms_first']:.2f}); fused_cold_ffn "
                  f"{r['launches_per_step']} launches per step; peak device "
                  f"memory {r['peak_bytes'] / 2**20:.1f} MiB above the "
                  f"weights")
        kt = {}
        if plan is not None:
            rows = torch.cat(xs)
            if rows.shape[0] < max(ARCH_BATCHES):
                raise AssertionError(f"{arch}: {rows.shape[0]} rows of x")
            print(f"  fused_cold_ffn on layer 0, x from the decode "
                  f"({cfg.activation}, R {ffns[0].w.shape[1]}):")
            kt = arch_kernel(cfg, ffns[0], lambda B: plan, rows,
                             rounding=True)
        out["serve"][arch] = dict(
            layers=cfg.num_layers, encoder_layers=cfg.num_encoder_layers,
            prompt=prompt, weight_bytes=n_bytes, build_s=t_build,
            runs=runs, kernels=kt,
            launches=sum(r["launches"] for r in runs.values()),
            launches_per_step=runs[1]["launches_per_step"])
        del model, ffns, xs, plan
    free_cuda()
    print("== phase families: decode against forward, fp32 at full width "
          f"({card})")
    for arch, layers, prompt, B in FAMILY_CONSISTENCY:
        out["consistency"][arch] = dict(
            layers=layers, prompt=prompt,
            max_abs_diff=family_consistency(arch, layers, prompt, B))
    free_cuda()
    print("== phase families: one fp32 train step, card against CPU")
    for arch, _ in FAMILIES:
        out["train"][arch] = train_parity(get_config(arch).reduced())
    return out


# --------------------------------------------------------- phase famtp ----

# the ssm, hybrid and encdec families over ranks sharing the card (as phase
# tp), bf16 unless marked; widths whole, depths cut to keep the phase
# within 150 s: recurrentgemma-9b to 6 of 38 layers (two whole rec, rec,
# attn groups), seamless-m4t-large-v2 to 4 encoder and 4 decoder layers
# of 24 each; mamba2-130m whole (24 layers)
FAMTP_WORLD = 4
FAMTP_MAMBA, FAMTP_MAMBA_TPS = "mamba2-130m", (2, 4)
# (arch, layers kept, tp sizes, dtype); the plan's groups=4 divide every
# size. fp32 holds tokens, logits and ids to tp=1's (cut further: one
# rec, rec, attn group; 2 + 2 layers); bf16 holds each layer on the same
# x and times the per-rank kernel
FAMTP_SERVE = (("recurrentgemma-9b", 3, (4,), "float32"),
               ("recurrentgemma-9b", 6, (4,), "bfloat16"),
               ("seamless-m4t-large-v2", 2, (2, 4), "float32"),
               ("seamless-m4t-large-v2", 4, (2, 4), "bfloat16"))
FAMTP_GROUPS = 4
FAMTP_PROMPT, FAMTP_B = 64, 2     # 2 rows x 16 steps: 32 rows of x
FAMTP_LOGIT_REL = 1e-5            # fp32 logits over max |logit|
FAMTP_BF16_REL = 1e-2             # bf16 outputs over max |y| on the same x
# the fp32 step: the loss relative; each gathered gradient leaf over its
# max |g|, the golden recipe's bar (on the card the rank's slices take
# other GEMM kernels than one rank's: 1.57e-05 at conv_w over 24 layers)
FAMTP_TRAIN_LOSS_REL, FAMTP_TRAIN_GRAD_REL = 1e-6, TRAIN_GRAD_REL
FAMTP_TRAIN_STEPS_REL = 1e-2      # each bf16 step's loss against one rank
# launch.train's own recipe (its train() and CLI defaults)
FAMTP_RECIPE = dict(lr=1e-3, batch=8, seq=128)


def famtp_plan(cfg):
    """make_plan of the config's sparse FFN under backend "pallas" with
    groups=FAMTP_GROUPS (hot 0.4, cold-active 0.2, clusters of 128)."""
    s = cfg.sparse_ffn
    return make_plan(cfg.d_ff, s.hot_ratio, s.cold_active_ratio,
                     s.cluster_size, groups=FAMTP_GROUPS, backend="pallas")


def famtp_decode(model, plan, record=False):
    """Prefill FAMTP_PROMPT tokens of FAMTP_B rows, then FAMILY_STEPS
    greedy steps under `plan` on this rank: the prefill's and every
    step's logits over the vocabulary (on the host, fp32), the tokens, each step's gathered
    cluster ids (L, G, kc), with `record` each (step, FFN layer)'s input
    rows, every kernel's launches in the decode (counted from 0 after
    the prefill), the walls and collectives per step."""
    from repro_torch.models import blocks
    cfg = model.cfg
    batch = family_batch(cfg, FAMTP_B, FAMTP_PROMPT)
    logits, cache = model.prefill(model.module, batch,
                                  FAMTP_PROMPT + FAMILY_STEPS)
    V = cfg.vocab_size          # past it the padding's -1e30
    out = dict(logits=[logits[..., :V].float().cpu()], toks=[], ids=[],
               xs=[], walls=[], coll=[])
    layer_of = {id(f.w): i for i, f in enumerate(decode_ffn(model))}
    inner = blocks.ffn_apply

    def spy(w, pred, x, act, scfg, p, *a, **k):
        if record and p is not None:
            out["xs"].append((layer_of[id(w)],
                              x.detach().reshape(-1, x.shape[-1]).clone()))
        return inner(w, pred, x, act, scfg, p, *a, **k)
    ops.set_launch_counts({k: 0 for k in ops.launch_counts()})
    blocks.ffn_apply = spy
    try:
        for _ in range(FAMILY_STEPS):
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out["toks"].append(tok[:, 0].tolist())
            c0, s0 = TP_COLL["calls"], TP_COLL["seconds"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cfg.family == "ssm":
                logits, cache = model.decode_step(model.module, tok, cache,
                                                  plan)
            else:
                logits, cache, ids = model.decode_step(
                    model.module, tok, cache, plan, collect_indices=True)
                out["ids"].append(ids.cpu().numpy())
            torch.cuda.synchronize()
            out["walls"].append(time.perf_counter() - t0)
            out["coll"].append((TP_COLL["calls"] - c0,
                                TP_COLL["seconds"] - s0))
            out["logits"].append(logits[..., :V].float().cpu())
    finally:
        blocks.ffn_apply = inner
    out["launches"] = ops.launch_counts()
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.module.parameters())
    return out


def famtp_summary(r) -> dict:
    """The per-step numbers of a famtp_decode run."""
    c, secs = np.array(r["coll"], dtype=float).T
    return dict(wall_ms=float(np.median(r["walls"][1:]) * 1e3),
                coll_per_step=float(np.median(c[1:])),
                coll_ms_per_step=float(np.median(secs[1:]) * 1e3),
                launches=r["launches"]["fused_cold_ffn"],
                weight_bytes=r["weight_bytes"])


def famtp_rel(a, b) -> float:
    """max |a - b| over max |b| (b the one-rank value)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def famtp_mamba(world, groups):
    """mamba2-130m whole at tp 2 and 4 against tp=1 (every rank runs tp=1
    itself, from the same seed): in fp32 the greedy tokens identical and
    every logit within FAMTP_LOGIT_REL of max |logit|; in bf16 each
    layer's prefill output on the same x within FAMTP_BF16_REL of max |y|
    and the decode's token agreement counted; no kernel launch."""
    from repro_torch.models import dense as mdense, ssm as mssm
    out, t0 = {}, time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(FAMTP_MAMBA).replace(param_dtype=dtype,
                                              compute_dtype=dtype)
        whole = build_model(cfg, "cuda", seed=0)
        one = famtp_decode(whole, None)
        xs = []
        if dtype == "bfloat16":
            with torch.no_grad():
                x = mdense.embed_tokens(whole.module, family_batch(
                    cfg, FAMTP_B, FAMTP_PROMPT)["tokens"])
                for lp in whole.module.layers:
                    y = mssm._layer_full(lp, x, cfg)[0]
                    xs.append((x, y))
                    x = y
        for n in FAMTP_MAMBA_TPS:
            torch.distributed.barrier(group=world.group)
            g = groups[n]
            if not g.member:
                continue
            local = build_model(cfg, "cuda", seed=0, shard=g)
            on_card(local.module)
            r = famtp_decode(local, None)
            if any(r["launches"].values()):
                raise AssertionError(f"mamba2 tp={n}: kernel launches "
                                     f"{r['launches']}")
            res = famtp_summary(r)
            if dtype == "float32":
                if r["toks"] != one["toks"]:
                    raise AssertionError(f"mamba2 fp32 tp={n} rank "
                                         f"{g.rank}: tokens differ from "
                                         f"tp=1's")
                res["logit_rel"] = max(famtp_rel(a, b) for a, b in
                                       zip(r["logits"], one["logits"]))
                if res["logit_rel"] > FAMTP_LOGIT_REL:
                    raise AssertionError(f"mamba2 fp32 tp={n}: logits "
                                         f"{res['logit_rel']:.3e} of max "
                                         f"|logit| from tp=1's")
            else:
                with torch.no_grad():
                    res["layer_rel"] = max(famtp_rel(
                        mssm._layer_full(lp, x, cfg, shard=g)[0].float(),
                        y.float()) for lp, (x, y) in
                        zip(local.module.layers, xs))
                if res["layer_rel"] > FAMTP_BF16_REL:
                    raise AssertionError(f"mamba2 bf16 tp={n}: a layer's "
                                         f"output on the same x is "
                                         f"{res['layer_rel']:.3e} of max "
                                         f"|y| from tp=1's")
                res["agree"] = float(np.mean(np.array(r["toks"]) ==
                                             np.array(one["toks"])))
            out[dtype, n] = res
            del local
        out[dtype, 1] = famtp_summary(one)
        out["layers"] = cfg.num_layers
        del whole, xs
        free_cuda()
    out["seconds"] = time.perf_counter() - t0
    return out


def famtp_same_x(cfg, whole, plan, run):
    """Every (step, FFN layer) of `run`: the gathered ids against the
    unsharded selection (the plain version over the whole model's layer)
    on the same x, identical but for fp64-confirmed near ties. Returns
    the count of near ties."""
    ffns, near = decode_ffn(whole), 0
    L = len(ffns)
    for i, (l, x) in enumerate(run["xs"]):
        wc, A, Bp = layer_operands(ffns[l], plan)
        mask = torch.ones(x.shape[0], device=x.device)
        ids = torch.from_numpy(run["ids"][i // L][l]).to(x.device)
        _, ir = fused_cold_ffn_ref(x, wc, A, Bp, mask,
                                   activation=cfg.activation,
                                   cats=cfg.sparse_ffn.mode == "cats",
                                   kc=plan.clusters_per_group)
        nr, real = pick_disagreements(ids, ir, x, wc, A, Bp, mask)
        if real:
            raise AssertionError(f"{cfg.name} step {i // L} FFN layer {l}: "
                                 f"the group picked {real} against the "
                                 f"unsharded selection on the same x")
        near += bool(nr)
    return near


def famtp_exact(arch, n, r, one) -> dict:
    """Hold an fp32 decode at tp=n to tp=1's: tokens and every step's
    gathered ids identical, every logit within FAMTP_LOGIT_REL of max
    |logit|."""
    rel = max(famtp_rel(a, b) for a, b in zip(r["logits"], one["logits"]))
    same_ids = all(np.array_equal(a, b) for a, b in zip(r["ids"],
                                                        one["ids"]))
    if r["toks"] != one["toks"] or not same_ids or rel > FAMTP_LOGIT_REL:
        raise AssertionError(f"{arch} fp32 tp={n}: tokens equal "
                             f"{r['toks'] == one['toks']}, ids equal "
                             f"{same_ids}, logits {rel:.3e} of max |logit| "
                             f"from tp=1's")
    return dict(logit_rel=rel, ids_equal_steps=len(r["ids"]))


@torch.no_grad()
def famtp_layers(whole, local, g) -> float:
    """Every layer of a hybrid or encdec prefill on the same x: the rank's
    slice over `g` against the whole model's layer, the x of each layer
    the whole model's chain (the encdec's decoder reads the whole
    encoder's memory, each model through its own cross K/V); the worst
    max |y - y_whole| over max |y_whole|."""
    from repro_torch.models import dense as mdense, encdec as menc, \
        rglru as mrg
    cfg = whole.cfg
    batch = family_batch(cfg, FAMTP_B, FAMTP_PROMPT)
    S, worst = batch["tokens"].shape[1], 0.0

    def hold(y, yl):
        nonlocal worst
        worst = max(worst, famtp_rel(yl.float(), y.float()))
        return y
    if cfg.family == "hybrid":
        x = mdense.embed_tokens(whole.module, batch["tokens"])
        angles = mrg._angles(cfg, torch.arange(S, device=x.device))
        for lw, ll in zip(whole.module.layers, local.module.layers):
            x = hold(mrg._full_layer(lw, x, cfg, angles, None)[0],
                     mrg._full_layer(ll, x, cfg, angles, None, g)[0])
        return worst
    x = batch["frames"].to(dtype_of(cfg.compute_dtype))
    angles = menc._angles(cfg, x.shape[1], x.device)
    for lw, ll in zip(whole.module.enc_layers, local.module.enc_layers):
        x = hold(menc._enc_layer(lw, x, cfg, angles),
                 menc._enc_layer(ll, x, cfg, angles, g))
    memory = rms_norm(x, whole.module.enc_norm, cfg.norm_eps)
    mk, mv = menc.cross_memory(whole.module, memory)
    lk, lv = menc.cross_memory(local.module, memory, g)
    x = mdense.embed_tokens(whole.module, batch["tokens"])
    angles = menc._angles(cfg, S, x.device)
    for l, (lw, ll) in enumerate(zip(whole.module.dec_layers,
                                     local.module.dec_layers)):
        x = hold(menc._dec_layer_full(lw, x, cfg, angles, mk[l], mv[l],
                                      None)[0],
                 menc._dec_layer_full(ll, x, cfg, angles, lk[l], lv[l], None,
                                      g)[0])
    return worst


def famtp_serve(world, groups, arch, layers, sizes, dtype):
    """A family with an FFN at full width, cut to `layers`, in `dtype`,
    under famtp_plan: tp=1 on rank 0, then each tp of `sizes` on ranks
    [0, n): fused_cold_ffn launched once per FFN layer and step on every
    rank (and no other kernel). In fp32 the greedy tokens and every
    step's gathered ids identical to tp=1's and every logit within
    FAMTP_LOGIT_REL of max |logit|. In bf16 every layer's prefill output
    on the same x within FAMTP_BF16_REL of max |y| of the whole model's
    (famtp_layers), the prefill logits' distance and the greedy tokens'
    agreement with tp=1 reported, every
    (step, layer)'s gathered ids against the unsharded selection on the
    same x (rank 0), then layer 0's per-rank kernel against its plain
    version at B 1/4/32 and timed in a CUDA graph beside its bound."""
    from repro_torch.bridge import shard_model
    cfg = family_cfg(arch, layers).replace(param_dtype=dtype,
                                           compute_dtype=dtype)
    exact = dtype == "float32"
    plan = famtp_plan(cfg)
    t0 = time.perf_counter()
    whole = build_model(cfg, "cuda", seed=0) \
        if groups[max(sizes)].member else None
    n_ffn = len(decode_ffn(whole)) if whole is not None else 0
    out = {}
    if world.rank == 0:
        one = famtp_decode(whole, plan)
        out[1] = famtp_summary(one)
    for n in sizes:
        torch.distributed.barrier(group=world.group)
        g = groups[n]
        if not g.member:
            continue
        free_cuda()
        local = wrap(shard_model(whole.module, plan, g, "cuda"), g)
        on_card(local.module)
        r = famtp_decode(local, plan, record=True)
        launches = r["launches"].pop("fused_cold_ffn")
        if launches != n_ffn * FAMILY_STEPS or any(r["launches"].values()):
            raise AssertionError(f"{arch} tp={n} rank {g.rank}: "
                                 f"fused_cold_ffn launched {launches} times "
                                 f"in {FAMILY_STEPS} steps of {n_ffn} FFN "
                                 f"layers; other kernels {r['launches']}")
        r["launches"]["fused_cold_ffn"] = launches
        res = famtp_summary(r)
        res["ffn_rows"] = len(decode_ffn(local)[0].rows.ids)
        if exact:
            if g.rank == 0:
                res.update(famtp_exact(arch, n, r, one))
            out[n] = res
            del local, r
            continue
        res["layer_rel"] = famtp_layers(whole, local, g)
        if res["layer_rel"] > FAMTP_BF16_REL:
            raise AssertionError(f"{arch} tp={n} rank {g.rank}: a layer's "
                                 f"prefill output on the same x is "
                                 f"{res['layer_rel']:.3e} of max |y| from "
                                 f"tp=1's")
        if g.rank == 0:
            res["prefill_rel"] = famtp_rel(r["logits"][0], one["logits"][0])
            res["agree"] = float(np.mean(np.array(r["toks"]) ==
                                         np.array(one["toks"])))
            res["ids_equal_steps"] = int(sum(np.array_equal(a, b) for a, b
                                             in zip(r["ids"], one["ids"])))
            t1 = time.perf_counter()
            res["near"] = famtp_same_x(cfg, whole, plan, r)
            res["same_x_s"] = time.perf_counter() - t1
        # the FFN input is the same on every rank: each holds its own
        # slice on its own rows of x
        xs0 = torch.cat([x for l, x in r["xs"] if l == 0])
        res["kernel"] = tp_rank_kernel(cfg, decode_ffn(local)[0],
                                       lambda B: plan, g, xs0, rounding=True)
        out[n] = res
        del local, r
    out["seconds"] = time.perf_counter() - t0
    del whole
    free_cuda()
    return cfg, out


def famtp_train(world, rows, cols):
    """mamba2-130m whole at dp=2 x tp=2 against one rank (world rank 0,
    the others waiting), the same seeded weights and batches: one fp32
    train step (loss within FAMTP_TRAIN_LOSS_REL relative, every gathered
    gradient leaf within FAMTP_TRAIN_GRAD_REL of its max |g|; the
    one-rank step's own fp32 noise, its gradients on the batch with the
    rows reversed, is reported beside it), then
    TPT_STEPS bf16 steps of launch.train's loop at its own recipe
    (FAMTP_RECIPE; tpt_run: each loss
    within FAMTP_TRAIN_STEPS_REL relative, the last below the first, no
    kernel launch)."""
    t0 = time.perf_counter()
    cfg32 = get_config(FAMTP_MAMBA).replace(param_dtype="float32",
                                            compute_dtype="float32")
    batch = SyntheticTokens(DataConfig(cfg32.vocab_size, TRAIN_SEQ,
                                       TRAIN_BATCH, seed=0)).batch()
    out = {}
    if world.rank == 0:
        one = build_model(cfg32, "cuda", seed=0)
        loss, grads = loss_and_grads(one, one.params(),
                                     shard_batch(batch, "cuda"))
        want = (float(loss), params_to_numpy(one.module, grads).tree)
        # the one-rank step's own fp32 noise: the same batch, its rows
        # reversed, sums the gradients in another order
        flip = {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}
        _, grads = loss_and_grads(one, one.params(),
                                  shard_batch(flip, "cuda"))
        noise = worst_leaf(want[1], params_to_numpy(one.module, grads).tree)
        del one, grads
    torch.distributed.barrier(group=world.group)
    model = build_model(cfg32, "cuda", seed=0, shard=rows)
    on_card(model.module)
    loss, grads = loss_and_grads(model, model.params(), shard_batch(
        batch, "cuda", cols.rank, TPT_DP), cols)
    tree = gather_params(model.module, rows, values=grads) \
        if cols.rank == 0 else None
    out["loss"] = float(loss)
    if world.rank == 0:
        rel = abs(out["loss"] - want[0]) / abs(want[0])
        worst = worst_leaf(want[1], tree.tree)
        bar = FAMTP_TRAIN_GRAD_REL
        if rel > FAMTP_TRAIN_LOSS_REL or worst[0] > bar:
            raise AssertionError(f"mamba2 dp x tp fp32 step: loss "
                                 f"{out['loss']} against {want[0]} "
                                 f"({rel:.3e}), worst gradient {worst[0]:.3e} "
                                 f"of its max ({worst[1]}), above "
                                 f"{bar:.3e}; one rank's own noise "
                                 f"{noise[0]:.3e} ({noise[1]})")
        out.update(loss_one=want[0], loss_rel=rel, grad_worst_rel=worst[0],
                   grad_worst_leaf=worst[1], noise_rel=noise[0],
                   noise_leaf=noise[1], grad_bar=bar)
    del model, grads, tree
    free_cuda()
    cfg = get_config(FAMTP_MAMBA)
    base = None
    if world.rank == 0:
        m, base = tpt_run(cfg, **FAMTP_RECIPE)
        del m
    torch.distributed.barrier(group=world.group)
    m, run = tpt_run(cfg, rows, cols, **FAMTP_RECIPE)
    del m
    if run["launches"]:
        raise AssertionError(f"rank {world.rank}: the mamba2 train steps "
                             f"launched {run['launches']} kernels")
    if world.rank == 0:
        losses, ref = np.array(run["losses"]), np.array(base["losses"])
        rel = np.abs(losses - ref) / np.abs(ref)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and (rel <= FAMTP_TRAIN_STEPS_REL).all()):
            raise AssertionError(f"mamba2 dp x tp losses {losses} against "
                                 f"one rank's {ref}")
        run.update(one=base, loss_rel=rel.tolist())
    out["steps"] = run
    out["seconds"] = time.perf_counter() - t0
    free_cuda()
    return out


def famtp_rank(world):
    """Every case of phase famtp on this rank of the gloo world (all
    ranks on cuda:0); its results for the parent to print."""
    from repro_torch.parallel import grid, replica_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    spy_collectives()
    t0 = time.perf_counter()
    a = torch.ones((8, 8), device=world.device)
    float((a @ a).sum())
    groups = {n: replica_groups(world, FAMTP_WORLD // n, n)[0]
              for n in (2, 4)}
    out = {"mamba2": famtp_mamba(world, groups)}
    for arch, layers, sizes, dtype in FAMTP_SERVE:
        torch.distributed.barrier(group=world.group)
        out[arch, dtype] = famtp_serve(world, groups, arch, layers, sizes,
                                       dtype)
    torch.distributed.barrier(group=world.group)
    rows, cols = grid(world, TPT_DP, TPT_TP)
    out["train"] = famtp_train(world, rows, cols)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_famtp(card):
    """The ssm, hybrid and encdec families over gloo ranks sharing the
    card (as phase tp): the ranks hold what they can alone and this
    process prints the per-rank numbers. A failing rank fails the
    phase."""
    from repro_torch.parallel import spawn
    print(f"== phase famtp: {FAMTP_WORLD} gloo ranks sharing the card "
          f"(the families over tp ranks; mamba2 training at dp={TPT_DP} x "
          f"tp={TPT_TP}; {card})")
    free_cuda()
    t0 = time.perf_counter()
    ranks = spawn(famtp_rank, FAMTP_WORLD, device="cuda", threads=2,
                  timeout=600)
    out = {"seconds": time.perf_counter() - t0,
           "rank_seconds": [r["seconds"] for r in ranks]}
    m = [r["mamba2"] for r in ranks]
    for dtype in ("float32", "bfloat16"):
        one = m[0][dtype, 1]
        print(f"  mamba2-130m whole ({m[0]['layers']} layers, {dtype}), "
              f"prefill "
              f"{FAMTP_PROMPT} + {FAMILY_STEPS} greedy steps at B "
              f"{FAMTP_B}: tp=1 {one['wall_ms']:.2f} ms/step")
        for n in FAMTP_MAMBA_TPS:
            rs = [x[dtype, n] for x in m[:n]]
            what = (f"tokens identical to tp=1's, logits within "
                    f"{max(r['logit_rel'] for r in rs):.2e} of max |logit|"
                    if dtype == "float32" else
                    f"each layer's output on the same x within "
                    f"{max(r['layer_rel'] for r in rs):.2e} of max |y|, "
                    f"tokens agreeing {rs[0]['agree']:.0%}")
            print(f"    tp={n}: {what}; no kernel launch; per rank wall "
                  + ", ".join(f"{r['wall_ms']:.2f}" for r in rs)
                  + " ms/step, collectives "
                  + ", ".join(f"{r['coll_per_step']:.0f} in "
                              f"{r['coll_ms_per_step']:.2f} ms" for r in rs)
                  + ", weights "
                  + ", ".join(f"{r['weight_bytes'] / 2**20:.1f}" for r in rs)
                  + " MiB")
        out[f"mamba2 {dtype}"] = {n: [x[dtype, n] for x in m[:n]]
                                  for n in (1,) + FAMTP_MAMBA_TPS}
    for arch, layers, sizes, dtype in FAMTP_SERVE:
        cfg, _ = ranks[0][arch, dtype]
        one = ranks[0][arch, dtype][1][1]
        print(f"  {arch} (D {cfg.d_model}, {cfg.activation}, "
              f"{layers} layers{' + encoder' if cfg.num_encoder_layers else ''}"
              f", {dtype}), plan groups={FAMTP_GROUPS} (pallas): tp=1 "
              f"{one['wall_ms']:.2f} ms/step, {one['launches']} launches")
        res = {1: one}
        for n in sizes:
            rs = [r[arch, dtype][1][n] for r in ranks[:n]]
            r0 = rs[0]
            if dtype == "float32":
                print(f"    tp={n}: tokens and the gathered ids of all "
                      f"{r0['ids_equal_steps']} steps identical to tp=1's, "
                      f"logits within {r0['logit_rel']:.2e} of max |logit|; "
                      f"fused_cold_ffn {r0['launches'] // FAMILY_STEPS} "
                      f"launches per step on every rank; per rank wall "
                      + ", ".join(f"{r['wall_ms']:.2f}" for r in rs)
                      + " ms/step")
                res[n] = rs
                continue
            print(f"    tp={n}: fused_cold_ffn {r0['launches'] // FAMILY_STEPS}"
                  f" launches per step on every rank; each layer's prefill "
                  f"output on the same x within "
                  f"{max(r['layer_rel'] for r in rs):.2e} of max |y|; the "
                  f"prefill logits {r0['prefill_rel']:.2e} of max from "
                  f"tp=1's (bf16 over {layers} layers); tokens agreeing "
                  f"{r0['agree']:.0%}, gathered ids equal to tp=1's in "
                  f"{r0['ids_equal_steps']} of {FAMILY_STEPS} steps and to "
                  f"the unsharded selection on the same x but for "
                  f"{r0['near']} near ties; per rank wall "
                  + ", ".join(f"{r['wall_ms']:.2f}" for r in rs)
                  + " ms/step, collectives "
                  + ", ".join(f"{r['coll_per_step']:.0f} in "
                              f"{r['coll_ms_per_step']:.2f} ms" for r in rs)
                  + f", FFN rows {r0['ffn_rows']} of {cfg.d_ff}, weights "
                  + ", ".join(f"{r['weight_bytes'] / 2**20:.0f}" for r in rs)
                  + " MiB")
            for i, r in enumerate(rs):
                print(f"      rank {i} layer 0 kernel: " + "; ".join(
                    f"B={B} {t['graph_ms'] * 1e3:.2f} us in a graph "
                    f"({t['ms'] * 1e3:.2f} eager, plain "
                    f"{t['plain_ms'] * 1e3:.2f}, bound "
                    f"{t['bound_ms'] * 1e3:.3f} us, {t['bound_by']}; err "
                    f"{t['max_abs_err']:.2e})"
                    for B, t in r["kernel"].items()))
            res[n] = rs
        out[f"{arch} {dtype}"] = res
    t = [r["train"] for r in ranks]
    st = [x["steps"] for x in t]
    print(f"  mamba2-130m training, dp={TPT_DP} x tp={TPT_TP} against one "
          f"rank: fp32 step loss {t[0]['loss']:.6f} ({t[0]['loss_rel']:.2e} "
          f"relative), worst gradient {t[0]['grad_worst_rel']:.2e} of its "
          f"max ({t[0]['grad_worst_leaf']}; one rank against itself on the "
          f"reversed batch: {t[0]['noise_rel']:.2e}, {t[0]['noise_leaf']}; "
          f"bar {t[0]['grad_bar']:.2e}); {TPT_STEPS} bf16 steps of launch.train's loop, losses "
          f"{st[0]['losses'][0]:.4f} -> {st[0]['losses'][-1]:.4f} (worst "
          f"{max(st[0]['loss_rel']):.2e} relative to one rank's); one rank "
          f"{st[0]['one']['wall_ms']:.1f} ms/step; per rank wall "
          + ", ".join(f"{s['wall_ms']:.1f}" for s in st)
          + " ms/step, collectives "
          + ", ".join(f"{s['coll_per_step']:.0f} in "
                      f"{s['coll_ms_per_step']:.1f} ms" for s in st)
          + ", weights "
          + ", ".join(f"{s['weight_bytes'] / 2**20:.1f}" for s in st)
          + " MiB")
    out["train"] = dict(parity=t[0], steps=st)
    print(f"  phase famtp ranks {out['seconds']:.1f} s (rank 0's cases: "
          f"mamba2 {ranks[0]['mamba2']['seconds']:.1f} s, "
          + ", ".join(f"{a} {d} {ranks[0][a, d][1]['seconds']:.1f} s"
                      for a, _, _, d in FAMTP_SERVE)
          + f", training {t[0]['seconds']:.1f} s)")
    return out


# ------------------------------------------------------- phase examples ----

EXAMPLES = ("quickstart", "best_of_n", "offloaded_serving",
            "plan_and_inspect")


def phase_examples():
    """The four examples of examples_torch/ on the card at the reference
    examples' reduced sizes: each main() finishes, and best-of-N's batch
    timeline decays 4 -> 1."""
    import importlib.util
    root = Path(__file__).resolve().parent / "examples_torch"
    out = {}
    for name in EXAMPLES:
        print(f"== phase examples: examples_torch/{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        res = mod.main()
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.perf_counter() - t0)
        if name == "best_of_n":
            b = res["batches"]
            if b[0] != 4 or b[-1] != 1 or any(
                    x < y for x, y in zip(b, b[1:])):
                raise AssertionError(f"best-of-N batch timeline {b} does "
                                     f"not decay 4 -> 1")
            out[name].update(batches=b, switches=res["switches"])
        print(f"  [{name}: {out[name]['seconds']:.1f} s]")
        free_cuda()
    return out


def phase_analyze(built):
    """The analysis gate's card tier (python -m repro_torch.analysis is
    its CPU side): (1) the dispatch self-test on the card, where
    dispatch-h2d must fire too, then every entry of analysis/entries.py
    on the card (tp / ep 2 on two gloo ranks sharing it), graphed
    entries under torch.cuda's sync debug mode "error", eager ones
    under "warn", each finding allowlisted (the committed
    analysis/allowlist.json, its dispatch/cuda/ keys) or failing, and
    no finding at all for a graphed entry; (2) the build's -Xptxas -v
    report of each source: registers, static smem and spills of every
    kernel, the static smem equal to the smem-budget rule's estimate,
    any spill a finding; (3) compute-sanitizer: racecheck over one
    fused_cold_ffn call (analysis/sanitizer.py's probe). Where the tool
    answers "Device not supported", the phase prints that line and the
    tier is blocked (nothing is checked, nothing claimed); a run that
    neither is blocked nor reaches the driver's end fails, as does a
    hazard. The other tools, kernels and the race mutants are not
    written (ROADMAP), and the phase says so where the tool runs. The
    kernel launches of this phase are checks, so the counts are put
    back."""
    from repro_torch.analysis import sanitizer
    from repro_torch.analysis.__main__ import DEFAULT_ALLOWLIST
    from repro_torch.analysis.dispatch_rules import dispatch_findings
    from repro_torch.analysis.dispatch_selftest import (
        run_dispatch_self_test)
    from repro_torch.analysis.entries import entries
    from repro_torch.analysis.framework import apply_allowlist, load_json
    from repro_torch.analysis.kernel_hygiene import ptxas_findings
    counts = ops.launch_counts()
    out = {}
    print("== phase analyze: the dispatch tier on the card")
    t0 = time.perf_counter()
    ok, lines = run_dispatch_self_test("cuda")
    for line in lines:
        print(f"  self-test {line}")
    if not ok:
        raise AssertionError("the dispatch self-test fails on the card")
    findings = dispatch_findings("cuda")
    allow = {k: v for k, v in load_json(DEFAULT_ALLOWLIST, {}).items()
             if k.startswith("dispatch/cuda/")}
    kept, allowed, stale = apply_allowlist(findings, allow)
    graphed = {e.path("cuda") for e in entries() if e.graphed}
    for f in findings:
        print(f"  {'allowlisted' if f in allowed else 'FINDING'} {f}")
    bad = [f for f in findings if f.path in graphed]
    if kept or stale or bad:
        raise AssertionError(f"dispatch tier on the card: {len(kept)} "
                             f"finding(s) outside the allowlist, stale "
                             f"entries {stale}, graphed-entry findings "
                             f"{[str(f) for f in bad]}")
    out["dispatch"] = dict(entries=len(entries()), findings=len(findings),
                           allowlisted=[f.key for f in allowed],
                           seconds=time.perf_counter() - t0)
    print(f"  [dispatch: {len(entries())} entries, {len(findings)} "
          f"allowlisted finding(s), {out['dispatch']['seconds']:.1f} s]")

    print("== phase analyze: ptxas against the smem-budget estimate")
    out["ptxas"] = {}
    for name, b in built.items():
        src = kbuild.CSRC / f"{name}.cu"
        fs, rows = ptxas_findings(
            f"src/repro_torch/kernels/csrc/{name}.cu", src.read_text(),
            b.report)
        for r in rows:
            print(f"  {r['kernel']}<{r['T']}>: {r['registers']} registers, "
                  f"{r['smem']} B static smem, {r['spill']} B spills")
        for f in fs:
            print(f"  FINDING {f}")
        if fs or not rows:
            raise AssertionError(f"{name}.cu: ptxas disagrees with the "
                                 f"static estimate or spills: {fs}")
        out["ptxas"][name] = [{k: r[k] for k in ("kernel", "T", "registers",
                                                 "smem", "spill")}
                              for r in rows]

    print("== phase analyze: compute-sanitizer")
    probe = sanitizer.run_tool("racecheck", timeout=120)
    if probe.blocked:
        print(f"  compute-sanitizer is blocked on this machine: "
              f"{probe.blocked!r}; no tool ran, nothing is checked")
        out["sanitizer"] = dict(blocked=probe.blocked)
    else:
        if probe.hazards:
            raise AssertionError(f"racecheck over fused_cold_ffn: "
                                 f"{[str(f) for f in probe.findings()]}")
        print("  racecheck over fused_cold_ffn: no hazard; the other "
              "tools, kernels and the race mutants are not written here "
              "(ROADMAP), so nothing else is checked")
        out["sanitizer"] = dict(racecheck_fused_cold_ffn=0)
    ops.set_launch_counts(counts)
    print(json.dumps({"analyze": out}))
    return out


PHASES = ("kernel", "quant", "times", "gather", "serve", "parity", "api",
          "fleet", "archs", "vlm", "moe", "plan", "tp", "tptrain",
          "train", "families", "famtp", "examples", "analyze")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", type=lambda v: v.split(","), default=None,
                    help="comma-separated phases to run after the card and "
                         f"the build, of {','.join(PHASES)}; the summary "
                         "and the result line need them all")
    only = ap.parse_args(argv).only
    if only is not None and not set(only) <= set(PHASES):
        ap.error(f"--only takes phases of {PHASES}, got {only}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    print("== phase 1: card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    built = kbuild.build()
    for b in built.values():
        print(f"  {b.name}: {b.seconds:.1f} s -> {b.path.name}")
        print(b.report.rstrip())
    print(f"  build phase {time.perf_counter() - t0:.1f} s")

    run = set(PHASES if only is None else only)

    def timed(name, fn, *args):
        """fn(*args) if phase `name` runs (else None), with its seconds."""
        if name not in run:
            return None
        t = time.perf_counter()
        out = fn(*args)
        print(f"  [phase {name}: {time.perf_counter() - t:.1f} s]")
        return out

    def parity():
        for sd in ("fp16",) + QUANT:
            phase_parity(sd)
        phase_parity("fp16", "bamboo-7b")

    max_err = timed("kernel", phase_kernel)
    q_err = timed("quant", phase_quant)
    times = timed("times", phase_times)
    g_err, g_timings = timed("gather", phase_gather) or (None, None)
    serve, q_serve = timed("serve", lambda: (
        phase_serve(), {sd: phase_serve(sd) for sd in QUANT})) \
        or (None, None)
    timed("parity", parity)
    api = timed("api", phase_api)
    fleet = timed("fleet", phase_fleet)
    archs = timed("archs", phase_archs)
    vlm_out = timed("vlm", phase_vlm)
    moe_out = timed("moe", phase_moe)
    plan_out = timed("plan", phase_plan, card)
    tp_out = timed("tp", phase_tp, card)
    tpt_out = timed("tptrain", phase_tptrain, card)
    train_out = timed("train", phase_train, card)
    fam_out = timed("families", phase_families, card)
    famtp_out = timed("famtp", phase_famtp, card)
    ex_out = timed("examples", phase_examples)
    timed("analyze", phase_analyze, built)
    if run != set(PHASES):
        print(f"chip_smoke: ran phases {sorted(run)} only; no summary")
        return 0

    print("== phase 7: summary")
    shape = "B=1 D=576 r=64 cs=64 nc_g=23 R=3 kc=1 bf16"
    t1, q1 = times[("fp16", 1)], times[("int8", 1)]
    rows = [{
        **registry.row("fused_cold_ffn"),
        "checked": True, "launches": serve["launches"] + sum(
            v["launches"] for v in fam_out["serve"].values()) + sum(
            famtp_out[f"{a} {d}"][n][0]["launches"]
            for a, _, sizes, d in FAMTP_SERVE for n in sizes),
        "max_abs_err": max([max_err] + [t["max_abs_err"]
                                         for v in archs.values()
                                         for t in v["kernels"].values()]
                           + [t["max_abs_err"] for v in plan_out.values()
                              for t in v["kernels"].values()]
                           + [t["max_abs_err"]
                              for t in train_out["kernels"].values()]
                           + [t["max_abs_err"]
                              for v in fam_out["serve"].values()
                              for t in v["kernels"].values()]
                           + [t["max_abs_err"]
                              for a, _, sizes, d in FAMTP_SERVE
                              for n in sizes if d == "bfloat16"
                              for r in famtp_out[f"{a} {d}"][n]
                              for t in r["kernel"].values()]
                           + [r["max_abs_err"] for v in plan_out.values()
                              for r in v["rows"]]),
        "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
        "library_ms": None, "graph_ms": t1["graph_ms"], "shape": shape,
        "launches_counted": "phase 4's fp16 serve, phase families' "
                            "decode steps and phase famtp's rank 0 "
                            "decode steps",
        "subkernel_us": t1["subkernel_us"],
        "by_batch": {str(b): v for (sd, b), v in times.items()
                     if sd == "fp16"},
        "decode_steps": serve["steps"], "serve_profile": serve["profile"],
        "serve_wall_ms_median": {"graph": serve["wall_ms_median"],
                                 "eager": serve["eager"]["wall_ms_median"]},
        "serve_eager_profile": serve["eager"]["profile"],
        "launches_by_path": {
            "serve (phase 4, fp16)": serve["launches"],
            "dp=2 stream (phase fleet)": fleet["dp2"]["launches"],
            "fleet gateway, graphed (phase fleet)":
                fleet["fleet"]["graph"]["launches"],
            "fleet gateway, eager (phase fleet)":
                fleet["fleet"]["eager"]["launches"],
            **{f"{a} stream (phase archs)": v["launches"]
               for a, v in archs.items()},
            "vlm decode (phase vlm)": vlm_out["launches"],
            **{f"{a} stream, {sd} {m} (phase moe)": r["launches"]
               for a, v in moe_out.items()
               for sd, runs in v["serve"].items()
               for m, r in runs.items()},
            **{f"{a} stream, calibrated plan, {m} (phase plan)":
               r["launches"]
               for a, v in plan_out.items()
               for m, r in v["serve"].items()},
            **{f"{k} stream, tp={n}, per rank (phase tp)": r["launches"]
               for k, v in tp_out.items() if k.startswith(("smollm",
                                                           "bamboo"))
               for n, r in v.items()},
            "train steps (phase train)":
                train_out["launches_train_step"]["fused_cold_ffn"],
            "dp=2 x tp=2 train steps, per rank (phase tptrain)":
                tpt_out["train"]["launches"],
            **{f"grok-1-314b {k} stream, tp=4, per rank (phase tptrain)":
               tpt_out[k]["launches"] for k, *_ in GROK},
            **{f"trained {train_out['arch']} stream, {m} (phase train)":
               r["launches"] for m, r in train_out["serve"].items()},
            **{f"{a} decode, {FAMILY_STEPS} steps at B "
               f"{'/'.join(map(str, FAMILY_BATCHES))} (phase families)":
               v["launches"] for a, v in fam_out["serve"].items()},
            **{f"{a} {d} decode, {FAMILY_STEPS} steps, tp={n}, per rank "
               f"(phase famtp)": [r["launches"]
                                  for r in famtp_out[f"{a} {d}"][n]]
               for a, _, sizes, d in FAMTP_SERVE for n in sizes},
            **{f"mamba2-130m {d} decode, tp={n}, per rank (phase famtp)":
               [r["launches"] for r in famtp_out[f"mamba2 {d}"][n]]
               for d in ("float32", "bfloat16") for n in FAMTP_MAMBA_TPS},
            "mamba2-130m dp=2 x tp=2 train steps, per rank (phase famtp)":
                [r["launches"] for r in famtp_out["train"]["steps"]]},
        "by_model": {a: {"layers": v["layers"],
                         "launches_per_step": v["launches"] // v["steps"],
                         "by_batch": {str(b): t
                                      for b, t in v["kernels"].items()}}
                     for a, v in archs.items()},
        "by_family": {a: {"layers": v["layers"],
                          "launches_per_step": v["launches_per_step"],
                          "by_batch": {str(b): t
                                       for b, t in v["kernels"].items()}}
                      for a, v in fam_out["serve"].items()},
        "by_family_rank": {f"{a} tp={n}": [r["kernel"] for r in
                                           famtp_out[f"{a} {d}"][n]]
                           for a, _, sizes, d in FAMTP_SERVE for n in sizes
                           if d == "bfloat16"},
        "fleet": fleet, "moe": moe_out, "plan": plan_out, "tp": tp_out,
        "tptrain": tpt_out, "train": train_out, "families": fam_out,
        "famtp": famtp_out, "examples": ex_out}, {
        **registry.row("fused_cold_ffn (quant mode)"),
        "checked": True,
        "launches": sum(v["launches"] for v in q_serve.values()),
        "max_abs_err": q_err, "ms": q1["ms"], "plain_ms": q1["plain_ms"],
        "bound_ms": q1["bound_ms"], "bound_by": q1["bound_by"],
        "library_ms": None, "graph_ms": q1["graph_ms"],
        "shape": shape + " int8",
        "subkernel_us": q1["subkernel_us"],
        "by_dtype_batch": {f"{sd} B={b}": v
                           for (sd, b), v in times.items() if sd != "fp16"},
        "launches_by_dtype": {sd: v["launches"] for sd, v in q_serve.items()},
        "decode_steps": {sd: v["steps"] for sd, v in q_serve.items()},
        "serve_profile": {sd: v["profile"] for sd, v in q_serve.items()},
        "serve_wall_ms_median": {sd: {"graph": v["wall_ms_median"],
                                      "eager": v["eager"]["wall_ms_median"]}
                                 for sd, v in q_serve.items()},
        "serve_eager_profile": {sd: v["eager"]["profile"]
                                for sd, v in q_serve.items()}}]
    for fixed, shape_g in (
            (registry.row("cluster_gather_ffn"),
             "B=1 D=576 N=1536 R=3 cs=64 12 of 24 clusters bf16"),
            (registry.row("dense_ffn"), "B=1 D=576 N=1536 R=3 bf16")):
        name = fixed["name"]
        g1 = g_timings[1][name]
        rows.append({
            **fixed, "checked": True, "launches": api[name],
            "launches_on": "the kernel API at full width (phase 6); the "
                           "serving path launches it 0 times",
            "launches_train_step": train_out["launches_train_step"][name],
            "max_abs_err": g_err, "ms": g1["ms"],
            "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
            "bound_by": g1["bound_by"], "library_ms": None,
            "graph_ms": g1["graph_ms"],
            "composition_ms": g1["composition_ms"],
            "composition_graph_ms": g1["composition_graph_ms"],
            "kernel_us": g1["kernel_us"], "l2_cold": True, "shape": shape_g,
            "by_batch": {str(b): v[name] for b, v in g_timings.items()}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

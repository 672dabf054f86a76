#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and hold each of its
kernels against its plain version.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, in order; any failure raises and the script exits nonzero without
its last line:

  1. device: the card's name and power limit;
  2. build: the port's four CUDA kernels from the checkout's sources
     (build/), one nvcc each, all started together; ptxas's register and
     spill lines; the libraries of the three GEMM kernels (fused_decode,
     protected_mm, qmatmul) must show no spill, and their SASS (cuobjdump)
     int8 tensor-core instructions (IMMA) and cp.async copies (LDGSTS);
     fault_inject's SASS must show 16-byte global loads (LDG.E.128);
  3. kernels: fused_decode against its plain version, bitwise, in every mode
     at the main path's shapes and at shapes that cross the split-K and
     16-byte-copy boundaries (M 1/16/17, K 31/200/2561, N 130/648), and with
     operands 1 byte off 16-byte alignment, on random operands and on
     operands that drive the epilogue's clamps (24-bit saturation, t's upper
     clamp of 16, q_scale above the natural t); timed beside its bound, the
     plain version and one PyTorch call (torch._int_mm on the same int8
     operands);
  4. dla kernels: qmatmul, protected_mm and fault_inject against their plain
     versions, bitwise, at the main path's shapes, at the same boundary
     shapes and misaligned operands, and at two ragged ones, on random and
     saturating operands, t 0/1/16, BER 0/1e-2/1.0, protection counts 0 to
     8 (fault_inject also -1 and 9, mixed within groups of 4 columns, and
     x, planes and protect 1 word off 16-byte alignment), a mixed
     important mask; timed like fused_decode (no PyTorch call computes
     fault_inject's function); then a floor line: fault_inject's time per
     launch at 1 x 4, a launch's fixed cost on the card;
  5. entry points: quant_linear and inject, the kernel-level entry points of
     qmatmul and fault_inject, at the decode shapes, equal to the CPU;
  6. engine: full-width h2o-danube-1.8b at 12 of its 24 layers
     (SERVE_LAYERS; random bf16 weights from a seed), B=4, prompt 64, 16 new tokens under crt3 at BER 1e-4, fused backend,
     Engine(loop="python") (pinned: its counts and events are per Python
     call of the kernel, which a graph replay does not make): fused tokens
     equal reference tokens, the kernel ran once per projection of every
     step, and its device time over that generation (CUDA events around
     each launch) is the kernels line's ``ms``;
  6b. scan: the same generation through Engine(loop="scan"), each decode
     step a replay of one captured CUDA graph: tokens equal phase 6's
     bitwise, in 2 round trips; capture s, a second generation's decode
     tokens/s (its own prefill, timed inside it, off its wall time), a
     replay's wall ms and CUDA-event ms, peak memory, the
     graph's memory, and a profiled replay (busy share; the kernel once
     per projection);
  7. pallas engine: the same widths at 4 of the 24 layers (PALLAS_LAYERS;
     its eager loop is host-bound), through
     Engine(ft_backend="pallas", ft_t=T, loop="python") with T calibrated
     on layer 0's first projection: protected_mm launched once per
     projection of every step, its device time, and a second generation in
     which every launch is held bitwise to protected_mm_ref, with the same
     tokens;
  7b. scan on the pallas backend, as 6b (at phase 7's depth), against
     phase 7's tokens;
  8. scheduler: the same widths at 6 of the 24 layers (SCHED_LAYERS)
     through the continuous-batching Scheduler (4 slots, buckets 32/64,
     paged KV cache of 16-token
     blocks, 4 decode steps per round trip; loop="python", pinned as in 6)
     serving 8 requests of 9-64 prompt and 4-16 new tokens under crt3 at
     BER 1e-4 on the fused backend: fused_decode at prefill (B = 1, global
     t) and at decode (per-request keys, per-row t), launched 7 x 6 times
     per prefill call and per decode step, its device time by prefill and
     decode; every request's tokens equal the reference backend's; one
     request alone gives the tokens it gave in the crowd; the kernel phase
     also checks and times the scheduler's shapes (M = 32 and 64 global,
     M = 4 per-row);
  8b. graph scheduler: the same requests on Scheduler(loop="scan"), each
     decode step of a chunk a replay of one captured CUDA graph: every
     request's tokens equal phase 8's bitwise, and the lone request's on a
     second run of the same Scheduler; capture s, chunk-call and
     prefill-call s, tokens/s, replay ms, peak memory, a profiled replay;
  8c. families: the MoE, Mamba2-SSD, RG-LRU, encoder-decoder and
     vision-frontend families at their published widths (phase_family's
     docstring; FAMILIES: mamba2-2.7b at 16 of its 64, recurrentgemma-9b
     at 5 of its 38, qwen3-moe-235b-a22b at 4 of its 94 with all 128
     experts, seamless-m4t-medium at 6 + 6 of its 12 + 12, paligemma-3b
     at 6 of its 18; the train phase runs the last two whole), random
     bf16 weights from a seed, B = 4, a 64-token prompt
     (seamless: 96 encoder frames; paligemma: 256 patch rows in front), 8
     new tokens, crt3 at BER 1e-4: the scan's graph tokens equal the
     reference backend's and the eager loop's, whose every fused_decode
     launch is held bitwise to fused_ref; the kernel once per protected
     projection of every step (and each cross-attention xk / xv once per
     prefill; the full-width encoder, as the reference's scanned one,
     launches none); a Scheduler run per family (4 slots, 6 requests of
     8-48 prompt tokens; exact-length, but paligemma's bucketed at 32/64),
     fused equal to reference; parameter counts, prefill ms, scan decode
     tokens/s, a replay's ms and busy share, peak memory (the kernel phase
     also checks and times every (M, K, N) these models launch);
  8d. mesh: the parallel layer on a one-rank NCCL (1, 1) mesh
     (phase_mesh's docstring): Engine, Scheduler, the MoE's expert
     parallelism and a clean and a FAT train step, each equal to its
     meshless run, and the training launcher under torch.distributed.run;
  8e. dryrun: the production-mesh dry run (repro_torch.launch.dryrun, on a
     fake 256-rank process group and fake tensors, started in the
     background after 8d, the last of the host-bound timed phases before
     it) of danube's train_4k and decode_32k cells on (16, 16): each
     cell's peak and persistent GB, fits, collective GB by op, TFLOP and
     trace s; the dry runs of 8d's two clean train steps (S = 64, one
     attention block; S = 2048, the blocked attention) on a fake (1, 1)
     group against the real steps: the step's own peak live bytes (its
     peak less its inputs) within DRYRUN["live_rtol"], the same
     collectives, the card-memory constant equal to total_memory; then
     examples/torch_quickstart.py and torch_fault_tolerant_serving.py on
     the card, each to exit 0;
  9. faults: protect_linear fused equals reference on the card, for all 7
     policies with weight faults, per-row keys and an important mask, and
     equals the CPU; pallas equals the CPU for all 7 policies; the reduced
     engine on both backends equals the CPU's; the reduced Scheduler on the
     card, paged and dense, emits the CPU's tokens clean and at temperature
     0.8; under crt1 at BER 1e-2 with per-row weight faults every protected
     projection of its fused run equals the CPU's on the same operands, and
     its reference backend and dense layout give the fused run's tokens
     (the engines and the unchecked Schedulers here run their default
     loop="scan": CUDA graphs on the card, eager on the CPU);
  9a. dse: the paper's cross-layer DSE (Algorithms 1-3) on the card: the
     reduced VGG trained by trained_cnn("vgg", steps=250), CnnOracle at
     its defaults (384 images, 3 fault draws), every protected conv and
     the head one fused_decode launch (the kernel phase also checks and
     times these 5 conv shapes, M up to 98,304, K 9-512, N 8-32, global t,
     with and without the DPPU's clean-weight recompute); every launch of
     three accuracies held bitwise to fused_ref, fused = reference
     accuracies, Figs. 5-7, the DSE of examples/crosslayer_dse.py with its
     launches counted, and a card-against-CPU line (phase_dse's
     docstring);
  9b. train: training on the card (phase_train's docstring): full-width
     h2o-danube-1.8b (bf16 parameters, float32 AdamW moments) at B = 4,
     S = 64 through the Trainer, 2 clean steps, then 4 fault-aware steps
     (crt3 at BER 1e-4, fused backend: fused_decode at M = 256 in the
     forward and again in the backward's recompute), async checkpoints,
     a resume from step 4 bitwise equal to the uninterrupted run, one step
     with every fused_decode launch held bitwise to fused_ref, a profiled
     step, the STE at one full-width site against the clean matmul's
     gradients; then the CNN trained through cl faults
     (trained_cnn_fat("vgg", 250, fat_ber=2e-3): fused_decode at the
     batch-64 conv shapes, which the kernel phase also checks and times)
     and FatCnnOracle over fat_ber 0 and 2e-3; then the families
     (train_families' docstring): mamba2-2.7b (16 of its 64 layers),
     recurrentgemma-9b (5 of 38), qwen3-moe-235b-a22b (1 of 94, its
     grad_accum of 4 and bf16 moments), seamless-m4t-medium (12 + 12) and
     paligemma-3b (18, S = 320) at their published widths, B = 4, S = 64,
     batches from make_batch on the card (bf16 frames and patch rows):
     one clean step, one FAT step (crt3 at BER 1e-4) with fused_decode's
     launches counted against 2 x the protected projections x the
     microbatches and timed, one with every launch held bitwise to
     fused_ref, one profiled; and a seamless Trainer at 1 + 1 layers
     resumed from its middle checkpoint, bitwise (the kernel phase also
     checks and times the families' train shapes, M = 64, 256, 1280);
  9c. split: the same faulty reduced Scheduler, eager, on the card and on
     the CPU: the first protected projection whose int8 input differs
     between them, with the last-place differences of its input and of
     the rms_norm input before it, and x / scale on each device;
 10. a ``kernels`` JSON line (per kernel: its launches and device time on
     its path, and the kernel phase's sums of kernel, bound, plain and
     ``_int_mm`` times, with ``bound_share`` = bound / kernel time;
     fused_decode's also the same for its scheduler run, its DSE run, its
     two training runs, the families phase's generations and the families'
     FAT steps),
     then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core peak, same source
B, PROMPT, NEW = 4, 64, 16
# the scheduler phase: 8 requests through 4 slots over a paged KV cache
SCHED = dict(max_batch=4, buckets=(32, 64), max_new_tokens=16,
             decode_chunk=4, kv="paged", block_size=16)
N_REQUESTS = 8
# (K, N) of the seven projections of one danube layer: wq wk wv wo wi wg wo
LAYER_KN = ((2560, 2560), (2560, 640), (2560, 640), (2560, 2560),
            (2560, 6912), (2560, 6912), (6912, 2560))
POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
MODES = ([(pr, d, False) for pr in (False, True)
          for d in ("none", "reuse", "w", "wcl")]
         + [(pr, d, True) for pr in (False, True) for d in ("none", "w", "wcl")])
KERNELS = ("fused_decode", "qmatmul", "protected_mm", "fault_inject")
# protected_mm's checks: (t, ber, ib, nb), t at 0/1/16, BER 0/1e-2/1.0, the
# protection counts at 0 and 8 and between
PM_EDGES = ((0, 0.0, 2, 1), (1, 1e-2, 0, 0), (16, 1e-2, 8, 8),
            (3, 1.0, 8, 0), (16, 1.0, 0, 8), (5, 1e-2, 2, 1))
# the main path's mode (crt3 at BER 1e-4, no important mask), timed
MAIN_PM = dict(t=12, ber=1e-4, ib=3, nb=3)
# shapes that cross the GEMM core's boundaries: M at and past the decode
# tile (16), K under one 64-step, ragged, and split with a ragged last
# chunk, N ragged against 64- and 128-column tiles and against 16-byte rows
EDGE_SHAPES = tuple((m, k, n) for m in (1, 16, 17) for k in (31, 200, 2561)
                    for n in (130, 648))
# (M, K, N) at which xq and wq also run 1 byte off 16-byte alignment
MISALIGNED_SHAPES = ((4, 2560, 640), (256, 2560, 640), (17, 2561, 648))
# the serving phases (6-8b) run full width at this many of danube's 24
# layers, and the pallas path (phases 7 and 7b) at PALLAS_LAYERS: their
# eager loops are host-bound, and on an H100 host whose eager phases ran
# 34% slower than on others the script took 1167.4 s of its 1200-s limit
# with the serving phases at all 24 layers (and 1096.9 s with the pallas
# path at 24)
SERVE_LAYERS = 12
PALLAS_LAYERS = 4
# the scheduler phases (8, 8b) at 6 of the 24 layers: their B = 1 eager
# prefills and eager chunks are host-bound (103 s at 12 layers), and the
# train phase's families part took their time
SCHED_LAYERS = 6
# the kernels on the split-K tensor-core GEMM core
CORE_KERNELS = ("fused_decode", "protected_mm", "qmatmul")
# the dse phase: the reference's benchmark settings (CNNConfig(), trained
# 250 steps; CnnOracle's 384 images, 3 fault draws; the DSE of
# examples/crosslayer_dse.py at --iters 16 --batch 8)
DSE = dict(train_steps=250, ber=1e-3, iter_max_step=16, batch_size=8,
           check_ber=2e-3)
# the train phase: full-width danube at B = 4, S = 64 (the serving
# prompt's size), 2 clean steps, then FAT steps under crt3 at BER 1e-4
# without weight faults (as the serving phases; at full width their eager
# draws take minutes per step), the ramp over the clean steps; the Trainer
# with async checkpoints every 2 steps at 2 of the 24 layers (the script
# writes at most 45 GiB to disk in a run; a full-depth checkpoint is
# 17.5 GB);
# the CNN trained through cl faults at 2e-3
TRAIN = dict(seq=64, batch=4, clean_steps=2, fat_steps=2, policy="crt3",
             ber=1e-4, fat_ramp=2, fat_seed=17, trainer_layers=2,
             trainer_fat_steps=4, ckpt_every=2, cnn_steps=250,
             cnn_fat_ber=2e-3, cnn_batch=64, ste_rtol=1e-6)
# the train phase's families part: each family at its published widths
# (random bf16 weights from a seed, its RUN's Adam dtype and grad_accum) at
# these depths (None: all), chosen for the card's 80 GB at ~13.5 bytes per
# parameter of a FAT step's peak (danube: 24.3 GB for 1.8e9): mamba2-2.7b
# 16 of 64 (0.77e9 parameters), recurrentgemma-9b 5 of 38 (one R,R,L
# period and the R,R tail, ~2.0e9: 14 layers would reach ~52 GB),
# qwen3-moe-235b-a22b 1 of 94 (all 128 experts, bf16 moments, ~3.1e9),
# seamless-m4t-medium 12 + 12, paligemma-3b 18; B = 4, S = 64 (paligemma
# 320: its 256 patch rows come out of S); one clean step, one FAT step
# (crt3 at BER 1e-4 without weight faults, from the first step on) with
# its launches counted and timed, one with every launch held bitwise to
# fused_ref, one profiled; then the Trainer of seamless at 1 + 1 layers
# (a checkpoint of ~2.7 GB; the run writes 4)
TRAIN_FAMILIES = {"mamba2-2.7b": 16, "recurrentgemma-9b": 5,
                  "qwen3-moe-235b-a22b": 1, "seamless-m4t-medium": None,
                  "paligemma-3b": None}
TRAIN_FAM = dict(batch=4, seq=64, seq_vision=320, policy="crt3", ber=1e-4,
                 fat_seed=17, trainer_arch="seamless-m4t-medium",
                 trainer_layers=1, trainer_fat_steps=4, ckpt_every=2)
# the families phase: each architecture at its published widths, at this
# many layers (None: all): mamba2-2.7b at 16 of its 64 (all 64 took ~50 s
# more of the script's time limit), recurrentgemma-9b at 5 of its 38 (one
# R,R,L period and the R,R tail; 14 took ~40 s more), qwen3-moe-235b-a22b
# at 4 of its 94 (its ~470 GB cannot fit one card; all 128 experts,
# top-8), seamless-m4t-medium at 6 + 6 of its 12 + 12 and paligemma-3b at
# 6 of its 18 (whole, they took ~40 s and ~80 s more; the train phase
# runs both whole); B = 4, a 64-token prompt, 8 new tokens, crt3 at BER
# 1e-4 without weight faults; then 6 requests of 8-48 prompt tokens
# through a Scheduler
FAMILIES = {"mamba2-2.7b": 16, "recurrentgemma-9b": 5,
            "qwen3-moe-235b-a22b": 4, "seamless-m4t-medium": 6,
            "paligemma-3b": 6}
FAM = dict(batch=4, prompt=64, new=8, policy="crt3", ber=1e-4)
FAM_SCHED = dict(max_batch=4, buckets=None, max_prompt=48,
                 max_new_tokens=8, decode_chunk=4, kv="paged", block_size=16)
FAM_PROMPTS = (8, 16, 24, 32, 40, 48)
# seamless's encoder input: 96 frames against the engine's 64-token prompt
# (equal lengths would hide a swap of the two), and 16-48 frames per
# Scheduler request, none its prompt's length and no two alike (so the
# per-slot valid lengths cn differ); paligemma's Scheduler runs bucketed,
# its 256 patch rows in front of right-padded prompts
FAM_FRAMES = 96
FAM_SCHED_FRAMES = (40, 48, 16, 24, 32, 20)
FAM_SCHED_BUCKETS = {"paligemma-3b": (32, 64)}
# the mesh phase: the parallel layer on a one-rank NCCL mesh (data, model)
# = (1, 1): full-width danube at all 24 layers through Engine(mesh=) (the
# scan, and a python loop of 2 new tokens whose every fused_decode launch
# is counted and held to fused_ref), the Scheduler at SCHED_LAYERS, qwen3-
# moe at its FAMILIES depth through the expert-parallel branch, one clean
# and one FAT train step at full width and 8 of the 24 layers, and the
# training launcher under torch.distributed.run
MESH = dict(layers=24, checked_new=2, train_layers=8, moe_arch=
            "qwen3-moe-235b-a22b", torchrun_timeout=300,
            replay_order=("meshless", "mesh", "mesh", "meshless",
                          "meshless", "mesh"))
# the dryrun phase: repro_torch.launch.dryrun's CLI on danube's train_4k
# and decode_32k cells of the (16, 16) production mesh (a fake 256-rank
# process group, fake tensors), started in the background after the mesh
# phase; the card checks dry-run the mesh phase's clean train steps on a
# fake (1, 1) group: "short" (danube at MESH["train_layers"], B =
# TRAIN["batch"], S = TRAIN["seq"]: one attention block) and "blocked"
# (danube at 2 layers, B = 2, S = 2048: chunked_attention's blocked path,
# 4 x 4 blocks of 512, whose saved float32 block scores dominate the
# train_4k cells' peaks), each holding the step's own live bytes (peak
# less inputs) within DRYRUN["live_rtol"] of the real step's; the examples
# line runs two of examples/torch_*.py on the card
DRYRUN = dict(arch="h2o-danube-1.8b", shapes=("train_4k", "decode_32k"),
              checks=dict(short=dict(layers=MESH["train_layers"],
                                     batch=TRAIN["batch"], seq=TRAIN["seq"]),
                          blocked=dict(layers=2, batch=2, seq=2048)),
              live_rtol=0.03, timeout=600,
              examples=("torch_quickstart.py",
                        "torch_fault_tolerant_serving.py"))
# published parameter counts (tests/test_models_smoke.py; the backbones)
PUBLISHED_PARAMS = {"paligemma-3b": 2.5e9, "seamless-m4t-medium": 0.7e9}
def conv_shapes(n_eval=384):
    """[(site, (M, K, N))] of the protected GEMMs of one CnnOracle forward
    of CNNConfig() (vgg, channels 16/32, 16x16, 8 classes) over ``n_eval``
    images: each 3x3 conv an im2col GEMM, then the head."""
    from repro_torch.models.cnn import CNNConfig
    cfg = CNNConfig()
    hw, cin, out = cfg.hw, cfg.in_channels, []
    for si, c in enumerate(cfg.channels):
        out.append((f"s{si}_c0", (n_eval * hw * hw, 9 * cin, c)))
        out.append((f"s{si}_c1", (n_eval * hw * hw, 9 * c, c)))
        hw, cin = hw // 2, c
    out.append(("head", (n_eval, hw * hw * cin, cfg.n_classes)))
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters):
    """Mean device time of ``fn`` in ms over ``iters`` launches, after a
    warm-up, from CUDA events around each launch.  The launches queue up
    behind a ~50-ms device sleep, so the events time the device's work back
    to back and not the host's launch calls (which take longer than a small
    kernel).  The operands stay in L2 between launches, as on the main path,
    where ``quantize`` writes the int8 weights (at most 17.7 MB of the 50 MB
    L2) just before the kernel reads them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)      # ~50 ms at 1.98 GHz
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def roofline(nbytes, ops):
    """Least time (ms) for ``nbytes`` over HBM or ``ops`` int8 operations at
    the int8 peak, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound(M, K, N, mode):
    """Least time (ms) for one call: each input read once and each output
    written once over HBM, or 2*M*K*N int8 operations (twice with a second
    accumulator) at the int8 peak; and which of the two bounds it."""
    per_row, dppu, perrow_wf = mode
    nbytes = M * K + K * N + 4 * M * N + 4 + M * N + 4 * M
    ops = 2 * M * K * N
    if dppu != "none":
        nbytes += 4 * M * N + 4 * N
    if dppu in ("w", "wcl"):
        ops *= 2
    if dppu == "wcl":
        nbytes += K * N
    if perrow_wf:
        nbytes += 4 * M * K * N
    return roofline(nbytes, ops)


def launches_per_generation():
    """{(M, K, N): launches of one protected projection kernel in one
    generation}: one per projection of the prefill (M = B x prompt) and of
    each decode step (M = B)."""
    per_gen = {}
    for kn in LAYER_KN:
        per_gen[(PROMPT * B,) + kn] = (per_gen.get((PROMPT * B,) + kn, 0)
                                       + SERVE_LAYERS)
        per_gen[(B,) + kn] = (per_gen.get((B,) + kn, 0)
                              + SERVE_LAYERS * NEW)
    return per_gen


def scheduler_shapes():
    """The (M, K, N) of the scheduler phase's fused_decode launches, with
    their mode: prefill at M = each bucket (B = 1, global t), decode at
    M = max_batch (per-row t)."""
    kns = sorted(set(LAYER_KN))
    return ([((b, k, n), False) for b in SCHED["buckets"] for k, n in kns]
            + [((SCHED["max_batch"], k, n), True) for k, n in kns])


def family_config(arch):
    """The families phase's config of ``arch``: published widths, at
    ``FAMILIES[arch]`` layers where set (and as many encoder layers as
    decoder layers)."""
    return _cut_config(arch, FAMILIES[arch])


def _cut_config(arch, n):
    """``arch`` at its published widths, at ``n`` layers (None: all) and
    at most as many encoder layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if n is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=n, n_enc_layers=min(cfg.n_enc_layers, n))
    return cfg


def family_kn(cfg):
    """(K, N) of each protected projection of one decode step, in call
    order: attention wq wk wv wo; an encoder-decoder's cross-attention wq
    wo; RG-LRU w_gate w_x w_out; SSD in_proj out_proj; then the MoE router
    or the MLP's wi (wg) wo.  A prefill runs them all too, and
    ``family_cross_kn``'s."""
    from repro_torch.models.ssm import dims
    from repro_torch.models.transformer import layer_kinds
    D, out = cfg.d_model, []
    for kind in layer_kinds(cfg):
        if kind in ("G", "L"):
            q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
            out += [(D, q), (D, kv), (D, kv), (q, D)]
            if cfg.enc_dec:
                out += [(D, q), (q, D)]
        elif kind == "R":
            W = cfg.rglru_width
            out += [(D, W), (D, W), (W, D)]
        elif kind == "S":
            d_inner, H = dims(cfg)
            out += [(D, 2 * d_inner + 2 * cfg.ssm.d_state + H), (d_inner, D)]
        if cfg.moe is not None:
            out.append((D, cfg.moe.n_experts))
        elif cfg.d_ff:
            F = cfg.d_ff
            out += [(D, F)] * (2 if cfg.glu else 1) + [(F, D)]
    return out


def family_cross_kn(cfg):
    """(K, N) of the projections only a prefill runs: each decoder layer's
    cross-attention keys and values (xk, xv) of an encoder-decoder, at M =
    B x the encoder's length.  The full-width encoder launches none: the
    reference's scanned encoder runs without a fault context."""
    if not cfg.enc_dec:
        return []
    return [(cfg.d_model, cfg.n_kv_heads * cfg.d_head)] * (2 * cfg.n_layers)


def family_train_config(arch):
    """The train phase's config of ``arch``: published widths at
    ``TRAIN_FAMILIES[arch]`` layers where set (and as many encoder layers
    as decoder layers)."""
    return _cut_config(arch, TRAIN_FAMILIES[arch])


def family_train_seq(cfg):
    return TRAIN_FAM["seq_vision"] if cfg.frontend == "vision" \
        else TRAIN_FAM["seq"]


def family_train_launches(arch):
    """{(M, K, N): fused_decode launches of one FAT step of ``arch``}: every
    protected projection (``family_kn`` and an encoder-decoder's xk / xv
    over its S frames; the full-width encoder is scanned and clean) once in
    the forward and once in the backward's recompute, per microbatch of
    B x S / grad_accum rows."""
    from repro_torch.configs import get_run_config
    cfg = family_train_config(arch)
    accum = get_run_config(arch).grad_accum
    M = TRAIN_FAM["batch"] * family_train_seq(cfg) // accum
    out = collections.Counter()
    for kn in family_kn(cfg) + family_cross_kn(cfg):
        out[(M,) + kn] += 2 * accum
    return out


def family_prefill_len(cfg):
    """Decoder positions of a families-phase prefill: the prompt, behind
    the vision family's patch rows."""
    return FAM["prompt"] + (cfg.n_frontend_tokens
                            if cfg.frontend == "vision" else 0)


def family_launches():
    """{(M, K, N): fused_decode launches of one families-phase generation}
    over the families: each projection once at prefill (M = B x the
    prefill's positions) and once per decode step (M = B); each xk / xv
    once at prefill (M = B x FAM_FRAMES)."""
    per_gen = collections.Counter()
    for arch in FAMILIES:
        cfg = family_config(arch)
        for kn in family_kn(cfg):
            per_gen[(FAM["batch"] * family_prefill_len(cfg),) + kn] += 1
            per_gen[(FAM["batch"],) + kn] += FAM["new"]
        for kn in family_cross_kn(cfg):
            per_gen[(FAM["batch"] * FAM_FRAMES,) + kn] += 1
    return per_gen


def unprotected_planes(M, prot):
    """Plane words a flip epilogue must read: per output, its unprotected
    bits (``8 - prot`` of its channel, clamped to 0..8)."""
    return M * int((8 - prot.clamp(0, 8)).sum())


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)
    return name, smi


def _kernel_module(name):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}.kernel")


def phase_build():
    """One nvcc per kernel, all started together."""
    def build(name):
        t0 = time.perf_counter()
        path, report = _kernel_module(name).build()
        return name, path, report, time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    for name, path, report, secs in built:
        spills = 0
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas [{name}]:", line.strip())
            if "spill" in line and "0 bytes spill stores, 0 bytes spill " \
                    "loads" not in line:
                spills += 1
        row = {"phase": "build", "kernel": name, "library":
               str(path.relative_to(ROOT)), "build_s": round(secs, 3)}
        if name in CORE_KERNELS:
            row.update(sass_counts(path), spilling_kernels=spills)
            if spills or not row["IMMA"] or not row["LDGSTS"]:
                raise AssertionError(f"{name}: {row}: the GEMM core must "
                                     "issue IMMA and LDGSTS and not spill")
        if name == "fault_inject":
            row.update(sass_counts(path))
            if not row["LDG.E.128"]:
                raise AssertionError(f"{name}: {row}: the streaming kernel "
                                     "must issue 16-byte loads")
        emit(row)
    emit({"phase": "build", "all_s": round(time.perf_counter() - t0, 3)})


def sass_counts(path):
    """IMMA (int8 mma), LDGSTS (cp.async) and 16-byte global load
    (LDG.E.128, with any cache qualifier before the width) instructions in
    a library's SASS, by cuobjdump."""
    from repro_torch.kernels.build import nvcc
    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {"IMMA": sass.count("IMMA"), "LDGSTS": sass.count("LDGSTS"),
            "LDG.E.128": len(re.findall(r"LDG\.E(?:\.[A-Z0-9_]+)*\.128",
                                        sass))}


def _operands(torch, g, dev, M, K, N):
    def words(*shape):
        w = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.int32)
        keep = torch.rand(shape, generator=g, device=dev) < 0.05
        return torch.where(keep, w, torch.zeros_like(w))

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    return dict(xq=i8(M, K), wq=i8(K, N), wq_clean=i8(K, N),
                oflips=words(M, N), dflips=words(M, N),
                imp=(torch.rand(N, generator=g, device=dev) < 0.05)
                .to(torch.int32),
                wflips=None)


def _edges(ops):
    """Rows of 127 and -128 against columns of 127 and -128 reach |acc| =
    127*128*K > 2**23 (the 24-bit saturation, and t's upper clamp of 16);
    a zero row and a row of -1/0/1 have a natural t below q_scale."""
    xq, wq = ops["xq"], ops["wq"]
    for r, v in zip(range(xq.shape[0]), (127, -128, 0)):
        xq[r] = v
    if xq.shape[0] > 3:
        xq[3] = xq[3] % 3 - 1
    wq[:, 0], wq[:, 1], wq[:, 2] = 127, -128, 0
    return ops


def _misaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts 1 byte off a 16-byte
    boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape)
    out.copy_(t)
    return out


def _check_modes(torch, g, ops, q_scales):
    """fused_decode against ref.fused_ref, bitwise, in every mode at each
    q_scale; returns the largest difference (0, or it raised)."""
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode.ref import fused_ref
    dev = ops["xq"].device
    (M, K), N = ops["xq"].shape, ops["wq"].shape[1]
    max_err = 0
    for mode in MODES:
        per_row, dppu, perrow_wf = mode
        if perrow_wf and M != B:
            continue
        kw = {}
        if dppu != "none":
            kw.update(dflips=ops["dflips"], imp=ops["imp"])
        if dppu == "wcl":
            kw["wq_clean"] = ops["wq_clean"]
        if perrow_wf:
            w = torch.randint(0, 256, (M, K, N), generator=g, device=dev,
                              dtype=torch.int32)
            kw["wflips"] = torch.where(
                torch.rand((M, K, N), generator=g, device=dev) < 0.01, w,
                torch.zeros_like(w))
        for q in q_scales:
            qs = torch.tensor([q], dtype=torch.int32, device=dev)
            args = (ops["xq"], ops["wq"], ops["oflips"], qs)
            y, t = kernel.fused_decode(*args, per_row=per_row, dppu_src=dppu,
                                       perrow_wf=perrow_wf, **kw)
            yr, tr = fused_ref(*args[:3], qs.reshape(()), per_row=per_row,
                               **kw)
            torch.cuda.synchronize()
            err = max(int((y.to(torch.int32) - yr).abs().max()),
                      int((t.reshape(-1) - torch.broadcast_to(
                          tr.reshape(-1, 1), (M, 1)).reshape(-1))
                          .abs().max()))
            if err:
                raise AssertionError(
                    "fused_decode differs from its plain version at "
                    f"{(M, K, N)} {mode} q_scale={q}: {err}")
            max_err = max(max_err, err)
    return max_err


def phase_kernels(torch):
    """fused_decode against ref.fused_ref, bitwise, every mode, main-path
    shapes, random and clamp-driving operands; per-launch timings of the
    main path's mode (global t, no DPPU)."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode.ref import fused_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    max_err, rows = 0, []
    for M, K, N in EDGE_SHAPES + MISALIGNED_SHAPES:
        for edges in (False, True):
            ops = _operands(torch, g, dev, M, K, N)
            if (M, K, N) in MISALIGNED_SHAPES:
                ops["xq"], ops["wq"] = (_misaligned(torch, ops[k])
                                        for k in ("xq", "wq"))
            max_err = max(max_err, _check_modes(
                torch, g, _edges(ops) if edges else ops,
                (0, 12, 20) if edges else (3,)))
    emit({"phase": "kernel", "kernel": "fused_decode",
          "boundary_shapes": [list(s) for s in EDGE_SHAPES],
          "misaligned_shapes": [list(s) for s in MISALIGNED_SHAPES],
          "max_abs_err": max_err})
    for (M, K, N), count in launches_per_generation().items():
        ops = _operands(torch, g, dev, M, K, N)
        max_err = max(max_err, _check_modes(torch, g, ops, (3,)))
        qs = torch.tensor([3], dtype=torch.int32, device=dev)
        args = (ops["xq"], ops["wq"], ops["oflips"], qs)
        Mp = max(M, 24)                  # torch._int_mm takes M > 16
        xpad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
        xpad[:M] = ops["xq"]
        call = functools.partial(kernel.fused_decode, *args)
        plain = functools.partial(fused_ref, *args[:3], qs.reshape(()))
        lib = functools.partial(torch._int_mm, xpad, ops["wq"])
        b_ms, b_by = bound(M, K, N, (False, "none", False))
        row = dict(shape=[M, K, N], mode="global t, no DPPU",
                   launches_per_generation=count,
                   plan=list(kernel.gemm_plan(M, K, N, sm_count(dev))),
                   kernel_ms=cuda_ms(torch, call, 20),
                   bound_ms=b_ms, bound_by=b_by,
                   plain_ms=cuda_ms(torch, plain, 5),
                   library_ms=cuda_ms(torch, lib, 20))
        row["bound_share"] = b_ms / row["kernel_ms"]
        rows.append(row)
        emit({"phase": "kernel", "kernel": "fused_decode", **row})
        max_err = max(max_err, _check_modes(torch, g, _edges(ops),
                                            (0, 12, 20)))
        del ops
    sched_rows = []
    for (M, K, N), per_row in scheduler_shapes():
        ops = _operands(torch, g, dev, M, K, N)
        max_err = max(max_err, _check_modes(torch, g, ops, (3,)),
                      _check_modes(torch, g, _edges(ops), (0, 12, 20)))
        qs = torch.tensor([3], dtype=torch.int32, device=dev)
        args = (ops["xq"], ops["wq"], ops["oflips"], qs)
        Mp = max(M, 24)
        xpad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
        xpad[:M] = ops["xq"]
        b_ms, b_by = bound(M, K, N, (per_row, "none", False))
        row = dict(shape=[M, K, N], path="scheduler",
                   mode=("per-row t" if per_row else "global t")
                   + ", no DPPU",
                   kernel_ms=cuda_ms(torch, functools.partial(
                       kernel.fused_decode, *args, per_row=per_row), 20),
                   bound_ms=b_ms, bound_by=b_by,
                   plain_ms=cuda_ms(torch, functools.partial(
                       fused_ref, *args[:3], qs.reshape(()),
                       per_row=per_row), 5),
                   library_ms=cuda_ms(torch, functools.partial(
                       torch._int_mm, xpad, ops["wq"]), 20))
        row["bound_share"] = b_ms / row["kernel_ms"]
        sched_rows.append(row)
        emit({"phase": "kernel", "kernel": "fused_decode", **row})
        del ops
    fam_rows = []
    for (M, K, N), count in sorted(family_launches().items()):
        ops = _operands(torch, g, dev, M, K, N)
        max_err = max(max_err, _check_modes(torch, g, ops, (3,)),
                      _check_modes(torch, g, _edges(ops), (0, 12, 20)))
        ops = _operands(torch, g, dev, M, K, N)
        qs = torch.tensor([3], dtype=torch.int32, device=dev)
        args = (ops["xq"], ops["wq"], ops["oflips"], qs)
        Mp = max(M, 24)                  # torch._int_mm takes M > 16
        xpad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
        xpad[:M] = ops["xq"]
        b_ms, b_by = bound(M, K, N, (False, "none", False))
        row = dict(shape=[M, K, N], path="families",
                   mode="global t, no DPPU",
                   launches_per_generation=count,
                   plan=list(kernel.gemm_plan(M, K, N, sm_count(dev))),
                   kernel_ms=cuda_ms(torch, functools.partial(
                       kernel.fused_decode, *args), 20),
                   bound_ms=b_ms, bound_by=b_by,
                   plain_ms=cuda_ms(torch, functools.partial(
                       fused_ref, *args[:3], qs.reshape(())), 5),
                   library_ms=cuda_ms(torch, functools.partial(
                       torch._int_mm, xpad, ops["wq"]), 20))
        row["bound_share"] = b_ms / row["kernel_ms"]
        fam_rows.append(row)
        emit({"phase": "kernel", "kernel": "fused_decode", **row})
        del ops
    timed = {tuple(r["shape"]): r for r in fam_rows}
    train_shapes = collections.Counter()
    for arch in TRAIN_FAMILIES:
        train_shapes.update(family_train_launches(arch))
    for (M, K, N), count in sorted(train_shapes.items()):
        if (M, K, N) in timed:          # a families-phase prefill shape
            row = dict(timed[(M, K, N)], path="train families",
                       launches_per_fat_step=count)
            row.pop("launches_per_generation")
        else:
            ops = _operands(torch, g, dev, M, K, N)
            max_err = max(max_err, _check_modes(torch, g, ops, (3,)))
            qs = torch.tensor([3], dtype=torch.int32, device=dev)
            args = (ops["xq"], ops["wq"], ops["oflips"], qs)
            b_ms, b_by = bound(M, K, N, (False, "none", False))
            row = dict(shape=[M, K, N], path="train families",
                       mode="global t, no DPPU",
                       launches_per_fat_step=count,
                       plan=list(kernel.gemm_plan(M, K, N, sm_count(dev))),
                       kernel_ms=cuda_ms(torch, functools.partial(
                           kernel.fused_decode, *args), 20),
                       bound_ms=b_ms, bound_by=b_by,
                       plain_ms=cuda_ms(torch, functools.partial(
                           fused_ref, *args[:3], qs.reshape(())), 5),
                       library_ms=cuda_ms(torch, functools.partial(
                           torch._int_mm, ops["xq"], ops["wq"]), 20))
            row["bound_share"] = b_ms / row["kernel_ms"]
            del ops
        fam_rows.append(row)
        emit({"phase": "kernel", "kernel": "fused_decode", **row})
    conv_rows = []
    for path, site, (M, K, N) in (
            [("dse", *c) for c in conv_shapes()]
            + [("train", *c) for c in conv_shapes(TRAIN["cnn_batch"])]):
        ops = _operands(torch, g, dev, M, K, N)
        max_err = max(max_err, _check_modes(torch, g, ops, (3,)),
                      _check_modes(torch, g, _edges(ops), (0, 12, 20)))
        ops = _operands(torch, g, dev, M, K, N)
        qs = torch.tensor([3], dtype=torch.int32, device=dev)
        # torch._int_mm takes K >= 16 and a multiple of 8: pad K with zeros
        Kp = max(-(-K // 8) * 8, 16)
        xpad = torch.zeros((M, Kp), dtype=torch.int8, device=dev)
        wpad = torch.zeros((Kp, N), dtype=torch.int8, device=dev)
        xpad[:, :K], wpad[:K] = ops["xq"], ops["wq"]
        library_ms = cuda_ms(torch, functools.partial(torch._int_mm, xpad,
                                                      wpad), 20)
        for dppu, label in (("none", "global t, no DPPU"),
                            ("wcl", "global t, DPPU wcl")):
            kw = {} if dppu == "none" else dict(
                wq_clean=ops["wq_clean"], dflips=ops["dflips"],
                imp=ops["imp"])
            args = (ops["xq"], ops["wq"], ops["oflips"], qs)
            b_ms, b_by = bound(M, K, N, (False, dppu, False))
            row = dict(shape=[M, K, N], path=path, site=site, mode=label,
                       plan=list(kernel.gemm_plan(M, K, N, sm_count(dev))),
                       kernel_ms=cuda_ms(torch, functools.partial(
                           kernel.fused_decode, *args, dppu_src=dppu, **kw),
                           20),
                       bound_ms=b_ms, bound_by=b_by,
                       plain_ms=cuda_ms(torch, functools.partial(
                           fused_ref, *args[:3], qs.reshape(()), **kw), 5),
                       library_ms=library_ms, library_k=Kp)
            row["bound_share"] = b_ms / row["kernel_ms"]
            conv_rows.append(row)
            emit({"phase": "kernel", "kernel": "fused_decode", **row})
        del ops
    torch.cuda.synchronize()
    return rows, sched_rows, conv_rows, fam_rows, max_err


# ------------------------------------------------ qmatmul, protected_mm, inject
def _dla_operands(torch, g, dev, M, K, N, edges=False):
    """int8 operands (with edges: rows and columns that saturate the 24-bit
    accumulator at both ends once K > 516, and a zero row); two plane
    streams as int32 bit patterns with low words mixed in (BER 1e-2 flips)
    and all-ones words in row 0 (BER 1.0 leaves them); a mixed important
    mask; int32 8-bit values and per-column protection counts 0..8, and
    -1..9 mixed within groups of 4 columns (prot_wide)."""
    xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    if edges:
        for r, v in zip(range(M), (127, -128, 0)):
            xq[r] = v
        wq[:, 0], wq[:, 1] = 127, -128

    def planes():
        from repro_torch.core import prng
        w = torch.randint(0, 1 << 32, (8, M, N), generator=g, device=dev,
                          dtype=torch.int64)
        low = torch.rand((8, M, N), generator=g, device=dev) < 0.05
        w = torch.where(low, w >> 8, w)
        w[:, 0] = (1 << 32) - 1
        return prng.as_int32_bits(w)
    return dict(
        xq=xq, wq=wq, ro=planes(), ri=planes(),
        imp=(torch.rand(N, generator=g, device=dev) < 0.4).to(torch.int32),
        x32=torch.randint(-128, 128, (M, N), generator=g, device=dev,
                          dtype=torch.int32),
        prot=(torch.arange(N, device=dev) % 9).to(torch.int32),
        prot_wide=(torch.arange(N, device=dev) * 7 % 11 - 1).to(torch.int32))


def _check_dla(torch, ops):
    """Each DLA kernel against its plain version, bitwise, on ``ops``:
    qmatmul at t 0/1/16, protected_mm at PM_EDGES, fault_inject at BER
    0/1e-2/1.0 with both protection vectors, on its operands as they are,
    and with x, the planes or protect (each, then all three) 1 word off
    16-byte alignment.  Returns {kernel: max |difference|} (0, or it
    raised)."""
    from repro_torch.kernels.fault_inject.kernel import fault_inject
    from repro_torch.kernels.fault_inject.ref import inject_ref
    from repro_torch.kernels.protected_mm.kernel import protected_mm
    from repro_torch.kernels.protected_mm.ref import protected_mm_ref
    from repro_torch.kernels.qmatmul.kernel import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    xq, wq = ops["xq"], ops["wq"]
    cases = [("qmatmul", t, functools.partial(qmatmul, xq, wq, t),
              functools.partial(qmatmul_ref, xq, wq, t)) for t in (0, 1, 16)]
    pm_args = (xq, wq, ops["ro"], ops["ri"], ops["imp"])
    for t, ber, ib, nb in PM_EDGES:
        kw = dict(t=t, ber=ber, ib=ib, nb=nb)
        cases.append(("protected_mm", kw,
                      functools.partial(protected_mm, *pm_args, **kw),
                      functools.partial(protected_mm_ref, *pm_args, **kw)))
    for prot in ("prot", "prot_wide"):
        for off in ((), (0,), (1,), (2,), (0, 1, 2)):
            fi_args = [ops["x32"], ops["ro"], ops[prot]]
            for i in off:
                fi_args[i] = _misaligned(torch, fi_args[i])
            for ber in (0.0, 1e-2, 1.0):
                cases.append(("fault_inject", (ber, prot, "misaligned", off),
                              functools.partial(fault_inject, *fi_args, ber),
                              functools.partial(inject_ref, *fi_args, ber)))
    err = dict.fromkeys(KERNELS[1:], 0)
    for name, case, kernel_fn, plain_fn in cases:
        y = kernel_fn()
        torch.cuda.synchronize()
        e = int((y.to(torch.int32) - plain_fn().to(torch.int32)).abs().max())
        if e:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{tuple(xq.shape)} x {tuple(wq.shape)} "
                                 f"{case}: {e}")
        err[name] = max(err[name], e)
    return err


def phase_dla_kernels(torch):
    """qmatmul, protected_mm and fault_inject against their plain versions,
    bitwise, at the main path's shapes (random and saturating operands) and
    two ragged ones; per-launch timings at the main path's shapes, in the
    main path's mode for protected_mm (crt3: ib = nb = 3, no important
    channel, BER 1e-4)."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.fault_inject.kernel import fault_inject
    from repro_torch.kernels.fault_inject.ref import inject_ref
    from repro_torch.kernels.plan import gemm_plan
    from repro_torch.kernels.protected_mm.kernel import protected_mm
    from repro_torch.kernels.protected_mm.ref import protected_mm_ref
    from repro_torch.kernels.qmatmul.kernel import qmatmul
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    max_err = dict.fromkeys(KERNELS[1:], 0)
    rows = {k: [] for k in KERNELS[1:]}

    def merge(err):
        for k, e in err.items():
            max_err[k] = max(max_err[k], e)
    for M, K, N in ((5, 200, 130), (37, 1000, 130)) + EDGE_SHAPES \
            + MISALIGNED_SHAPES:
        for edges in (False, True):
            ops = _dla_operands(torch, g, dev, M, K, N, edges)
            if (M, K, N) in MISALIGNED_SHAPES:
                ops["xq"], ops["wq"] = (_misaligned(torch, ops[k])
                                        for k in ("xq", "wq"))
            merge(_check_dla(torch, ops))
    for (M, K, N), count in launches_per_generation().items():
        ops = _dla_operands(torch, g, dev, M, K, N)
        merge(_check_dla(torch, ops))
        merge(_check_dla(torch, _dla_operands(torch, g, dev, M, K, N,
                                              edges=True)))
        xq, wq = ops["xq"], ops["wq"]
        t = MAIN_PM["t"]
        xpad = torch.zeros((max(M, 24), K), dtype=torch.int8, device=dev)
        xpad[:M] = xq                    # torch._int_mm takes M > 16
        lib = functools.partial(torch._int_mm, xpad, wq)
        lib_label = "torch._int_mm, the GEMM part"
        gemm_bytes, gemm_ops = M * K + K * N + M * N, 2 * M * K * N

        b_ms, b_by = roofline(gemm_bytes, gemm_ops)
        rows["qmatmul"].append(dict(
            shape=[M, K, N], mode=f"t={t}", launches_per_generation=0,
            plan=list(gemm_plan(M, K, N, sm_count(dev))),
            kernel_ms=cuda_ms(torch, functools.partial(qmatmul, xq, wq, t),
                              20),
            bound_ms=b_ms, bound_by=b_by,
            plain_ms=cuda_ms(torch, functools.partial(qmatmul_ref, xq, wq,
                                                      t), 5),
            library_ms=cuda_ms(torch, lib, 20), library=lib_label))

        imp0 = torch.zeros(N, dtype=torch.int32, device=dev)
        prot = torch.full((N,), MAIN_PM["nb"], dtype=torch.int32, device=dev)
        pm_args = (xq, wq, ops["ro"], ops["ri"], imp0)
        b_ms, b_by = roofline(
            gemm_bytes + 4 * N + 4 * unprotected_planes(M, prot), gemm_ops)
        rows["protected_mm"].append(dict(
            shape=[M, K, N], mode="crt3: ib=nb=3, no important channel, "
            f"BER 1e-4, t={t}", launches_per_generation=count,
            plan=list(gemm_plan(M, K, N, sm_count(dev))),
            kernel_ms=cuda_ms(torch, functools.partial(
                protected_mm, *pm_args, **MAIN_PM), 20),
            bound_ms=b_ms, bound_by=b_by,
            plain_ms=cuda_ms(torch, functools.partial(
                protected_mm_ref, *pm_args, **MAIN_PM), 5),
            library_ms=cuda_ms(torch, lib, 20), library=lib_label))

        fi_args = (ops["x32"], ops["ro"], prot, MAIN_PM["ber"])
        b_ms, b_by = roofline(8 * M * N + 4 * N
                              + 4 * unprotected_planes(M, prot), 0)
        rows["fault_inject"].append(dict(
            shape=[M, N], mode="protect=3 on every column, BER 1e-4",
            launches_per_generation=0,
            kernel_ms=cuda_ms(torch, functools.partial(fault_inject,
                                                       *fi_args), 20),
            bound_ms=b_ms, bound_by=b_by,
            plain_ms=cuda_ms(torch, functools.partial(inject_ref, *fi_args),
                             5),
            library_ms=None, library="none computes this function"))
        for name in rows:
            rows[name][-1]["bound_share"] = (rows[name][-1]["bound_ms"]
                                             / rows[name][-1]["kernel_ms"])
            emit({"phase": "kernel", "kernel": name, **rows[name][-1]})
        del ops
    fi_args = (torch.zeros((1, 4), dtype=torch.int32, device=dev),
               torch.zeros((8, 1, 4), dtype=torch.int32, device=dev),
               torch.full((4,), MAIN_PM["nb"], dtype=torch.int32, device=dev),
               MAIN_PM["ber"])
    emit({"phase": "floor", "kernel": "fault_inject", "shape": [1, 4],
          "mode": "protect=3 on every column, BER 1e-4",
          "kernel_ms": cuda_ms(torch, functools.partial(fault_inject,
                                                        *fi_args), 20),
          "what": "one launch over 4 words (x, y, protect and 5 planes: "
                  "128 bytes), timed as the kernel phase times (queued "
                  "behind a device sleep): a launch's fixed cost, beside "
                  "which the 4 x N shapes of qmatmul and fault_inject are "
                  "read"})
    torch.cuda.synchronize()
    return rows, max_err


def phase_entry_points(torch):
    """The kernel-level entry points of qmatmul and fault_inject
    (``quant_linear``, ``inject``) at the decode shapes, each equal to the
    CPU port bitwise.  Counts and CUDA events cover these calls only.
    Returns ({kernel: (launches, device ms)}, {kernel: (bound ms, side)}),
    the bound from this run's inputs."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.kernels.fault_inject import kernel as fi_kernel
    from repro_torch.kernels.fault_inject.ops import inject
    from repro_torch.kernels.qmatmul import kernel as qm_kernel
    from repro_torch.kernels.qmatmul.ops import quant_linear
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    shapes = list(dict.fromkeys(LAYER_KN))
    cases = [tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((B, K)).astype(np.float32),
        rng.standard_normal((K, N)).astype(np.float32),
        rng.integers(-128, 128, (B, N)).astype(np.int32),
        (np.arange(N) % 9).astype(np.int32))) for K, N in shapes]
    mods = {"qmatmul": qm_kernel, "fault_inject": fi_kernel}
    timers = {k: LaunchTimer(torch, mod._lib(), k) for k, mod in mods.items()}
    real_libs = {k: mod._lib for k, mod in mods.items()}
    for k, mod in mods.items():
        mod._lib = functools.partial(timers.get, k)
    qm_kernel.qmatmul.launches = fi_kernel.fault_inject.launches = 0
    got = [(quant_linear(x.to(dev), w.to(dev), 9),    # the paths' runs
            inject(prng.PRNGKey(100 + i, dev), v.to(dev), prot.to(dev), 1e-2))
           for i, (x, w, v, prot) in enumerate(cases)]
    torch.cuda.synchronize()
    launches = {"qmatmul": qm_kernel.qmatmul.launches,
                "fault_inject": fi_kernel.fault_inject.launches}
    out = {}
    for k, mod in mods.items():
        mod._lib = real_libs[k]
        if len(timers[k].events) != launches[k] or not launches[k]:
            raise AssertionError(f"{k}: {len(timers[k].events)} timed "
                                 f"launches, {launches[k]} counted")
        out[k] = (launches[k], timers[k].ms())
    for i, ((x, w, v, prot), (y, z)) in enumerate(zip(cases, got)):
        if not torch.equal(y.cpu(), quant_linear(x, w, 9)):
            raise AssertionError("quant_linear on the card differs from the "
                                 f"CPU at {tuple(w.shape)}")
        if not torch.equal(z.cpu(), inject(prng.PRNGKey(100 + i), v, prot,
                                           1e-2)):
            raise AssertionError("inject on the card differs from the CPU at "
                                 f"{tuple(v.shape)}")
    bounds = {"qmatmul": [roofline(B * K + K * N + B * N, 2 * B * K * N)
                          for K, N in shapes],
              "fault_inject": [roofline(8 * B * N + 4 * N + 4 *
                                        unprotected_planes(B, c[3]), 0)
                               for c, (K, N) in zip(cases, shapes)]}
    entry_bound = {k: (sum(b for b, _ in v),
                       "bytes" if all(s == "bytes" for _, s in v)
                       else "operations") for k, v in bounds.items()}
    emit({"phase": "entry_points", "shapes": [list(kn) for kn in shapes],
          "batch": B, **{f"{k}_launches": v[0] for k, v in out.items()},
          **{f"{k}_ms": v[1] for k, v in out.items()},
          **{f"{k}_bound_ms": v[0] for k, v in entry_bound.items()},
          "equal_to_cpu": True})
    return out, entry_bound

class LaunchTimer:
    """Stands in for a kernel's loaded library during a path's run and
    records a CUDA event pair around each launch of ``<kernel>_launch``, so
    the kernels line's ``ms`` is the kernel's device time in that run.  A
    pair that finds the card idle also holds the host time of the launch
    call, from the first event to the first kernel's start."""

    def __init__(self, torch, lib, kernel):
        self.torch, self.lib, self.events = torch, lib, []
        self.launch_name = f"{kernel}_launch"
        self.tag = None                 # recorded with each launch's events

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name != self.launch_name:
            return fn

        def timed(*args):
            start, end = (self.torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            err = fn(*args)
            end.record()
            self.events.append((self.tag, start, end))
            return err
        return timed

    def ms(self, tag=None):
        """Device ms of the recorded launches, or of those under ``tag``."""
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for t, s, e in self.events
                   if tag is None or t == tag)

    def count(self, tag):
        return sum(t == tag for t, _, _ in self.events)


def full_model(torch, n_layers=None):
    """Full-width h2o-danube-1.8b (``n_layers`` of its 24 layers where
    given), random bf16 weights from a seed, on the card; a B x PROMPT
    prompt; crt3 at BER 1e-4 without weight faults."""
    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.models import build
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg, get_run_config("h2o-danube-1.8b"))
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT), generator=g,
                                     device=dev)}
    return dict(cfg=cfg, model=model, params=params, batch=batch,
                policy=ft.get_policy("crt3", ber=1e-4, weight_faults=False),
                init_s=init_s,
                n_params=sum(t.numel() for t in leaves(params)))


class PrefillTimer:
    """Stands in for an Engine's model during one generation: forwards
    everything, and times each prefill on the host's clock, synchronized
    on both ends (``ms``: the last one)."""

    def __init__(self, torch, model):
        self.torch, self.model, self.ms = torch, model, None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.model.prefill(*args, **kw)
        self.torch.cuda.synchronize()
        self.ms = 1e3 * (time.perf_counter() - t0)
        return out


def _timed_prefill(torch, engine, batch):
    """Host ms of one prefill-only generation, after a warm-up one."""
    engine.generate(batch, max_new_tokens=0, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(batch, max_new_tokens=0, seed=0)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def phase_engine(torch, m):
    """Full-width danube, fused vs reference tokens, launches counted."""
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg, model, params, batch, policy = (m[k] for k in (
        "cfg", "model", "params", "batch", "policy"))
    # the python loop, pinned: the launch count and the events below count
    # each launch's Python call, which a graph replay does not make
    engines = {b: Engine(model, params, cfg=ServeConfig(max_new_tokens=NEW),
                         policy=policy, ft_backend=b, loop="python")
               for b in ("fused", "reference")}

    fused = engines["fused"]
    prefill_ms = _timed_prefill(torch, fused, batch)

    torch.cuda.reset_peak_memory_stats()
    timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
    real_lib = kernel._lib
    kernel._lib = lambda: timer
    kernel.fused_decode.launches = 0        # the main path's run starts here
    t0 = time.perf_counter()
    toks = fused.generate(batch, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel.fused_decode.launches  # ... and ends here
    kernel._lib = real_lib
    kernel_ms = timer.ms()
    if len(timer.events) != launches:
        raise AssertionError(f"{len(timer.events)} timed launches, "
                             f"{launches} counted")
    peak = torch.cuda.max_memory_allocated()
    want = 7 * cfg.n_layers * (1 + NEW)
    if launches != want:
        raise AssertionError(f"fused_decode launched {launches} times on the "
                             f"main path, expected {want}")
    t0 = time.perf_counter()
    ref_toks = engines["reference"].generate(batch, seed=0)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    if kernel.fused_decode.launches != launches:
        raise AssertionError("the reference backend launched the kernel")
    if toks.shape != (B, NEW) or not bool(((toks >= 0) & (toks < cfg.vocab))
                                          .all()):
        raise AssertionError(f"bad tokens {toks.shape}")
    if not torch.equal(toks, ref_toks):
        raise AssertionError("fused tokens differ from reference tokens:\n"
                             f"{toks.cpu()}\n{ref_toks.cpu()}")
    if fused.stats.roundtrips != 1 + NEW:
        raise AssertionError(f"roundtrips {fused.stats.roundtrips}")
    prof = phase_profile(torch, m, toks, "fused", None, "fused_decode_")
    tps = B * NEW / (total_s - prefill_ms / 1e3)
    emit({"phase": "engine", "backend": "fused", "loop": "python",
          "arch": cfg.name,
          "layers": cfg.n_layers, "params": m["n_params"],
          "param_dtype": "bfloat16", "batch": B, "prompt": PROMPT,
          "new_tokens": NEW, "policy": "crt3", "ber": 1e-4,
          "init_s": round(m["init_s"], 3),
          "prefill_ms": prefill_ms, "decode_tokens_per_s": tps,
          "generate_s": total_s, "reference_generate_s": ref_s,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "fused_decode_ms": kernel_ms,
          "tokens_equal": True, "tokens_row0": toks[0].tolist()})
    for name, row in prof.items():
        emit({"phase": "profile", "backend": "fused", "step": name, **row})
    del engines, fused
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=kernel_ms, tokens=toks,
                decode_tokens_per_s=tps, prefill_ms=prefill_ms,
                step_wall_ms=prof["decode_step"]["wall_ms"])


def phase_pallas_engine(torch, m):
    """Full-width danube through Engine(ft_backend="pallas", ft_t=T): T is
    calibrated on layer 0's first projection (attn/wq) on the prompt; the
    timed generation counts and times protected_mm's launches; a second
    generation holds every launch bitwise to protected_mm_ref on the same
    operands and gives the same tokens."""
    from repro_torch import ft
    from repro_torch.ft import api
    from repro_torch.kernels.protected_mm import kernel as pm_kernel
    from repro_torch.kernels.protected_mm.ref import protected_mm_ref
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg, model, params, batch, policy = (m[k] for k in (
        "cfg", "model", "params", "batch", "policy"))
    D = cfg.d_model
    with torch.no_grad():
        l0 = params["layers"]["l0"]
        h = rms_norm(embed_tokens(params, cfg, batch["tokens"]), l0["ln1"],
                     cfg.norm_eps)
        T = ft.calibrate_t(h.to(torch.float32).reshape(-1, D),
                           l0["attn"]["wq"].reshape(D, -1).to(torch.float32))
    print(f"pallas engine: ft_t = {T} (ft.calibrate_t on layer 0's attn/wq "
          "over the prompt)", flush=True)
    engine = Engine(model, params, cfg=ServeConfig(max_new_tokens=NEW),
                    policy=policy, ft_backend="pallas", ft_t=T,
                    loop="python")                  # pinned, as above
    prefill_ms = _timed_prefill(torch, engine, batch)

    torch.cuda.reset_peak_memory_stats()
    timer = LaunchTimer(torch, pm_kernel._lib(), "protected_mm")
    real_lib = pm_kernel._lib
    pm_kernel._lib = lambda: timer
    pm_kernel.protected_mm.launches = 0     # the path's run starts here
    t0 = time.perf_counter()
    toks = engine.generate(batch, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = pm_kernel.protected_mm.launches  # ... and ends here
    pm_kernel._lib = real_lib
    kernel_ms = timer.ms()
    peak = torch.cuda.max_memory_allocated()
    want = 7 * cfg.n_layers * (1 + NEW)
    if launches != want or len(timer.events) != launches:
        raise AssertionError(f"protected_mm launched {launches} times "
                             f"({len(timer.events)} timed) on the pallas "
                             f"path, expected {want}")
    if toks.shape != (B, NEW) or not bool(((toks >= 0) & (toks < cfg.vocab))
                                          .all()):
        raise AssertionError(f"bad tokens {toks.shape}")
    if engine.stats.roundtrips != 1 + NEW:
        raise AssertionError(f"roundtrips {engine.stats.roundtrips}")

    real = api.protected_mm
    n_checked = 0

    def checked(xq, wq, rnd_ord, rnd_imp, imp, **kw):
        nonlocal n_checked
        y = real(xq, wq, rnd_ord, rnd_imp, imp, **kw)
        want = protected_mm_ref(xq, wq, rnd_ord, rnd_imp, imp, **kw)
        if not torch.equal(y, want):
            raise AssertionError(
                f"protected_mm launch {n_checked} of the checked generation "
                f"differs from protected_mm_ref at {tuple(xq.shape)} x "
                f"{tuple(wq.shape)} {kw}")
        n_checked += 1
        return y
    api.protected_mm = checked          # the backend's call of the kernel
    t0 = time.perf_counter()
    toks_checked = engine.generate(batch, seed=0)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    api.protected_mm = real
    if n_checked != want:
        raise AssertionError(f"{n_checked} launches checked, expected {want}")
    if not torch.equal(toks, toks_checked):
        raise AssertionError("the checked pallas generation gave other "
                             f"tokens:\n{toks.cpu()}\n{toks_checked.cpu()}")
    prof = phase_profile(torch, m, toks, "pallas", T, "protected_mm_kernel")
    planes = plane_cost(torch)
    tps = B * NEW / (total_s - prefill_ms / 1e3)
    emit({"phase": "engine", "backend": "pallas", "loop": "python",
          "arch": cfg.name,
          "layers": cfg.n_layers, "params": m["n_params"],
          "param_dtype": "bfloat16", "batch": B, "prompt": PROMPT,
          "new_tokens": NEW, "policy": "crt3", "ber": 1e-4, "ft_t": T,
          "prefill_ms": prefill_ms, "decode_tokens_per_s": tps,
          "generate_s": total_s, "checked_generate_s": checked_s,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "protected_mm_ms": kernel_ms, "launches_checked": n_checked,
          "checked_tokens_equal": True, "tokens_row0": toks[0].tolist()})
    for name, row in prof.items():
        emit({"phase": "profile", "backend": "pallas", "step": name, **row})
    emit({"phase": "planes", **planes})
    return dict(launches=launches, ms=kernel_ms, tokens=toks, ft_t=T,
                decode_tokens_per_s=tps, prefill_ms=prefill_ms,
                step_wall_ms=prof["decode_step"]["wall_ms"])


def scheduler_workload(vocab):
    """(rid, prompt, max_new_tokens) of the scheduler phase's requests:
    prompt lengths 9-64 (both buckets) and 4-16 new tokens, from a seed, so
    that slots are admitted, evicted and refilled."""
    import numpy as np
    rng = np.random.default_rng(15)
    lens = rng.integers(9, 65, N_REQUESTS)
    news = rng.integers(4, 17, N_REQUESTS)
    return [(rid, [int(t) for t in rng.integers(0, vocab, n)], int(k))
            for rid, (n, k) in enumerate(zip(lens, news))]


def phase_scheduler(torch, m):
    """Full-width danube through the continuous-batching Scheduler on the
    fused backend: fused_decode at prefill (B = 1, global t) and at decode
    (the (B, 2) per-request keys: per-row t), its launches counted and timed;
    the same requests on the reference backend give the same tokens, and one
    request served alone gives the tokens it gave in the crowd."""
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg, model, params, policy = (m[k] for k in (
        "cfg", "model", "params", "policy"))
    spec = scheduler_workload(cfg.vocab)

    def requests(rids=None):
        return [Request(rid=r, tokens=list(t), max_new_tokens=k)
                for r, t, k in spec if rids is None or r in rids]
    scfg = SchedulerConfig(**SCHED)
    # the eager loop, pinned: the launch count and the events below count
    # each launch's Python call, which a graph replay does not make
    scheds = {b: Scheduler(model, params, scfg, policy=policy, ft_backend=b,
                           loop="python")
              for b in ("fused", "reference")}
    fused = scheds["fused"]

    torch.cuda.reset_peak_memory_stats()
    timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
    real_lib = kernel._lib
    kernel._lib = lambda: timer

    host_s = {"prefill": 0.0, "decode": 0.0}

    def tagged(fn, tag):
        # both calls end on a host read of their tokens, so the host clock
        # around them holds their device work
        def run(*args, **kw):
            timer.tag = tag
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host_s[tag] += time.perf_counter() - t0
            return out
        return run
    fused._prefill_one = tagged(fused._prefill_one, "prefill")
    fused._chunk = tagged(fused._chunk, "decode")
    kernel.fused_decode.launches = 0        # the path's run starts here
    t0 = time.perf_counter()
    out = fused.run(requests())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel.fused_decode.launches  # ... and ends here
    kernel._lib = real_lib
    del fused._prefill_one, fused._chunk
    peak = torch.cuda.max_memory_allocated()
    st = fused.stats
    kernel_ms = {tag: timer.ms(tag) for tag in ("prefill", "decode")}
    want = 7 * cfg.n_layers * (st.prefill_calls
                               + SCHED["decode_chunk"] * st.chunk_calls)
    if launches != want or len(timer.events) != launches:
        raise AssertionError(f"fused_decode launched {launches} times "
                             f"({len(timer.events)} timed) on the scheduler "
                             f"path, expected {want}")
    for r, _, k in spec:
        got = out[r]
        if got.finish_reason != "length" or len(got.generated) != k:
            raise AssertionError(f"request {r}: {got.finish_reason}, "
                                 f"{len(got.generated)} of {k} tokens")
        if not all(0 <= t < cfg.vocab for t in got.generated):
            raise AssertionError(f"request {r}: bad tokens {got.generated}")
    if st.blocks_in_use_peak > fused.n_blocks - 1:
        raise AssertionError(f"blocks_in_use_peak {st.blocks_in_use_peak} "
                             f"of {fused.n_blocks - 1}")
    if st.prefill_calls != N_REQUESTS or st.retire_calls != N_REQUESTS:
        raise AssertionError(f"stats {st}")

    t0 = time.perf_counter()
    ref = scheds["reference"].run(requests())
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    if kernel.fused_decode.launches != launches:
        raise AssertionError("the reference backend launched the kernel")
    for r, _, _ in spec:
        if ref[r].generated != out[r].generated:
            raise AssertionError(
                f"request {r}: fused tokens {out[r].generated} differ from "
                f"reference tokens {ref[r].generated}")
    # alone: the shortest request admitted into a refilled slot
    lone = min((s for s in spec if s[0] >= SCHED["max_batch"]),
               key=lambda s: s[2])[0]
    t0 = time.perf_counter()
    alone = fused.run(requests({lone}))
    alone_s = time.perf_counter() - t0
    if alone[lone].generated != out[lone].generated:
        raise AssertionError(
            f"request {lone} alone gave {alone[lone].generated}, in the "
            f"crowd {out[lone].generated}")
    tokens = sum(len(r.generated) for r in out.values())
    emit({"phase": "scheduler", "backend": "fused", "loop": "python",
          "arch": cfg.name,
          "layers": cfg.n_layers, "policy": "crt3", "ber": 1e-4,
          "config": SCHED, "requests": N_REQUESTS,
          "prompt_lens": [len(t) for _, t, _ in spec],
          "max_new_tokens": [k for _, _, k in spec],
          "tokens": tokens, "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
          "prefill_calls_s": host_s["prefill"],
          "chunk_calls_s": host_s["decode"],
          "prefill_calls": st.prefill_calls, "insert_calls": st.insert_calls,
          "chunk_calls": st.chunk_calls, "retire_calls": st.retire_calls,
          "roundtrips": st.roundtrips,
          "blocks_in_use_peak": st.blocks_in_use_peak,
          "n_blocks": fused.n_blocks, "launches": launches,
          "prefill_launches": timer.count("prefill"),
          "decode_launches": timer.count("decode"),
          "fused_decode_ms": kernel_ms["prefill"] + kernel_ms["decode"],
          "fused_decode_prefill_ms": kernel_ms["prefill"],
          "fused_decode_decode_ms": kernel_ms["decode"],
          "max_memory_allocated_bytes": peak,
          "reference_wall_s": ref_s, "tokens_equal": True,
          "alone_rid": lone, "alone_wall_s": alone_s,
          "alone_equals_crowded": True, "tokens_rid0": out[0].generated})
    buckets = [fused._bucket(len(t)) for _, t, _ in spec]
    return dict(launches=launches, ms=timer.ms(), buckets=buckets,
                decode_steps=SCHED["decode_chunk"] * st.chunk_calls,
                tokens={r: out[r].generated for r, _, _ in spec},
                alone_rid=lone, wall_s=wall_s,
                chunk_calls_s=host_s["decode"],
                prefill_calls_s=host_s["prefill"])


def _replay_times(torch, graph, reset, n=5):
    """Device ms of each of ``n`` replays of a StepGraph, from CUDA events
    around each, and the mean host ms of one replay with its sync.
    ``reset()`` runs before each replay, outside the timed span (the
    Scheduler's step index must stay inside its chunk)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    event_ms, wall_ms = [], 0.0
    for s, e in ev:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        graph()
        e.record()
        torch.cuda.synchronize()
        wall_ms += 1e3 * (time.perf_counter() - t0) / n
        event_ms.append(s.elapsed_time(e))
    return event_ms, wall_ms


def _replay_profile(torch, graph, reset, kernel, want, wall_ms, tries=5):
    """A replay under torch.profiler: its device kernel time, its busy share
    against an unprofiled replay's ``wall_ms`` (as phase_profile's shares),
    and how many kernels whose name holds ``kernel`` it ran, which must be
    ``want``.  The profiler can lose a few events of a ~138k-kernel trace
    (one replay read 334 of its 336 and 137,077 of ~138,400 kernels) and
    never adds one, so a replay is traced again, up to ``tries`` times,
    until a trace sees ``want``.  A trace that sees more, or no kernel, or
    no trace that sees ``want``, fails."""
    seen = []
    for _ in range(tries):
        reset()
        prof = _profile(torch, graph, kernel)
        if not prof["kernels_launched"]:
            raise AssertionError(f"the profiler saw no kernel of a replay: "
                                 f"{prof}")
        seen.append(prof["kernel_launches"])
        if prof["kernel_launches"] > want:
            raise AssertionError(f"a replay ran {prof['kernel_launches']} "
                                 f"{kernel}* kernels, expected {want}: "
                                 f"{prof}")
        if prof["kernel_launches"] == want:
            break
    else:
        raise AssertionError(f"no trace of {tries} replays saw {want} "
                             f"{kernel}* kernels: {seen}")
    prof["wall_ms"] = wall_ms
    prof["device_busy_share"] = prof["device_kernel_ms"] / wall_ms
    prof["traces_seen"] = seen
    return prof


def _graph_launches(graph, python_calls, name, per_step):
    """The protected kernel's launches in a graphed run: its wrapper counted
    ``python_calls`` (the eager calls, and the capture's, which launch
    nothing); each replay launches the capture's ``captured_calls`` again
    uncounted.  The capture must hold one call per projection."""
    if graph.graph is None or graph.captured_calls != per_step:
        raise AssertionError(f"the capture recorded {graph.captured_calls} "
                             f"{name} calls, expected {per_step}")
    return python_calls - graph.captured_calls \
        + graph.replays * graph.captured_calls


def phase_scan(torch, m, backend, eager):
    """Full-width danube through Engine(loop="scan") on ``backend``: each
    decode step a replay of one captured CUDA graph.  The first generation
    runs step 0 as the warm-up, captures the step and replays it for steps
    1-15, and gives the python loop's tokens (``eager``, the engine phase's
    run) bitwise, in 2 round trips.  The kernel's counter, zeroed before
    it, shows its wrapper was called at the prefill, the warm-up and the
    capture; with the capture's recorded calls and the replays, the
    generation launched it as often as the python loop's.  A second
    generation on the same Engine only loads the buffers and replays: its
    decode tokens/s take the python phase's formula, with that
    generation's own prefill (timed inside it) off its wall time.  One
    replay is also timed alone, and profiled: it runs the protected
    kernel's kernels once per projection (fused_decode: GEMM and
    epilogue)."""
    from repro_torch.kernels.fused_decode import kernel as fd_kernel
    from repro_torch.kernels.protected_mm import kernel as pm_kernel
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg, model, params, batch, policy = (m[k] for k in (
        "cfg", "model", "params", "batch", "policy"))
    fused = backend == "fused"
    counted = fd_kernel.fused_decode if fused else pm_kernel.protected_mm
    name = "fused_decode" if fused else "protected_mm"
    engine = Engine(model, params, cfg=ServeConfig(max_new_tokens=NEW),
                    policy=policy, ft_backend=backend,
                    ft_t=None if fused else eager["ft_t"], loop="scan")
    per_step = 7 * cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    counted.launches = 0                    # the path's run starts here
    t0 = time.perf_counter()
    toks = engine.generate(batch, seed=0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    python_calls = counted.launches         # ... and ends here
    step = engine._scan_step
    graph = step.graph
    if python_calls != 3 * per_step:
        raise AssertionError(f"{name}'s wrapper was called {python_calls} "
                             f"times, expected {3 * per_step} (the prefill, "
                             "the warm-up step and the capture)")
    if graph.replays != NEW - 1:
        raise AssertionError(f"{graph.replays} replays, expected {NEW - 1}")
    launches = _graph_launches(graph, python_calls, name, per_step)
    if launches != per_step * (1 + NEW):
        raise AssertionError(f"{name} launched {launches} times, expected "
                             f"{per_step * (1 + NEW)}")
    if engine.stats.roundtrips != 2:
        raise AssertionError(f"roundtrips {engine.stats.roundtrips}")
    if not torch.equal(toks, eager["tokens"]):
        raise AssertionError(f"{backend} scan tokens differ from the python "
                             f"loop's:\n{toks.cpu()}\n"
                             f"{eager['tokens'].cpu()}")
    peak = torch.cuda.max_memory_allocated()
    kept = torch.cuda.memory_allocated() - allocated0
    static = sum(t.numel() * t.element_size() for layer in
                 step.caches.values() for t in layer["attn"].values())
    timer = PrefillTimer(torch, engine.model)
    engine.model = timer
    t0 = time.perf_counter()
    again = engine.generate(batch, seed=0)  # loads and replays only
    torch.cuda.synchronize()
    replay_generate_s = time.perf_counter() - t0
    engine.model = timer.model
    if engine._scan_step is not step or graph.replays != 2 * NEW - 1:
        raise AssertionError("the second generation did not replay the "
                             "first one's graph")
    if not torch.equal(again, toks):
        raise AssertionError(f"{backend} scan: a second generation differs")
    tps = B * NEW / (replay_generate_s - timer.ms / 1e3)
    event_ms, wall_ms = _replay_times(torch, graph, lambda: None)
    prof = _replay_profile(torch, graph, lambda: None,
                           "fused_decode_" if fused else "protected_mm_kernel",
                           (2 if fused else 1) * per_step, wall_ms)
    emit({"phase": "scan", "backend": backend, "loop": "scan",
          "arch": cfg.name, "layers": cfg.n_layers, "batch": B,
          "prompt": PROMPT, "new_tokens": NEW, "policy": "crt3",
          "ber": 1e-4, "ft_t": None if fused else eager["ft_t"],
          "capture_s": graph.capture_s, "generate_s": generate_s,
          "replay_generate_s": replay_generate_s,
          "prefill_ms": timer.ms,
          "python_phase_prefill_ms": eager["prefill_ms"],
          "decode_tokens_per_s": tps,
          "python_decode_tokens_per_s": eager["decode_tokens_per_s"],
          "replay_wall_ms": wall_ms, "replay_event_ms": event_ms,
          "python_step_wall_ms": eager["step_wall_ms"],
          "max_memory_allocated_bytes": peak,
          "static_cache_bytes": static,
          "graph_pool_bytes": kept - static,
          "roundtrips": engine.stats.roundtrips,
          "wrapper_calls": python_calls,
          "captured_calls": graph.captured_calls, "replays": NEW - 1,
          "launches": launches, "tokens_equal_python_loop": True})
    emit({"phase": "profile", "backend": backend, "step": "scan_replay",
          **prof})
    del engine, step, graph
    torch.cuda.empty_cache()


def phase_graph_scheduler(torch, m, eager):
    """The scheduler phase's 8 requests through Scheduler(loop="scan"): each
    decode step of a chunk a replay of one captured CUDA graph.  Every
    request's tokens equal the eager run's (``eager``, the scheduler
    phase's) bitwise; a second run on the same Scheduler (caches zeroed,
    graph kept) serves the lone request of that phase and gives its tokens
    again.  The wrapper's calls (prefills, warm-up, capture), with the
    capture's recorded calls and the replays, give the eager run's
    launches; a profiled replay runs fused_decode's two kernels once per
    projection."""
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg, model, params, policy = (m[k] for k in (
        "cfg", "model", "params", "policy"))
    spec = scheduler_workload(cfg.vocab)

    def requests(rids=None):
        return [Request(rid=r, tokens=list(t), max_new_tokens=k)
                for r, t, k in spec if rids is None or r in rids]
    sched = Scheduler(model, params, SchedulerConfig(**SCHED), policy=policy,
                      ft_backend="fused", loop="scan")
    host_s = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, tag):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            host_s[tag] += time.perf_counter() - t0
            return out
        return run
    sched._prefill_one = timed(sched._prefill_one, "prefill")
    sched._chunk = timed(sched._chunk, "decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    kernel.fused_decode.launches = 0        # the path's run starts here
    t0 = time.perf_counter()
    out = sched.run(requests())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    python_calls = kernel.fused_decode.launches  # ... and ends here
    del sched._prefill_one, sched._chunk
    st = sched.stats
    graph = sched._step.graph
    per_step = 7 * cfg.n_layers
    if python_calls != per_step * (st.prefill_calls + 2):
        raise AssertionError(
            f"fused_decode's wrapper was called {python_calls} times, "
            f"expected {per_step * (st.prefill_calls + 2)} (the prefills, "
            "the warm-up step and the capture)")
    want_replays = SCHED["decode_chunk"] * st.chunk_calls - 1
    if graph.replays != want_replays:
        raise AssertionError(f"{graph.replays} replays, expected "
                             f"{want_replays}")
    launches = _graph_launches(graph, python_calls, "fused_decode", per_step)
    if launches != eager["launches"]:
        raise AssertionError(f"fused_decode launched {launches} times, the "
                             f"eager run {eager['launches']}")
    for r, _, _ in spec:
        if out[r].generated != eager["tokens"][r]:
            raise AssertionError(
                f"request {r}: graph tokens {out[r].generated} differ from "
                f"the eager run's {eager['tokens'][r]}")
    peak = torch.cuda.max_memory_allocated()
    kept = torch.cuda.memory_allocated() - allocated0
    static = sum(t.numel() * t.element_size() for layer in
                 sched._caches.values() for t in layer["attn"].values())
    lone = eager["alone_rid"]
    t0 = time.perf_counter()
    alone = sched.run(requests({lone}))
    alone_s = time.perf_counter() - t0
    if alone[lone].generated != eager["tokens"][lone]:
        raise AssertionError(f"request {lone} alone on the graph "
                             f"Scheduler gave {alone[lone].generated}")
    reset = sched._step.j.zero_         # the step's index in its chunk
    event_ms, wall_ms = _replay_times(torch, graph, reset)
    prof = _replay_profile(torch, graph, reset, "fused_decode_",
                           2 * per_step, wall_ms)
    tokens = sum(len(r.generated) for r in out.values())
    emit({"phase": "scheduler", "backend": "fused", "loop": "scan",
          "arch": cfg.name, "layers": cfg.n_layers, "policy": "crt3",
          "ber": 1e-4, "config": SCHED, "requests": N_REQUESTS,
          "tokens": tokens, "capture_s": graph.capture_s, "wall_s": wall_s,
          "tokens_per_s": tokens / wall_s,
          "prefill_calls_s": host_s["prefill"],
          "chunk_calls_s": host_s["decode"],
          "chunk_tokens_per_s": (tokens - st.prefill_calls)
          / host_s["decode"],
          "replay_wall_ms": wall_ms, "replay_event_ms": event_ms,
          "eager_wall_s": eager["wall_s"],
          "eager_tokens_per_s": tokens / eager["wall_s"],
          "eager_chunk_calls_s": eager["chunk_calls_s"],
          "eager_prefill_calls_s": eager["prefill_calls_s"],
          "prefill_calls": st.prefill_calls, "chunk_calls": st.chunk_calls,
          "roundtrips": st.roundtrips, "replays": want_replays,
          "wrapper_calls": python_calls,
          "captured_calls": graph.captured_calls, "launches": launches,
          "max_memory_allocated_bytes": peak,
          "static_cache_bytes": static, "graph_pool_bytes": kept - static,
          "alone_rid": lone, "alone_wall_s": alone_s,
          "tokens_equal_eager": True, "alone_equals_crowded": True})
    emit({"phase": "profile", "backend": "fused", "step":
          "scheduler_replay", **prof})
    del sched, graph
    torch.cuda.empty_cache()


def family_workload(vocab):
    """(rid, prompt, max_new_tokens) of a family's Scheduler run: one
    request of each of FAM_PROMPTS' lengths, FAM["new"] tokens each."""
    import numpy as np
    rng = np.random.default_rng(19)
    return [(rid, [int(t) for t in rng.integers(0, vocab, n)], FAM["new"])
            for rid, n in enumerate(FAM_PROMPTS)]


def family_extras(torch, cfg, g, dev):
    """Each Scheduler request's extra inputs, random bf16 from ``g``:
    seamless's FAM_SCHED_FRAMES frames, paligemma's patch rows; None for
    token-only families."""
    def rows(n):
        return torch.randn((n, cfg.d_model), generator=g, device=dev,
                           dtype=torch.bfloat16)
    if cfg.enc_dec:
        return [{"frames": rows(n)} for n in FAM_SCHED_FRAMES]
    if cfg.frontend == "vision":
        return [{"patch_embeds": rows(cfg.n_frontend_tokens)}
                for _ in FAM_PROMPTS]
    return [None] * len(FAM_PROMPTS)


def phase_families(torch):
    """The MoE, Mamba2-SSD, RG-LRU, encoder-decoder and vision families at
    their published widths (``FAMILIES``' depths): each through
    phase_family.  Returns {arch: that family's counts and times}."""
    out = {}
    for arch in FAMILIES:
        out[arch] = phase_family(torch, arch)
        torch.cuda.empty_cache()
    return out


def phase_family(torch, arch):
    """One family at full width on the fused backend, crt3 at BER 1e-4:

      * Engine(loop="scan"): a generation (the prefill, the warm-up step,
        the capture, then replays) whose tokens equal the reference
        backend's scan, and the capture holds one fused_decode call per
        protected projection; a second generation replays only: its
        decode tokens/s with its own prefill (timed inside it) off its
        wall time; replays timed and one profiled (busy share, the
        kernel's two kernels once per projection);
      * Engine(loop="python") on the same model: the graph's tokens, with
        fused_decode launched once per projection of the prefill and of
        every step, each launch held bitwise to fused_ref on the card;
      * a Scheduler (4 slots, 6 requests of 8-48 prompt tokens, each step
        a graph replay; exact-length prefill, but paligemma's bucketed):
        fused tokens equal the reference backend's, launches once per
        projection per prefill and per decode step.

    An encoder-decoder's prefill also launches each decoder layer's xk and
    xv once over its encoder input, and its encoder (scanned at full
    width, as the reference's, which passes no fault context) none: a
    direct run of the encoder under the policy must launch nothing."""
    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    Bf, P, NEWF = FAM["batch"], FAM["prompt"], FAM["new"]
    cfg = family_config(arch)
    per_step = len(family_kn(cfg))
    cross = len(family_cross_kn(cfg))     # a prefill's xk and xv launches
    model = build(cfg, get_run_config(arch))
    g = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab, (Bf, P), generator=g,
                                     device=dev)}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((Bf, FAM_FRAMES, cfg.d_model),
                                      generator=g, device=dev,
                                      dtype=torch.bfloat16)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(
            (Bf, cfg.n_frontend_tokens, cfg.d_model), generator=g,
            device=dev, dtype=torch.bfloat16)
    policy = ft.get_policy(FAM["policy"], ber=FAM["ber"],
                           weight_faults=False)
    encoder_launches = None
    if cfg.enc_dec:
        # the full-width encoder under the policy: clean, no launch
        from repro_torch.core import prng
        from repro_torch.models import transformer as T
        from repro_torch.models.common import FTCtx
        n0 = kernel.fused_decode.launches
        with torch.no_grad():
            enc = T.encode(params, batch["frames"], cfg=cfg, run=model.run,
                           ftc=FTCtx(policy, prng.PRNGKey(0, device=dev),
                                     backend="fused"))
        torch.cuda.synchronize()
        encoder_launches = kernel.fused_decode.launches - n0
        if encoder_launches or not bool(torch.isfinite(enc).all()):
            raise AssertionError(f"{arch}: the full-width encoder launched "
                                 f"fused_decode {encoder_launches} times "
                                 "(expected none) or gave non-finite "
                                 "values")
        del enc
    scfg = ServeConfig(max_new_tokens=NEWF)

    # -- the scan: graph replays, against the reference backend's scan --
    engine = Engine(model, params, cfg=scfg, policy=policy,
                    ft_backend="fused", loop="scan")
    kernel.fused_decode.launches = 0        # the path's run starts here
    t0 = time.perf_counter()
    toks = engine.generate(batch, seed=0)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    python_calls = kernel.fused_decode.launches  # ... and ends here
    step = engine._scan_step
    graph = step.graph
    if python_calls != 3 * per_step + cross:
        raise AssertionError(f"{arch}: fused_decode's wrapper was called "
                             f"{python_calls} times, expected "
                             f"{3 * per_step + cross} (the prefill, the "
                             "warm-up step and the capture)")
    launches = _graph_launches(graph, python_calls, "fused_decode", per_step)
    if (launches != per_step * (1 + NEWF) + cross
            or graph.replays != NEWF - 1):
        raise AssertionError(f"{arch}: fused_decode launched {launches} "
                             f"times in {graph.replays} replays")
    if toks.shape != (Bf, NEWF) or not bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: bad tokens {toks.shape}")
    ref_engine = Engine(model, params, cfg=scfg, policy=policy,
                        ft_backend="reference", loop="scan")
    t0 = time.perf_counter()
    ref_toks = ref_engine.generate(batch, seed=0)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    if kernel.fused_decode.launches != python_calls:
        raise AssertionError(f"{arch}: the reference backend launched the "
                             "kernel")
    if not torch.equal(toks, ref_toks):
        raise AssertionError(f"{arch}: fused scan tokens differ from the "
                             f"reference backend's:\n{toks.cpu()}\n"
                             f"{ref_toks.cpu()}")
    del ref_engine
    torch.cuda.empty_cache()
    timer = PrefillTimer(torch, engine.model)
    engine.model = timer
    t0 = time.perf_counter()
    again = engine.generate(batch, seed=0)  # loads and replays only
    torch.cuda.synchronize()
    replay_generate_s = time.perf_counter() - t0
    engine.model = timer.model
    if engine._scan_step is not step or not torch.equal(again, toks):
        raise AssertionError(f"{arch}: a second generation did not replay "
                             "the first one's graph to its tokens")
    tps = Bf * NEWF / (replay_generate_s - timer.ms / 1e3)
    event_ms, wall_ms = _replay_times(torch, graph, lambda: None)
    prof = _replay_profile(torch, graph, lambda: None, "fused_decode_",
                           2 * per_step, wall_ms)
    capture_s = graph.capture_s
    del engine, step, graph
    torch.cuda.empty_cache()

    # -- the eager loop: the graph's tokens, every launch checked --
    seen = collections.Counter()
    real, checked = _checked_fused_decode(torch, seen)
    eager = Engine(model, params, cfg=scfg, policy=policy,
                   ft_backend="fused", loop="python")
    fops.fused_decode = checked
    kernel.fused_decode.launches = 0
    t0 = time.perf_counter()
    try:
        eager_toks = eager.generate(batch, seed=0)
        torch.cuda.synchronize()
    finally:
        fops.fused_decode = real
    eager_s = time.perf_counter() - t0
    eager_launches = kernel.fused_decode.launches
    if eager_launches != per_step * (1 + NEWF) + cross or sum(
            seen.values()) != eager_launches:
        raise AssertionError(f"{arch}: the eager loop launched fused_decode "
                             f"{eager_launches} times ({sum(seen.values())} "
                             "checked), expected "
                             f"{per_step * (1 + NEWF) + cross}")
    if not torch.equal(eager_toks, toks):
        raise AssertionError(f"{arch}: graph tokens differ from the eager "
                             f"loop's:\n{toks.cpu()}\n{eager_toks.cpu()}")
    del eager
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "families", "step": "engine", "arch": arch,
          "family": cfg.family, "layers": cfg.n_layers,
          "published_layers": get_config(arch).n_layers,
          "encoder_layers": cfg.n_enc_layers,
          "params": n_params, "published_params": PUBLISHED_PARAMS.get(arch),
          "param_dtype": "bfloat16",
          "init_s": init_s, "batch": Bf, "prompt": P, "new_tokens": NEWF,
          "frames": FAM_FRAMES if cfg.enc_dec else None,
          "patch_rows": cfg.n_frontend_tokens or None,
          "policy": FAM["policy"], "ber": FAM["ber"],
          "prefill_ms": timer.ms, "decode_tokens_per_s": tps,
          "generate_s": generate_s, "replay_generate_s": replay_generate_s,
          "reference_generate_s": ref_s, "capture_s": capture_s,
          "replay_wall_ms": wall_ms, "replay_event_ms": event_ms,
          "device_busy_share": prof["device_busy_share"],
          "launches_per_step": per_step,
          "prefill_launches": per_step + cross,
          "encoder_launches": encoder_launches, "launches": launches,
          "eager_generate_s": eager_s, "eager_launches": eager_launches,
          "checked_launches": sum(seen.values()),
          "checked_shapes": len(seen),
          "max_memory_allocated_bytes": peak,
          "tokens_equal_reference": True, "tokens_equal_eager": True,
          "tokens_row0": toks[0].tolist()})
    emit({"phase": "profile", "backend": "fused", "step":
          f"{arch}_scan_replay", **prof})

    # -- the Scheduler, fused against reference --
    spec = family_workload(cfg.vocab)
    extras = family_extras(torch, cfg, g, dev)
    sc = dict(FAM_SCHED)
    if arch in FAM_SCHED_BUCKETS:
        sc.update(buckets=FAM_SCHED_BUCKETS[arch], max_prompt=None)

    def requests():
        return [Request(rid=r, tokens=list(t), max_new_tokens=k, extras=e)
                for (r, t, k), e in zip(spec, extras)]
    outs, walls, stats = {}, {}, {}
    for backend in ("fused", "reference"):
        sched = Scheduler(model, params, SchedulerConfig(**sc),
                          policy=policy, ft_backend=backend, loop="scan")
        kernel.fused_decode.launches = 0    # the path's run starts here
        t0 = time.perf_counter()
        out = sched.run(requests())
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - t0
        calls = kernel.fused_decode.launches  # ... and ends here
        st = sched.stats
        if backend == "fused":
            sgraph = sched._step.graph
            want = (per_step + cross) * st.prefill_calls + 2 * per_step
            if calls != want:
                raise AssertionError(
                    f"{arch}: the Scheduler called fused_decode {calls} "
                    f"times, expected {want}")
            s_launches = _graph_launches(sgraph, calls, "fused_decode",
                                         per_step)
            want = ((per_step + cross) * st.prefill_calls
                    + per_step * sc["decode_chunk"] * st.chunk_calls)
            if s_launches != want:
                raise AssertionError(f"{arch}: the Scheduler launched "
                                     f"fused_decode {s_launches} times, "
                                     f"expected {want}")
        elif calls:
            raise AssertionError(f"{arch}: the reference backend launched "
                                 "the kernel")
        outs[backend] = {r: q.generated for r, q in out.items()}
        stats[backend] = st
        del sched
    for r, _, k in spec:
        got = outs["fused"][r]
        if len(got) != k or not all(0 <= t < cfg.vocab for t in got):
            raise AssertionError(f"{arch}: request {r} gave {got}")
        if got != outs["reference"][r]:
            raise AssertionError(f"{arch}: request {r}: fused tokens {got} "
                                 "differ from the reference backend's "
                                 f"{outs['reference'][r]}")
    tokens = sum(len(t) for t in outs["fused"].values())
    st = stats["fused"]
    emit({"phase": "families", "step": "scheduler", "arch": arch,
          "layers": cfg.n_layers, "config": sc,
          "prompt_lens": list(FAM_PROMPTS),
          "frames": list(FAM_SCHED_FRAMES) if cfg.enc_dec else None,
          "patch_rows": cfg.n_frontend_tokens or None, "tokens": tokens,
          "wall_s": walls["fused"], "tokens_per_s": tokens / walls["fused"],
          "reference_wall_s": walls["reference"],
          "prefill_calls": st.prefill_calls, "chunk_calls": st.chunk_calls,
          "launches": s_launches, "captured_calls": sgraph.captured_calls,
          "tokens_equal_reference": True,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del model, params, sgraph
    torch.cuda.empty_cache()
    return dict(launches=launches, per_step=per_step,
                prefill_launches=per_step + cross,
                scheduler_launches=s_launches,
                checked_launches=sum(seen.values()),
                decode_tokens_per_s=tps, prefill_ms=timer.ms)


def _first_split(torch, card_calls, cpu_calls):
    """The first projection whose int8 input differs between two runs'
    recorded calls (phase_split), or where their calls part."""
    def ulps(a, b):
        if a is None or b is None or a.shape != b.shape:
            return None
        d = (a.contiguous().view(torch.int32).to(torch.int64)
             - b.contiguous().view(torch.int32).to(torch.int64))
        return int(d.abs().max())

    def from_half(v):
        return float((v - torch.floor(v) - 0.5).abs())
    for i, (a, b) in enumerate(zip(card_calls, cpu_calls)):
        if a["site"] != b["site"] or a["xq"].shape != b["xq"].shape:
            return dict(first_call_out_of_step=i,
                        sites=[a["site"], b["site"]])
        if torch.equal(a["xq"], b["xq"]):
            continue
        normed = a["site"].split("/")[-1] in ("wq", "wk", "wv", "wi", "wg")
        return dict(
            first_differing_projection=i, site=a["site"],
            shape=list(a["x"].shape),
            x_max_ulp_difference=ulps(a["x"], b["x"]),
            rms_norm_input_max_ulp_difference=(
                ulps(a["norm_in"], b["norm_in"]) if normed else None),
            int8_differences=[dict(
                index=ix, int8_card=int(a["xq"][tuple(ix)]),
                int8_cpu=int(b["xq"][tuple(ix)]),
                x_over_scale_card=float(a["v"][tuple(ix)]),
                x_over_scale_cpu=float(b["v"][tuple(ix)]),
                distance_from_half_card=from_half(a["v"][tuple(ix)]),
                distance_from_half_cpu=from_half(b["v"][tuple(ix)]))
                for ix in (a["xq"] != b["xq"]).nonzero().tolist()[:8]])
    return dict(first_differing_projection=None)


def phase_split(torch):
    """Where a faulty run parts between the card and the CPU (ROADMAP.md
    §C).  The reduced Scheduler of tests/test_torch_gpu.py (float32
    parameters from seed 11, 5 requests on 2 slots, crt1 at BER 1e-2 with
    per-row weight faults, fused backend, the eager loop so that every
    projection calls Python) runs on the card and on the CPU; every
    protected projection's input is recorded with its quantization as that
    device computes it.  The line names the first projection whose int8
    input differs: its call, site and shape, the largest last-place
    (float32 ulp) difference of its input and of the rms_norm input that
    produced it, and, for each int8 that differs, x / scale on each device
    and how far its fraction sits from .5."""
    import numpy as np

    import repro_torch.ft as ftmod
    from repro_torch import ft
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import quantization as Q
    from repro_torch.models import build
    from repro_torch.models import common, transformer
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(11), device="cpu")
    rng = np.random.default_rng(30)
    spec = [(i, [int(t) for t in rng.integers(0, cfg.vocab, 3 + 3 * (i % 3))],
             4 + i % 3) for i in range(5)]
    pol = ft.get_policy("crt1", ber=1e-2, weight_faults=True)

    def run(dev):
        calls, site, norm_in = [], [None], [None]
        real_pl, real_sk = ftmod.protect_linear, common.FTCtx.site_key
        real_norm = transformer.rms_norm

        def site_key(self, name):
            site[0] = name
            return real_sk(self, name)

        def rms_norm(x, scale, eps=1e-6):
            norm_in[0] = x.detach().cpu()
            return real_norm(x, scale, eps)

        def protect_linear(key, x, w, policy, important=None, **kw):
            xq, sx = Q.quantize(x, axis=1 if key.dim() == 2 else None)
            calls.append(dict(site=site[0], x=x.cpu(), xq=xq.cpu(),
                              v=(x / sx).cpu(), norm_in=norm_in[0]))
            return real_pl(key, x, w, policy, important, **kw)
        ftmod.protect_linear, common.FTCtx.site_key = protect_linear, \
            site_key
        transformer.rms_norm = rms_norm
        try:
            sched = Scheduler(model, _to(params, dev), SchedulerConfig(
                max_batch=2, buckets=(8, 16), max_new_tokens=6,
                decode_chunk=3, block_size=4), policy=pol,
                ft_backend="fused", loop="python")
            out = sched.run([Request(rid=r, tokens=t, max_new_tokens=k)
                             for r, t, k in spec])
        finally:
            ftmod.protect_linear, common.FTCtx.site_key = real_pl, real_sk
            transformer.rms_norm = real_norm
        return {r: out[r].generated for r, _, _ in spec}, calls

    card, card_calls = run(torch.device("cuda"))
    cpu, cpu_calls = run("cpu")
    row = {"phase": "split", "arch": cfg.name, "policy": "crt1",
           "ber": 1e-2, "weight_faults": "per row", "requests": len(spec),
           "projections": [len(card_calls), len(cpu_calls)],
           "requests_whose_tokens_differ":
               [r for r, _, _ in spec if card[r] != cpu[r]],
           **_first_split(torch, card_calls, cpu_calls)}
    emit(row)


def plane_cost(torch):
    """Device ms of one decode step's plane draws (2 streams x 8 planes per
    projection, 7 projections x 24 layers): over the output padded to 128
    rows, as the pallas backend draws them (the reference's stream), and
    over the B rows it uses."""
    from repro_torch.core import prng
    from repro_torch.kernels.fault_inject.ops import random_planes
    key = prng.PRNGKey(0, torch.device("cuda"))
    out = {}
    for label, rows in (("padded_128_rows", 128), (f"unpadded_{B}_rows", B)):
        per_layer = 0.0
        for _, N in LAYER_KN:
            n = -(-N // 128) * 128 if rows == 128 else N
            per_layer += 2 * cuda_ms(torch, functools.partial(
                random_planes, key, (rows, n)), 5)
        out[f"decode_step_device_ms_{label}"] = 24 * per_layer
    return out


def _profile(torch, fn, kernel):
    """Wall time of ``fn`` and the device time of its kernels, from one run
    under torch.profiler: all kernels, and those whose name holds
    ``kernel``.  Only the device is traced: an eager step's ~140k host ops
    would double the events to read back.  The trace's raw events are read
    (``kineto_results``), not ``prof.events()``, whose Python event objects
    cost ~0.2 ms each: ~80 s for a paligemma FAT step's ~400k kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ns = kern_ns = 0
    n_kernels = n_kernel = 0
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        ns = e.duration_ns()
        dev_ns += ns
        n_kernels += 1
        if kernel in e.name():
            kern_ns += ns
            n_kernel += 1
    dev_us, kern_us = dev_ns / 1e3, kern_ns / 1e3
    return {"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
            "kernel": kernel, "kernel_ms": kern_us / 1e3,
            "kernels_launched": n_kernels, "kernel_launches": n_kernel}


def phase_profile(torch, m, toks, backend, t, kernel):
    """Where a prefill and a decode step of the engine spend time."""
    from repro_torch.core import prng
    from repro_torch.models.common import FTCtx
    model, params, batch = m["model"], m["params"], m["batch"]
    dev = params["embed"].device
    ftc = FTCtx(m["policy"], prng.PRNGKey(0, dev), backend=backend, t=t)
    out = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        caches, _ = model.prefill(params, batch, max_len=PROMPT + NEW,
                                  ftc=ftc)
        torch.cuda.synchronize()
        wall = {"prefill": time.perf_counter() - t0}
        out["prefill"] = _profile(torch, lambda: model.prefill(
            params, batch, max_len=PROMPT + NEW, ftc=ftc), kernel)
        step = functools.partial(model.decode_step, params, caches,
                                 toks[:, 0], PROMPT, ftc=ftc)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall["decode_step"] = time.perf_counter() - t0
        out["decode_step"] = _profile(torch, step, kernel)
    for name, row in out.items():
        row["wall_ms"] = 1e3 * wall[name]
        row["device_busy_share"] = row["device_kernel_ms"] / row["wall_ms"]
    return out


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def phase_faults(torch):
    """protect_linear on the card: fused == reference == the CPU and pallas
    == the CPU, bitwise; the reduced engines on the card equal the CPU's."""
    import numpy as np

    from repro_torch import ft
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import prng
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, ServeConfig
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((12, 160)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((160, 136)).astype(np.float32))
    imp = torch.from_numpy(rng.random(136) < 0.3)
    checked = 0
    for name in POLICIES:
        pol = ft.get_policy(name, ber=1e-2, weight_faults=True)
        for key in (prng.PRNGKey(3), prng.split(prng.PRNGKey(4), 12)):
            cpu = ft.protect_linear(key, x, w, pol, imp)
            for backend in ("reference", "fused"):
                y = ft.protect_linear(key.to(dev), x.to(dev), w.to(dev), pol,
                                      imp.to(dev), backend=backend)
                if not torch.equal(y.cpu(), cpu):
                    raise AssertionError(f"{name} {backend} on the card "
                                         "differs from the CPU reference")
                checked += 1
    n_pallas = 0
    for name in POLICIES:
        pol = ft.get_policy(name, ber=1e-2)
        key = prng.PRNGKey(9)
        for t in (5, None):
            for lp in ((True, False) if pol.arch.whole_layer_tmr
                       else (True,)):
                kw = dict(backend="pallas", t=t, layer_protected=lp)
                cpu = ft.protect_linear(key, x, w, pol, imp, **kw)
                y = ft.protect_linear(key.to(dev), x.to(dev), w.to(dev), pol,
                                      imp.to(dev), **kw)
                if not torch.equal(y.cpu(), cpu):
                    raise AssertionError(f"{name} pallas {kw} on the card "
                                         "differs from the CPU")
                n_pallas += 1
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    params = model.init(torch.Generator(device=dev).manual_seed(5), device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (3, 20), device=dev,
                                     generator=torch.Generator(device=dev)
                                     .manual_seed(6))}
    pol = ft.get_policy("cl", ber=3e-3, weight_faults=True)
    toks = [Engine(model, params, cfg=ServeConfig(max_new_tokens=8),
                   policy=pol, ft_backend=b).generate(batch, seed=1)
            for b in ("reference", "fused")]
    if not torch.equal(*toks):
        raise AssertionError("reduced engine: fused tokens differ")
    pol = ft.get_policy("crt3", ber=3e-3, weight_faults=False)
    toks = [Engine(model, p, cfg=ServeConfig(max_new_tokens=4), policy=pol,
                   ft_backend="pallas", ft_t=6).generate(
                       {"tokens": batch["tokens"].to(d)}, seed=1).cpu()
            for d, p in ((dev, params), ("cpu", _to(params, "cpu")))]
    if not torch.equal(*toks):
        raise AssertionError("reduced pallas engine: the card's tokens "
                             f"differ from the CPU's:\n{toks[0]}\n{toks[1]}")
    _, logits = model.prefill(params, batch)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    cpu_params = _to(params, "cpu")
    sched_cases = 0
    for label, kw in (("clean", {}), ("temperature 0.8",
                                      dict(temperature=0.8))):
        want = _reduced_scheduler(model, cpu_params, "reference", **kw)
        for kv in ("paged", "dense"):
            got = _reduced_scheduler(model, params, "reference", kv=kv, **kw)
            if got != want:
                raise AssertionError(
                    f"reduced scheduler, {label}, {kv}: the card's tokens "
                    f"differ from the CPU's paged ones:\n{got}\n{want}")
            sched_cases += 1
    # under faults the card's and the CPU's float ops (last-place
    # differences) may round an activation to another int8, so the card's
    # fused run is held to the CPU projection by projection, on the card's
    # operands, and to its own reference backend and dense layout
    pol = ft.get_policy("crt1", ber=1e-2, weight_faults=True)
    real = ft.protect_linear
    n_proj = 0

    def checked_linear(key, x, w, policy, important=None, **kw):
        nonlocal n_proj
        y = real(key, x, w, policy, important, **kw)
        want = real(key.cpu(), x.cpu(), w.cpu(), policy,
                    None if important is None else important.cpu(),
                    **dict(kw, backend="reference"))
        if not torch.equal(y.cpu(), want):
            raise AssertionError(f"reduced scheduler projection {n_proj} "
                                 f"{tuple(x.shape)} differs from the CPU")
        n_proj += 1
        return y
    ft.protect_linear = checked_linear
    try:        # the eager loop: a graph replay calls no Python
        base = _reduced_scheduler(model, params, "fused", pol, loop="python")
    finally:
        ft.protect_linear = real
    for backend, kv in (("reference", "paged"), ("fused", "dense")):
        got = _reduced_scheduler(model, params, backend, pol, kv)
        if got != base:
            raise AssertionError(
                f"reduced scheduler under crt1 with weight faults: {backend} "
                f"{kv} differs from fused paged:\n{got}\n{base}")
    emit({"phase": "faults", "protect_linear_cases": checked,
          "pallas_cases": n_pallas, "reduced_engine_tokens_equal": True,
          "reduced_pallas_engine_equals_cpu": True,
          "reduced_scheduler_clean_cases_equal_to_cpu": sched_cases,
          "reduced_scheduler_projections_equal_to_cpu": n_proj,
          "reduced_scheduler_faulty_backends_and_layouts_equal": True})


def _checked_fused_decode(torch, seen):
    """A stand-in for the fused backend's call of the kernel: each launch
    held bitwise to ``fused_ref`` on the same operands, on the card, and
    counted in ``seen`` by (M, K, N, dppu_src)."""
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.kernels.fused_decode.ref import fused_ref
    real = fops.fused_decode

    def checked(xq, wq, oflips, q_scale, **kw):
        y, t = real(xq, wq, oflips, q_scale, **kw)
        imp = kw.get("imp")
        yr, tr = fused_ref(xq, wq, oflips, q_scale.reshape(()),
                           per_row=kw["per_row"], wflips=kw.get("wflips"),
                           wq_clean=kw.get("wq_clean"),
                           dflips=kw.get("dflips"),
                           imp=None if imp is None else imp.reshape(-1))
        shape = tuple(xq.shape) + (wq.shape[1],)
        if not (torch.equal(y.to(torch.int32), yr) and torch.equal(
                t.reshape(-1), torch.broadcast_to(tr.reshape(-1, 1),
                                                  t.shape).reshape(-1))):
            raise AssertionError(
                f"fused_decode launch {sum(seen.values())} at {shape} "
                f"{kw['dppu_src']} differs from fused_ref")
        seen[shape + (kw["dppu_src"],)] += 1
        return y, t
    return real, checked


def _site_inputs(torch, oracle, policy):
    """The oracle's accuracy under ``policy`` and the int8 input of every
    protected GEMM of it, in call order: [(site, xq, x)] on the CPU."""
    import repro_torch.ft as ftmod
    from repro_torch.core import quantization as Q
    from repro_torch.models import common
    calls, site = [], [None]
    real_pl, real_sk = ftmod.protect_linear, common.FTCtx.site_key

    def site_key(self, name):
        site[0] = name
        return real_sk(self, name)

    def protect_linear(key, x, w, pol, important=None, **kw):
        calls.append((site[0], Q.quantize(x)[0].to(torch.int8).cpu(),
                      x.cpu()))
        return real_pl(key, x, w, pol, important, **kw)
    ftmod.protect_linear, common.FTCtx.site_key = protect_linear, site_key
    try:
        acc = oracle.accuracy(policy)
    finally:
        ftmod.protect_linear, common.FTCtx.site_key = real_pl, real_sk
    return acc, calls


def phase_dse(torch):
    """The paper's cross-layer DSE on the card (Algorithms 1-3): the
    reduced VGG (CNNConfig(): channels 16/32, 16x16 images, 8 classes)
    trained by trained_cnn("vgg", steps=250) on the card, and CnnOracle at
    its defaults (384 images, 3 fault draws, noise 1.6), every protected
    conv and the head one fused_decode launch (M 98,304 / 24,576 / 384,
    K 9-512, N 8-32, global t).  Lines:

      train: its seconds and accuracies (the trained model's must be > 0.6,
        the reference test's bar; chance is 0.125);
      check: one accuracy each under cl and crt2 at BER 2e-3 and arch with
        s0_c0 protected, every fused_decode launch held bitwise to
        fused_ref on the card (5 sites x 3 draws each); the same three on
        the reference backend: equal exactly;
      figs: layer_sensitivity and cumulative_protection at BER 2e-3 (Figs.
        5-6) and the 7 paper policies' accuracies there (Fig. 7);
      optimize: the DSE of examples/crosslayer_dse.py (VGG16's GEMMs for
        the perf/IO models, acc >= 0.97 x clean, perf and bandwidth loss
        <= 10%, BER 1e-3, 16 evaluations in rounds of 8, seed 0): its best
        policy's Table-I fields, area overhead, evaluations, pruned count,
        each candidate's accuracy, area, perf and bandwidth loss, oracle
        seconds per evaluation, and fused_decode's launches (its counter
        zeroed just before, read just after) and their device time; the
        best must be feasible, and it (or, where no candidate is, the most
        accurate one) must re-evaluate to the accuracy the DSE recorded;
      cpu: a recorded line, not a gate: the cl accuracy at one fault draw
        on the card (fused) and on the CPU (reference backend; the card's
        parameters and images copied over), and the first protected GEMM
        whose int8 input differs between them, if any.
    Returns the DSE's launches and device ms, and its launches per shape.
    """
    from repro_torch import ft
    from repro_torch.core import bayesopt as Bo
    from repro_torch.core.evaluate import CnnOracle, trained_cnn
    from repro_torch.core.perfmodel import vgg16_gemms
    from repro_torch.core.pipeline import optimize
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode import ops as fops
    t0 = time.perf_counter()
    oracle = trained_cnn("vgg", steps=DSE["train_steps"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    clean = oracle.accuracy(None)
    cfg = oracle.cfg
    emit({"phase": "dse", "step": "train", "arch": cfg.arch,
          "channels": list(cfg.channels), "hw": cfg.hw,
          "n_classes": cfg.n_classes, "steps": DSE["train_steps"],
          "train_s": train_s, "train_accuracy": oracle.clean_acc,
          "clean_accuracy": clean, "n_eval": oracle.n_eval,
          "n_rep": oracle.n_rep, "noise": oracle.noise})
    if not oracle.clean_acc > 0.6:
        raise AssertionError(f"the trained CNN reached {oracle.clean_acc}, "
                             "not above 0.6")
    sites = len(conv_shapes(oracle.n_eval))

    # every launch of three accuracies against the plain version
    ber = DSE["check_ber"]
    cases = (("cl", ft.get_policy("cl", ber=ber), None),
             ("arch", ft.get_policy("arch", ber=ber), {"s0_c0"}),
             ("crt2", ft.get_policy("crt2", ber=ber), None))
    seen = collections.Counter()
    real, checked = _checked_fused_decode(torch, seen)
    fops.fused_decode = checked
    try:
        fused = {n: oracle.accuracy(p, protected_layers=pl)
                 for n, p, pl in cases}
    finally:
        fops.fused_decode = real
    n_checked = sum(seen.values())
    if n_checked != len(cases) * sites * oracle.n_rep:
        raise AssertionError(f"{n_checked} fused_decode launches checked, "
                             f"expected {len(cases) * sites * oracle.n_rep}")
    oracle.backend = "reference"
    try:
        refb = {n: oracle.accuracy(p, protected_layers=pl)
                for n, p, pl in cases}
    finally:
        oracle.backend = "fused"
    if refb != fused:
        raise AssertionError(f"fused accuracies {fused} differ from the "
                             f"reference backend's {refb}")
    emit({"phase": "dse", "step": "check", "ber": ber,
          "accuracy": fused, "reference_backend_equal": True,
          "launches_checked": n_checked,
          "shapes": sorted([list(k[:3]), k[3], v] for k, v in seen.items())})

    # Figs. 5-7
    t0 = time.perf_counter()
    sens = oracle.layer_sensitivity(ber)
    curve = oracle.cumulative_protection(ber)
    paper = {n: oracle.accuracy(p.with_ber(ber))
             for n, p in ft.paper_policies().items()}
    emit({"phase": "dse", "step": "figs", "ber": ber,
          "layer_sensitivity": sens, "cumulative_protection": curve,
          "paper_policies": paper, "figs_s": time.perf_counter() - t0})

    # the DSE (Algorithm 3 over Algorithms 1-2 and the oracles)
    cons = Bo.Constraints(acc_min=0.97 * clean, perf_max=0.10, bw_max=0.10)
    timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
    real_lib = kernel._lib
    kernel._lib = lambda: timer
    kernel.fused_decode.launches = 0        # the path's run starts here
    t0 = time.perf_counter()
    try:
        res = optimize(oracle.accuracy, vgg16_gemms(), cons, DSE["ber"],
                       iter_max_step=DSE["iter_max_step"], seed=0,
                       batch_size=DSE["batch_size"],
                       acc_oracle_batch=oracle.accuracy_batch)
        torch.cuda.synchronize()
    finally:
        kernel._lib = real_lib
    dse_s = time.perf_counter() - t0
    launches = kernel.fused_decode.launches  # ... and ends here
    dse_ms = timer.ms()
    evals = res.dse.evaluations
    faulty = len(res.dse.history)           # every candidate: BER 1e-3
    want = faulty * sites * oracle.n_rep
    if launches != want or len(timer.events) != launches:
        raise AssertionError(f"the DSE launched fused_decode {launches} "
                             f"times ({len(timer.events)} timed), expected "
                             f"{want} ({sites} sites x {oracle.n_rep} draws "
                             f"x {faulty} candidates)")
    row = {"phase": "dse", "step": "optimize", "ber": DSE["ber"],
           "acc_min": cons.acc_min, "perf_max": cons.perf_max,
           "bw_max": cons.bw_max, "iter_max_step": DSE["iter_max_step"],
           "batch_size": DSE["batch_size"], "evaluations": evals,
           "pruned": res.dse.pruned, "dse_s": dse_s,
           "oracle_s_per_evaluation": dse_s / max(evals, 1),
           "launches": launches, "launches_per_evaluation":
               sites * oracle.n_rep, "fused_decode_ms": dse_ms,
           "feasible_found": res.policy is not None,
           "history_acc_area_perf_bw": [
               [r.acc, r.area, r.perf_loss, r.bw_loss]
               for _, r in res.dse.history]}
    # the best, or the most accurate candidate where none is feasible,
    # evaluated again alone: the DSE's batched lanes (canonical structure,
    # knobs through dyn) and a single accuracy give the same number
    if res.policy is not None:
        best = res.dse.best_eval
        if not best.feasible(cons):
            raise AssertionError(f"the DSE's best {best} is not feasible")
        pol, recorded = res.policy, best.acc
        row.update(area_overhead=res.area_overhead,
                   perf_loss=best.perf_loss, bw_loss=best.bw_loss)
    else:
        from repro_torch.core.pipeline import _policy_from_cfg
        cand, ev = max(res.dse.history, key=lambda h: h[1].acc)
        pol, recorded = _policy_from_cfg(cand, DSE["ber"]), ev.acc
    again = oracle.accuracy(pol)
    if again != recorded:
        raise AssertionError(f"{pol} re-evaluates to {again}, the DSE "
                             f"recorded {recorded}")
    row.update(best={**dataclasses.asdict(pol.algorithm),
                     **dataclasses.asdict(pol.arch),
                     **dataclasses.asdict(pol.circuit)},
               best_is=("the DSE's best" if res.policy is not None
                        else "the most accurate candidate (none feasible)"),
               best_accuracy=recorded, best_accuracy_again=again)
    emit(row)

    # the card against the CPU, at one fault draw (a record, not a gate)
    cl = ft.get_policy("cl", ber=ber)
    one = CnnOracle(oracle.params, cfg, n_rep=1, device="cuda")
    card_acc, card_calls = _site_inputs(torch, one, cl)
    cpu = CnnOracle(_to(oracle.params, "cpu"), cfg, n_rep=1,
                    backend="reference", device="cpu")
    imgs_equal = torch.equal(cpu._imgs, one._imgs.cpu())
    imgs_ulps = int((cpu._imgs.view(torch.int32).to(torch.int64)
                     - one._imgs.cpu().view(torch.int32).to(torch.int64))
                    .abs().max())
    cpu._imgs = one._imgs.cpu()
    cpu_acc, cpu_calls = _site_inputs(torch, cpu, cl)
    first = None
    for i, (a, b) in enumerate(zip(card_calls, cpu_calls)):
        if a[0] != b[0] or not torch.equal(a[1], b[1]):
            d = (a[2].view(torch.int32).to(torch.int64)
                 - b[2].view(torch.int32).to(torch.int64)).abs()
            first = dict(call=i, site=[a[0], b[0]],
                         int8_differences=int((a[1] != b[1]).sum()),
                         x_max_ulp_difference=int(d.max()))
            break
    emit({"phase": "dse", "step": "cpu", "policy": "cl", "ber": ber,
          "n_rep": 1, "card_accuracy": card_acc, "cpu_accuracy": cpu_acc,
          "equal": card_acc == cpu_acc, "calls": [len(card_calls),
                                                  len(cpu_calls)],
          "cpu_images_equal_card": imgs_equal,
          "cpu_images_max_ulp_difference": imgs_ulps,
          "first_differing_int8_input": first})
    per_shape = collections.Counter()
    for _, shape in conv_shapes(oracle.n_eval):
        per_shape[shape] += faulty * oracle.n_rep
    del oracle, one, cpu
    trained_cnn.cache_clear()
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=dse_ms, per_shape=per_shape,
                evaluations=evals)


def phase_mesh(torch, ms):
    """The parallel layer on the card: a one-rank NCCL process group and
    its (1, 1) ('data', 'model') DeviceMesh (``make_local_mesh``), whose
    collectives run as on any mesh (gathers of the heads and of the rows,
    the MoE's sum; in training, of every parameter), on the whole model:

      * full-width danube at all 24 layers, B = 4, prompt 64, NEW new
        tokens under crt3 at BER 1e-4, fused: Engine(mesh=) through the
        scan (its decode step a CUDA graph holding the NCCL collectives)
        gives the meshless Engine's tokens, and the two decode steps'
        replays are timed in alternating windows; then Engine(mesh=,
        loop="python") over the first MESH["checked_new"] tokens, its
        fused_decode launches counted from 0 and each held bitwise to
        fused_ref, gives their first tokens;
      * the scheduler phases' 8 requests through Scheduler(mesh=) at
        SCHED_LAYERS (``ms``), the graphed chunk, equal to the meshless
        Scheduler's;
      * qwen3-moe-235b-a22b at its FAMILIES depth (all 128 experts)
        through the expert-parallel branch, equal to the meshless Engine;
      * one clean and one FAT train step (crt3 at BER 1e-4, fused) of
        full-width danube at MESH["train_layers"] layers from the state's
        shards, against the meshless step: the state (params, m, v), the
        loss and the clip norm bitwise;
      * ``python -m torch.distributed.run --standalone --nproc-per-node 1
        -m repro_torch.launch.train --arch h2o-danube-1.8b --smoke
        --distributed --steps 2`` as a subprocess under a timeout.

    Emits the seconds, the collectives' count and peak memory beside the
    meshless runs'; returns the counted launches and their ms."""
    import os
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ctx as pctx
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    from repro_torch.train import (init_state, make_train_step, shard_state,
                                   state_shardings, unshard_state)
    t_phase = time.perf_counter()
    mesh = make_local_mesh()
    out = {"phase": "mesh", "mesh": {"data": 1, "model": 1},
           "backend": dist.get_backend()}

    def collectives():
        return dict(pctx.COLLECTIVES)

    def run(label, fn):
        """fn's result, its seconds, peak memory (and the memory held
        before it, after a collection: a cycle freed during fn would
        hide fn's own bytes) and collectives."""
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pctx.COLLECTIVES.clear()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[label] = dict(s=time.perf_counter() - t0,
                          peak_bytes=torch.cuda.max_memory_allocated(),
                          base_bytes=base,
                          end_bytes=torch.cuda.memory_allocated(),
                          collectives=collectives())
        return res

    # ---- danube at 24 layers: the scan, then a checked python loop
    m = full_model(torch, MESH["layers"])
    cfg, model, params, batch, policy = (m[k] for k in (
        "cfg", "model", "params", "batch", "policy"))
    scfg = ServeConfig(max_new_tokens=NEW)

    def engine(**kw):
        return Engine(model, params, cfg=scfg, policy=policy,
                      ft_backend="fused", **kw)
    engines = {"meshless": engine(), "mesh": engine(mesh=mesh)}
    ref = run("engine_meshless",
              lambda: engines["meshless"].generate(batch, seed=0))
    toks = run("engine_mesh", lambda: engines["mesh"].generate(batch, seed=0))
    if not torch.equal(toks, ref):
        raise AssertionError(f"mesh Engine tokens differ:\n{toks.cpu()}\n"
                             f"{ref.cpu()}")
    # the two decode steps' replays in alternating windows (ABBAAB), each
    # the median of 5 replays' event ms (step index 0 again before each)
    windows = {"meshless": [], "mesh": []}
    for name in MESH["replay_order"]:
        st = engines[name]._scan_step
        ev, _ = _replay_times(torch, st.graph, st.i.zero_)
        windows[name].append(sorted(ev)[len(ev) // 2])
    out["replay_event_ms_windows"] = windows
    del engines
    seen = collections.Counter()
    real, checked = _checked_fused_decode(torch, seen)
    n = MESH["checked_new"]
    fops.fused_decode = checked
    try:
        timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
        real_lib = kernel._lib
        kernel._lib = lambda: timer
        kernel.fused_decode.launches = 0      # the mesh path's run
        first = run("engine_mesh_checked", lambda: engine(
            mesh=mesh, loop="python").generate(batch, n, seed=0))
        launches = kernel.fused_decode.launches   # ... ends here
    finally:
        fops.fused_decode = real
        kernel._lib = real_lib
    kernel_ms = timer.ms()
    want = 7 * cfg.n_layers * (1 + n)
    if not launches == sum(seen.values()) == want:
        raise AssertionError(f"{launches} launches, {sum(seen.values())} "
                             f"checked, {want} expected")
    if not torch.equal(first, ref[:, :n]):
        raise AssertionError("checked mesh tokens differ")
    out.update(arch=cfg.name, layers=cfg.n_layers, batch=B, prompt=PROMPT,
               new_tokens=NEW, policy="crt3", ber=1e-4, tokens_equal=True,
               fused_decode_launches=launches, checked_launches=launches,
               fused_decode_ms=kernel_ms,
               checked_shapes={" ".join(map(str, k)): v
                               for k, v in sorted(seen.items())})
    del m, model, params
    torch.cuda.empty_cache()

    # ---- the Scheduler at SCHED_LAYERS
    spec = scheduler_workload(ms["cfg"].vocab)

    def serve(**kw):
        sched = Scheduler(ms["model"], ms["params"], SchedulerConfig(**SCHED),
                          policy=ms["policy"], ft_backend="fused", **kw)
        res = sched.run([Request(rid=r, tokens=list(t), max_new_tokens=k)
                         for r, t, k in spec])
        return {r: q.generated for r, q in res.items()}
    want_s = run("scheduler_meshless", serve)
    got_s = run("scheduler_mesh", lambda: serve(mesh=mesh))
    if got_s != want_s:
        raise AssertionError(f"mesh Scheduler tokens differ: {got_s} "
                             f"{want_s}")
    out.update(scheduler_layers=SCHED_LAYERS, scheduler_requests=len(spec),
               scheduler_tokens_equal=True)

    # ---- qwen3-moe through the expert-parallel branch
    arch = MESH["moe_arch"]
    fcfg = family_config(arch)
    fmodel = build(fcfg, get_run_config(arch))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fparams = fmodel.init(g, device=dev)
    fbatch = {"tokens": torch.randint(0, fcfg.vocab, (FAM["batch"],
                                                      FAM["prompt"]),
                                      generator=g, device=dev)}

    def moe(**kw):
        return Engine(fmodel, fparams, cfg=ServeConfig(
            max_new_tokens=FAM["new"]), policy=policy, ft_backend="fused",
            **kw).generate(fbatch, seed=0)
    want_m = run("moe_meshless", moe)
    got_m = run("moe_mesh", lambda: moe(mesh=mesh))
    if not torch.equal(got_m, want_m):
        raise AssertionError("mesh MoE tokens differ")
    out.update(moe_arch=arch, moe_layers=fcfg.n_layers,
               moe_experts=fcfg.moe.n_experts, moe_tokens_equal=True)
    del fmodel, fparams
    torch.cuda.empty_cache()

    # ---- a clean and a FAT train step from the state's shards
    tcfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                               n_layers=MESH["train_layers"])
    run_cfg = get_run_config("h2o-danube-1.8b")
    tmodel = build(tcfg, run_cfg)
    opt = AdamWConfig(dtype=run_cfg.adam_dtype)
    tg = torch.Generator(device=dev).manual_seed(1)
    state0 = init_state(tmodel, tg, opt, device=dev)
    tbatch = {"tokens": torch.randint(0, tcfg.vocab, (TRAIN["batch"],
                                                      TRAIN["seq"]),
                                      generator=tg, device=dev)}
    specs = state_shardings(state0, mesh)
    # a first step builds cuBLAS's state: untimed
    make_train_step(tmodel, opt)(tree.tree_map(torch.clone, state0), tbatch)
    train = {}
    for kind, fat in (("clean", {}), ("fat", dict(
            policy=TRAIN["policy"], ft_ber=TRAIN["ber"],
            ft_backend="fused"))):
        copy = tree.tree_map(torch.clone, state0)
        s1, met1 = run(f"train_{kind}_meshless", lambda: make_train_step(
            tmodel, opt, **fat)(copy, tbatch))
        shards = shard_state(tree.tree_map(torch.clone, state0), mesh, specs)
        inputs = _alloc_bytes(torch, [shards, tbatch])
        s2, met2 = run(f"train_{kind}_mesh", lambda: make_train_step(
            tmodel, opt, mesh=mesh, **fat)(shards, tbatch))
        out[f"train_{kind}_mesh"]["input_bytes"] = inputs
        s2 = unshard_state(s2, specs, mesh)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(tree.leaves(s1), tree.leaves(s2)))
        train[kind] = dict(loss_meshless=float(met1["loss"]),
                           loss_mesh=float(met2["loss"]),
                           grad_norm_meshless=float(met1["grad_norm"]),
                           grad_norm_mesh=float(met2["grad_norm"]),
                           max_abs_state_diff=diff,
                           bitwise=all(torch.equal(a, b) for a, b in zip(
                               tree.leaves(s1), tree.leaves(s2))))
        # one rank: every collective is the identity, so params, m, v, the
        # loss and the clip norm are the meshless step's bit for bit
        if not (math.isfinite(train[kind]["loss_mesh"])
                and train[kind]["bitwise"]
                and torch.equal(met1["loss"], met2["loss"])
                and torch.equal(met1["grad_norm"], met2["grad_norm"])):
            raise AssertionError(f"mesh {kind} train step: {train[kind]}")
        del s1, s2, shards, copy
    out.update(train_layers=tcfg.n_layers, train=train)
    del state0, tmodel
    torch.cuda.empty_cache()

    # ---- the dryrun phase's blocked-attention check: a clean step on the
    # mesh at a length that takes chunked_attention's blocked path
    blk = DRYRUN["checks"]["blocked"]
    bmodel = build(dataclasses.replace(tcfg, n_layers=blk["layers"]),
                   run_cfg)
    bstate = shard_state(init_state(bmodel, tg, opt, device=dev), mesh)
    bbatch = {"tokens": torch.randint(0, tcfg.vocab, (blk["batch"],
                                                      blk["seq"]),
                                      generator=tg, device=dev)}
    inputs = _alloc_bytes(torch, [bstate, bbatch])
    _, met = run("train_blocked_mesh", lambda: make_train_step(
        bmodel, opt, mesh=mesh)(bstate, bbatch))
    if not math.isfinite(float(met["loss"])):
        raise AssertionError(f"blocked train step: loss {met['loss']}")
    out["train_blocked_mesh"]["input_bytes"] = inputs
    del bstate, bbatch, bmodel, met
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # ---- the training launcher under torch.distributed.run
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           "--arch", "h2o-danube-1.8b", "--smoke", "--distributed",
           "--steps", "2", "--ckpt", str(ROOT / "build" / "mesh_ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=MESH["torchrun_timeout"])
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode or "finished at step 2" not in last:
        raise AssertionError(f"torchrun launcher: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out.update(torchrun_s=time.perf_counter() - t0, torchrun_last=last,
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    per_shape = collections.Counter()
    for (M, K, N, _), v in seen.items():
        per_shape[(M, K, N)] += v
    return dict(launches=launches, ms=kernel_ms, per_shape=per_shape,
                train_checks=dict(short=out["train_clean_mesh"],
                                  blocked=out["train_blocked_mesh"]))


def _alloc_bytes(torch, trees):
    """The bytes the caching allocator gives the distinct storages of
    ``trees``' tensors: each rounded up to its 512-byte blocks."""
    from repro_torch.tree import leaves
    seen = {}
    for t in trees:
        for x in leaves(t):
            st = x.untyped_storage()
            seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return sum(seen.values())


def start_dryrun():
    """The dryrun phase's subprocesses, started in the background (they
    need the CPU only): the dry-run CLI on each of DRYRUN's cells, and the
    dry run of each of DRYRUN["checks"]' clean train steps on a fake (1, 1)
    group."""
    import os
    out = ROOT / "build" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for shape in DRYRUN["shapes"]:
        procs[shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN["arch"], "--shape", shape, "--mesh", "single", "--force",
             "--out", str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, c in DRYRUN["checks"].items():
        code = (
            "import dataclasses, json\n"
            "from repro_torch.configs import get_config, get_run_config\n"
            "from repro_torch.configs.base import ShapeConfig\n"
            "from repro_torch.launch import dryrun as D\n"
            "from repro_torch.models import build\n"
            f"arch = {DRYRUN['arch']!r}\n"
            "cfg = dataclasses.replace(get_config(arch), n_layers="
            f"{c['layers']})\n"
            "m = build(cfg, get_run_config(arch))\n"
            f"shape = ShapeConfig({name!r}, 'train', {c['seq']}, "
            f"{c['batch']})\n"
            "r = D.lower_model(m, shape, D.fake_mesh((1, 1), "
            "('data', 'model')))\n"
            "r['card_bytes_constant'] = D.H100_80GB_HBM3_BYTES\n"
            "print(json.dumps(r))\n")
        procs[f"check_{name}"] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return dict(procs=procs, out=out, t0=time.perf_counter())


def _finish(name, proc):
    stdout, stderr = proc.communicate(timeout=DRYRUN["timeout"])
    if proc.returncode:
        raise AssertionError(f"{name}: rc {proc.returncode}\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    return stdout


def phase_dryrun(torch, started, mesh):
    """The production-mesh dry run (``repro_torch.launch.dryrun``), its
    checks against the card, and the examples:

      * the dry-run CLI's cells (DRYRUN: danube's train_4k and decode_32k
        on (16, 16), a fake 256-rank group and fake tensors, started by
        ``start_dryrun``): each cell's peak and persistent GB, fits,
        collective GB by op, TFLOP and trace s; each must be ok and fit;
      * the card checks: the dry run of each of the mesh phase's clean
        train steps of DRYRUN["checks"] (a fake (1, 1) group) against the
        real step on the one-rank NCCL mesh (``phase_mesh``): the step's
        own peak live bytes (the dry run's peak less its inputs; on the
        card, ``max_memory_allocated`` over the step less what was
        allocated before it, the inputs included) within
        DRYRUN["live_rtol"], the same collectives by kind, and the
        card-memory constant equal to ``total_memory``;
      * the examples line: DRYRUN["examples"] on the card, each to exit 0,
        run while the dry runs finish.
    """
    import os
    t_phase = time.perf_counter()
    out = {"phase": "dryrun"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    examples = {}
    for name in DRYRUN["examples"]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=DRYRUN["timeout"])
        if proc.returncode:
            raise AssertionError(f"{name}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        examples[name] = dict(rc=0, s=time.perf_counter() - t0,
                              last=proc.stdout.strip().splitlines()[-1])
    out["examples"] = examples
    cells = {}
    for shape in DRYRUN["shapes"]:
        _finish(shape, started["procs"][shape])
        path = (started["out"] / "single"
                / f"{DRYRUN['arch']}__{shape}.json")
        r = json.loads(path.read_text())
        if r.get("failed") or r.get("skipped"):
            raise AssertionError(f"dry run {shape}: {r}")
        mm, coll = r["memory"], r["collectives"]
        cells[shape] = dict(
            mesh=r["mesh"], peak_gb=mm["peak_bytes"] / 1e9,
            persistent_gb=mm["persistent_bytes"] / 1e9, fits=mm["fits"],
            collective_gb={k: v / 1e9 for k, v in
                           coll["wire_bytes"].items()},
            collectives=coll["count"], tflop=r["flops"] / 1e12,
            trace_s=r["trace_s"], fake_device=r["fake_device"])
        if not mm["fits"]:
            raise AssertionError(f"dry run {shape} does not fit: {cells}")
    out["cells"] = cells
    total = torch.cuda.get_device_properties(0).total_memory
    checks, ok = {}, True
    for name, c in DRYRUN["checks"].items():
        est = json.loads(_finish(name, started["procs"][f"check_{name}"])
                         .strip().splitlines()[-1])
        real = mesh["train_checks"][name]
        est_live = est["memory"]["peak_bytes"] - est["memory"]["input_bytes"]
        live = real["peak_bytes"] - real["base_bytes"]
        rel = abs(est_live - live) / live if live > 0 else math.inf
        checks[name] = dict(
            **c, est_live_bytes=est_live, measured_live_bytes=live,
            rel_err=rel, live_rtol=DRYRUN["live_rtol"],
            est_peak_bytes=est["memory"]["peak_bytes"],
            measured_peak_bytes=live + real["input_bytes"],
            est_input_bytes=est["memory"]["input_bytes"],
            measured_input_bytes=real["input_bytes"],
            est_collectives=est["collectives"]["count"],
            measured_collectives=real["collectives"],
            est_tflop=est["flops"] / 1e12, trace_s=est["trace_s"],
            fake_device=est["fake_device"],
            card_bytes_constant=est["card_bytes_constant"])
        ok &= (rel <= DRYRUN["live_rtol"]
               and est["collectives"]["count"] == real["collectives"]
               and est["card_bytes_constant"] == total)
    out.update(card_checks=checks, total_memory=total,
               background_s=time.perf_counter() - started["t0"],
               phase_s=time.perf_counter() - t_phase)
    if not ok:
        raise AssertionError(f"dry run against the card: {out}")
    emit(out)


def _state_equal(torch, a, b):
    """Names of the leaves of two train states that differ (bitwise)."""
    from repro_torch.tree import items
    return [n for (n, x), (_, y) in zip(items(a), items(b))
            if not torch.equal(x.cpu(), y.cpu())]


def phase_train(torch):
    """Training on the card: the LM through its train step and the Trainer,
    and the CNN's fault-aware training (FAT) with its DSE oracle.

      lm: full-width h2o-danube-1.8b, all 24 layers (random bf16 weights
        from a seed, float32 AdamW moments, every layer recomputed in the
        backward pass), B = 4, S = 64, through make_train_step: 2 clean
        steps and 2 FAT steps on the fused backend (crt3 at BER 1e-4 from
        the step counter 2 on, fat_ramp 2; fused_decode launches counted
        and timed with CUDA events), one more FAT step with every
        fused_decode launch held bitwise to fused_ref, and a profile of
        one FAT step; step seconds, tokens/s, peak memory, losses (finite;
        a drop is not asserted);
      ste: one protected site at full width (layer 0's mlp/wi weight, a
        (256, 2560) input): the STE's forward is protect_linear's bitwise,
        and its gradients are the clean float32 torch.matmul gradients
        within TRAIN["ste_rtol"] of the largest;
      trainer: the same widths cut to TRAIN["trainer_layers"] layers, as
        the script writes at most 45 GiB to disk in a run and one
        full-depth checkpoint is 17.5 GB: a Trainer runs 2 clean steps (its
        checkpoint at step 2), a FAT Trainer restores it and runs steps 3-6,
        checkpointing asynchronously at 4 and 6 into build/; a fresh FAT
        Trainer restores step 4 and runs 5-6: params, m, v and step bitwise
        the uninterrupted run's, with the same losses;
      cnn: trained_cnn_fat("vgg", 250, fat_ber=2e-3) on the card (every
        site of every step one fused_decode launch, at batch 64), then
        FatCnnOracle over fat_ber 0 and 2e-3: accuracy under cl at 2e-3 for
        each, and its batch equal to the singles;
      families: the MoE, Mamba2-SSD, RG-LRU, encoder-decoder and vision
        families' clean and FAT steps and a Trainer resume
        (train_families).
    Returns the launches and device ms of the LM's FAT steps and of the
    CNN's FAT training, with their launches per shape, and the families'
    (train_families)."""
    import dataclasses as dc
    import math
    import shutil

    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prng
    from repro_torch.core.evaluate import (FatCnnOracle, trained_cnn,
                                           trained_cnn_fat)
    from repro_torch.data.pipeline import LMIterator
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (Trainer, TrainerConfig, init_state,
                                   make_train_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    run = get_run_config("h2o-danube-1.8b")
    shape = ShapeConfig("chip_train", "train", TRAIN["seq"], TRAIN["batch"])
    tokens = TRAIN["seq"] * TRAIN["batch"]
    opt = AdamWConfig(dtype=run.adam_dtype)
    policy = ft.get_policy(TRAIN["policy"], ber=TRAIN["ber"],
                           weight_faults=False)
    fat_kw = dict(policy=policy, ft_ber=TRAIN["ber"],
                  ft_key=prng.PRNGKey(TRAIN["fat_seed"], dev),
                  fat_ramp=TRAIN["fat_ramp"], ft_backend="fused")

    # ---- full depth: the train step itself
    model = build(cfg, run)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                       opt, dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    data = LMIterator(cfg, shape, device=dev)
    rows = []

    def timed(step_fn, n):
        nonlocal state
        for _ in range(n):
            batch = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step_fn(state, batch)
            loss = float(met["loss"])
            rows.append(dict(step=int(state["step"]), loss=loss,
                             sec=time.perf_counter() - t0,
                             fat_ber=float(met.get("fat_ber", 0.0))))
    timed(make_train_step(model, opt), TRAIN["clean_steps"])
    fat_step = make_train_step(model, opt, **fat_kw)
    timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
    real_lib = kernel._lib
    kernel._lib = lambda: timer
    kernel.fused_decode.launches = 0        # the FAT steps start here
    try:
        timed(fat_step, TRAIN["fat_steps"])
        torch.cuda.synchronize()
    finally:
        kernel._lib = real_lib
    launches = kernel.fused_decode.launches  # ... and end here
    fat_ms = timer.ms()
    want_launches = 2 * len(LAYER_KN) * cfg.n_layers  # forward, recompute
    if launches != want_launches * TRAIN["fat_steps"]:
        raise AssertionError(f"{TRAIN['fat_steps']} FAT steps launched "
                             f"fused_decode {launches} times, expected "
                             f"{want_launches * TRAIN['fat_steps']}")

    # one more FAT step, every launch held bitwise to the plain version
    batch = next(data)
    seen = collections.Counter()
    real, checked = _checked_fused_decode(torch, seen)
    fops.fused_decode = checked
    try:
        _, checked_metrics = fat_step(state, batch)
        torch.cuda.synchronize()
    finally:
        fops.fused_decode = real
    n_checked = sum(seen.values())
    if n_checked != want_launches:
        raise AssertionError(f"{n_checked} fused_decode launches checked in "
                             f"a FAT step, expected {want_launches}")
    prof = _profile(torch, lambda: fat_step(state, batch), "fused_decode")
    fat_sec = [r["sec"] for r in rows[TRAIN["clean_steps"]:]]
    clean_sec = [r["sec"] for r in rows[:TRAIN["clean_steps"]]]
    prof["wall_ms"] = 1e3 * min(fat_sec[1:] or fat_sec)
    prof["device_busy_share"] = prof["device_kernel_ms"] / prof["wall_ms"]
    prof["kernel_share"] = prof["kernel_ms"] / prof["device_kernel_ms"]
    losses = [r["loss"] for r in rows] + [float(checked_metrics["loss"])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    peak = torch.cuda.max_memory_allocated()

    # one protected site at full width: the STE against the clean matmul
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((tokens, cfg.d_model), generator=g, device=dev)
    w = state["params"]["layers"]["l0"]["ffn"]["wi"].to(torch.float32)
    key = prng.PRNGKey(3, dev)
    xs, ws = (t.clone().requires_grad_(True) for t in (x, w))
    y = ft.protect_linear_ste(key, xs, ws, policy, backend="fused")
    cot = torch.randn(y.shape, generator=g, device=dev)
    gx, gw = torch.autograd.grad(y, (xs, ws), cot)
    y_plain = ft.protect_linear(key, x, w, policy, backend="fused")
    gx_ref, gw_ref = cot @ w.T, x.T @ cot
    ste_err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in ((gx, gx_ref), (gw, gw_ref)))
    ste_equal = torch.equal(y.detach(), y_plain)
    if not ste_equal or ste_err > TRAIN["ste_rtol"]:
        raise AssertionError(f"the STE at full width: forward equal "
                             f"{ste_equal}, gradients {ste_err} of the "
                             "largest apart")
    del state, data, x, w, xs, ws, y, cot, gx, gw, y_plain, gx_ref, gw_ref
    torch.cuda.empty_cache()
    emit({"phase": "train", "step": "lm", "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "param_dtype": run.param_dtype, "adam_dtype": opt.dtype,
          "remat": run.remat, "n_params": n_params,
          "state_gb": state_bytes / 1e9,
          "batch": TRAIN["batch"], "seq": TRAIN["seq"],
          "policy": TRAIN["policy"], "ber": TRAIN["ber"],
          "weight_faults": False,
          "weight_faults_why": "at full width their eager draws take "
                               "minutes per step",
          "fat_ramp": TRAIN["fat_ramp"], "backend": "fused",
          "clean_step_s": clean_sec, "fat_step_s": fat_sec,
          "clean_tokens_per_s": tokens / min(clean_sec[1:] or clean_sec),
          "fat_tokens_per_s": tokens / min(fat_sec[1:] or fat_sec),
          "fat_bers": [r["fat_ber"] for r in rows], "losses": losses,
          "peak_memory_gb": peak / 1e9,
          "fused_decode_launches": launches,
          "fused_decode_launches_per_step": launches / TRAIN["fat_steps"],
          "fused_decode_ms": fat_ms,
          "fused_decode_ms_per_step": fat_ms / TRAIN["fat_steps"],
          "launches_checked": n_checked,
          "checked_shapes": sorted([list(k[:3]), k[3], v]
                                   for k, v in seen.items()),
          "fat_step_profile": prof,
          "ste_site": "layers/l0/ffn/wi", "ste_forward_bitwise": True,
          "ste_grad_max_err_of_largest": ste_err})

    # ---- cut depth: the Trainer, its checkpoints and a resume
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    small = build(dc.replace(cfg, n_layers=TRAIN["trainer_layers"]), run)
    fat = dict(fat_policy=policy, fat_ber=TRAIN["ber"],
               fat_ramp=TRAIN["fat_ramp"], fat_seed=TRAIN["fat_seed"])
    total = TRAIN["clean_steps"] + TRAIN["trainer_fat_steps"]

    def trainer(sub, steps, every, **kw):
        return Trainer(small, shape, opt, TrainerConfig(
            total_steps=steps, ckpt_every=every, ckpt_dir=str(ckdir / sub),
            keep=2, log_every=10 ** 9, **kw), device=dev)
    saved, real_save = [], ckpt.save

    def counted_save(ckpt_dir, state, step, **kw):
        saved.append(step)
        return real_save(ckpt_dir, state, step, **kw)
    ckpt.save = counted_save                # the Trainer's writes, counted
    t0 = time.perf_counter()
    try:
        trainer("run", TRAIN["clean_steps"], TRAIN["ckpt_every"]).run()
        fat_run = trainer("run", total, TRAIN["ckpt_every"], **fat)
        want, step = fat_run.run()
        run_s = time.perf_counter() - t0
        steps = ckpt.available_steps(str(ckdir / "run"))
        if step != total or steps != [4, 6]:
            raise AssertionError(f"the FAT run ended at {step} with "
                                 f"checkpoints {steps}")
        t0 = time.perf_counter()
        resumed = trainer("resume", total, 10 ** 9, **fat)
        s4, step4, dstate = ckpt.restore(str(ckdir / "run"),
                                         resumed.state_like(), step=4,
                                         device=dev)
        resumed.data.restore(dstate)
        got, _ = resumed.run(s4, step4)
        resume_s = time.perf_counter() - t0
        differ = _state_equal(torch, want, got)
        cont = {r["step"]: r["loss"] for r in fat_run.metrics_log}
        if differ or any(r["loss"] != cont[r["step"]]
                         for r in resumed.metrics_log):
            raise AssertionError(
                f"the resumed run differs from the uninterrupted one: "
                f"{differ[:5]}, losses "
                f"{[r['loss'] for r in resumed.metrics_log]}")
    finally:
        ckpt.save = real_save
    state_gb = sum(t.numel() * t.element_size() for t in leaves(got)) / 1e9
    emit({"phase": "train", "step": "trainer", "layers":
          TRAIN["trainer_layers"], "d_model": cfg.d_model,
          "layers_why": "one full-depth checkpoint is 17.5 GB, and the "
                        "script writes at most 45 GiB to disk in a run",
          "state_gb": state_gb, "checkpoints_written": len(saved),
          "checkpoint_steps": saved,
          "checkpoints": steps, "run_s": run_s, "resume_s": resume_s,
          "fat_bers": [r["fat_ber"] for r in fat_run.metrics_log],
          "losses": [r["loss"] for r in fat_run.metrics_log],
          "step_s": [r["sec"] for r in fat_run.metrics_log],
          "resume_from_step_4_bitwise": True})
    del want, got, s4
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # the CNN's fault-aware training and the fat_ber DSE axis
    cl = ft.get_policy("cl", ber=TRAIN["cnn_fat_ber"])
    kernel.fused_decode.launches = 0        # the CNN's FAT run starts here
    t0 = time.perf_counter()
    fat_net = trained_cnn_fat("vgg", TRAIN["cnn_steps"],
                              fat_ber=TRAIN["cnn_fat_ber"])
    torch.cuda.synchronize()
    cnn_fat_s = time.perf_counter() - t0
    cnn_launches = kernel.fused_decode.launches  # ... and ends here
    t0 = time.perf_counter()
    base_net = trained_cnn("vgg", TRAIN["cnn_steps"])
    torch.cuda.synchronize()
    cnn_base_s = time.perf_counter() - t0
    sites = conv_shapes(TRAIN["cnn_batch"])
    if cnn_launches != TRAIN["cnn_steps"] * len(sites):
        raise AssertionError(f"the CNN's FAT training launched fused_decode "
                             f"{cnn_launches} times, expected "
                             f"{TRAIN['cnn_steps'] * len(sites)}")
    oracle = FatCnnOracle("vgg", TRAIN["cnn_steps"])
    fbs = (0.0, TRAIN["cnn_fat_ber"])
    singles = [oracle(cl, fat_ber=fb) for fb in fbs]
    batched = oracle.batch([cl, cl, None], [fbs[1], fbs[0], fbs[1]])
    if batched != [singles[1], singles[0], oracle.oracle(fbs[1])
                   .accuracy(None)]:
        raise AssertionError(f"FatCnnOracle.batch {batched} differs from "
                             f"its singles {singles}")
    if oracle.oracle(fbs[0]) is not base_net or oracle.oracle(
            fbs[1]) is not fat_net:
        raise AssertionError("FatCnnOracle did not reuse the trained nets")
    emit({"phase": "train", "step": "cnn", "arch": "vgg",
          "steps": TRAIN["cnn_steps"], "batch": TRAIN["cnn_batch"],
          "fat_policy": "cl", "fat_ber": TRAIN["cnn_fat_ber"],
          "fat_train_s": cnn_fat_s, "baseline_train_s": cnn_base_s,
          "fat_train_accuracy": fat_net.clean_acc,
          "baseline_train_accuracy": base_net.clean_acc,
          "accuracy_cl_2e-3": {"baseline": singles[0], "fat": singles[1]},
          "batch_equals_singles": True,
          "fused_decode_launches": cnn_launches,
          "shapes": [list(s) for _, s in sites]})
    per_shape = collections.Counter()
    for _, s in sites:
        per_shape[s] += TRAIN["cnn_steps"]
    lm_shapes = collections.Counter()
    for kn in LAYER_KN:
        lm_shapes[(tokens,) + kn] += 2 * cfg.n_layers * TRAIN["fat_steps"]
    del fat_net, base_net, oracle
    trained_cnn.cache_clear()
    trained_cnn_fat.cache_clear()
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=fat_ms, per_shape=lm_shapes,
                cnn_launches=cnn_launches, cnn_per_shape=per_shape,
                families=train_families(torch))


def train_families(torch):
    """The train phase's families part: each of TRAIN_FAMILIES at its
    published widths and cut depth, its batches from LMIterator on the card
    (make_batch's bfloat16 ``frames`` / ``patch_embeds`` drawn there), its
    RUN's grad_accum (qwen3-moe: 4 microbatches) and Adam dtype, through
    make_train_step:

      * one clean step;
      * one FAT step on the fused backend (crt3 at BER 1e-4 from the first
        step on, no weight faults): fused_decode launched exactly 2 x the
        protected projections x the microbatches (the forward, and the
        backward's recompute), its launches timed with CUDA events;
      * one more FAT step with every launch held bitwise to fused_ref;
      * one FAT step profiled (device kernel time, busy share, kernels);
    step seconds, tokens/s (B x S positions), peak memory, finite losses;
    then the Trainer of TRAIN_FAM["trainer_arch"] at trainer_layers (its
    checkpoints small: the script writes at most 45 GiB to disk in a run)
    over the same batches: 2 clean steps, a FAT Trainer that restores them
    and runs on with async checkpoints, and a fresh FAT Trainer restored
    from the middle checkpoint, which must end bitwise on the
    uninterrupted run's state and losses.  Returns {arch: launches, ms,
    per_shape} of the counted FAT steps, and the Trainer's seconds."""
    import math
    import shutil

    from repro_torch import ft
    from repro_torch.configs import get_run_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import prng
    from repro_torch.data.pipeline import LMIterator
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, init_state
    from repro_torch.train import make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves
    dev = torch.device("cuda")
    policy = ft.get_policy(TRAIN_FAM["policy"], ber=TRAIN_FAM["ber"],
                           weight_faults=False)
    fat_kw = dict(policy=policy, ft_ber=TRAIN_FAM["ber"],
                  ft_key=prng.PRNGKey(TRAIN_FAM["fat_seed"], dev),
                  ft_backend="fused")
    out = {}
    for arch in TRAIN_FAMILIES:
        t_arch = time.perf_counter()
        cfg = family_train_config(arch)
        run = get_run_config(arch)
        seq = family_train_seq(cfg)
        shape = ShapeConfig("chip_train", "train", seq, TRAIN_FAM["batch"])
        positions = TRAIN_FAM["batch"] * seq
        opt = AdamWConfig(dtype=run.adam_dtype)
        model = build(cfg, run)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                           opt, dev)
        n_params = sum(t.numel() for t in leaves(state["params"]))
        data = LMIterator(cfg, shape, device=dev)
        batch = next(data)
        inputs = {k: [list(v.shape), str(v.dtype).split(".")[1],
                      str(v.device)] for k, v in batch.items()}
        if any(v.device.type != dev.type for v in batch.values()) or (
                (cfg.enc_dec or cfg.frontend == "vision") and not any(
                    v.dtype == torch.bfloat16 for v in batch.values())):
            raise AssertionError(f"{arch}: the batch is not on the card in "
                                 f"the reference's dtypes: {inputs}")
        want = family_train_launches(arch)
        per_step = sum(want.values())
        losses, secs = {}, {}

        def timed(name, fn, b):
            nonlocal state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = fn(state, b)
            losses[name] = float(met["loss"])
            secs[name] = time.perf_counter() - t0
        timed("clean", make_train_step(model, opt), batch)
        fat_step = make_train_step(model, opt, **fat_kw)
        timer = LaunchTimer(torch, kernel._lib(), "fused_decode")
        real_lib = kernel._lib
        kernel._lib = lambda: timer
        kernel.fused_decode.launches = 0    # the FAT step starts here
        try:
            timed("fat", fat_step, next(data))
            torch.cuda.synchronize()
        finally:
            kernel._lib = real_lib
        launches = kernel.fused_decode.launches  # ... and ends here
        fat_ms = timer.ms()
        if launches != per_step:
            raise AssertionError(f"{arch}: a FAT step launched fused_decode "
                                 f"{launches} times, expected {per_step}")
        seen = collections.Counter()
        real, checked = _checked_fused_decode(torch, seen)
        fops.fused_decode = checked
        try:
            timed("fat_checked", fat_step, next(data))
            torch.cuda.synchronize()
        finally:
            fops.fused_decode = real
        got = collections.Counter()
        for (M, K, N, _), n in seen.items():
            got[(M, K, N)] += n
        if got != want:
            raise AssertionError(f"{arch}: the checked FAT step launched "
                                 f"{dict(got)}, expected {dict(want)}")
        batch = next(data)
        prof = _profile(torch, lambda: timed("fat_profiled", fat_step, batch),
                        "fused_decode")
        prof["wall_ms"] = 1e3 * secs["fat"]     # the unprofiled FAT step
        prof["device_busy_share"] = prof["device_kernel_ms"] / prof["wall_ms"]
        prof["kernel_share"] = prof["kernel_ms"] / prof["device_kernel_ms"]
        if prof["kernel_launches"] > 2 * per_step or not prof[
                "kernels_launched"]:
            raise AssertionError(f"{arch}: the profiled FAT step ran "
                                 f"{prof['kernel_launches']} fused_decode "
                                 f"kernels, expected at most {2 * per_step}")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{arch}: non-finite losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "train", "step": "families", "arch": arch,
              "family": cfg.family, "layers": cfg.n_layers,
              "encoder_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
              "params": n_params, "param_dtype": run.param_dtype,
              "adam_dtype": opt.dtype, "grad_accum": run.grad_accum,
              "remat": run.remat, "batch": TRAIN_FAM["batch"], "seq": seq,
              "inputs": inputs, "policy": TRAIN_FAM["policy"],
              "ber": TRAIN_FAM["ber"], "weight_faults": False,
              "backend": "fused", "clean_step_s": secs["clean"],
              "fat_step_s": secs["fat"],
              "checked_fat_step_s": secs["fat_checked"],
              "clean_tokens_per_s": positions / secs["clean"],
              "fat_tokens_per_s": positions / secs["fat"],
              "losses": losses, "peak_memory_gb": peak / 1e9,
              "fused_decode_launches": launches,
              "fused_decode_ms": fat_ms,
              "launches_checked": sum(seen.values()),
              "shapes": sorted([list(k), v] for k, v in want.items()),
              "fat_step_profile": prof,
              "seconds": time.perf_counter() - t_arch})
        out[arch] = dict(launches=launches, ms=fat_ms, per_shape=want)
        del state, data, batch, model
        torch.cuda.empty_cache()

    # ---- the Trainer of one new-input family at a cut depth
    t0 = time.perf_counter()
    arch = TRAIN_FAM["trainer_arch"]
    n = TRAIN_FAM["trainer_layers"]
    cfg = _cut_config(arch, n)
    run = get_run_config(arch)
    opt = AdamWConfig(dtype=run.adam_dtype)
    small = build(cfg, run)
    shape = ShapeConfig("chip_train", "train", family_train_seq(cfg),
                        TRAIN_FAM["batch"])
    ckdir = ROOT / "build" / "train_fam_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    fat = dict(fat_policy=policy, fat_ber=TRAIN_FAM["ber"], fat_ramp=0,
               fat_seed=TRAIN_FAM["fat_seed"])
    clean_steps = 2
    total = clean_steps + TRAIN_FAM["trainer_fat_steps"]
    middle = clean_steps + TRAIN_FAM["ckpt_every"]

    def trainer(sub, steps, every, **kw):
        return Trainer(small, shape, opt, TrainerConfig(
            total_steps=steps, ckpt_every=every, ckpt_dir=str(ckdir / sub),
            keep=2, log_every=10 ** 9, **kw), device=dev)
    saved, real_save = [], ckpt.save

    def counted_save(ckpt_dir, state, step, **kw):
        saved.append(step)
        return real_save(ckpt_dir, state, step, **kw)
    ckpt.save = counted_save
    try:
        trainer("run", clean_steps, TRAIN_FAM["ckpt_every"]).run()
        fat_run = trainer("run", total, TRAIN_FAM["ckpt_every"], **fat)
        want_state, step = fat_run.run()
        steps = ckpt.available_steps(str(ckdir / "run"))
        if step != total or steps != [middle, total]:
            raise AssertionError(f"{arch} Trainer: ended at {step} with "
                                 f"checkpoints {steps}")
        resumed = trainer("resume", total, 10 ** 9, **fat)
        s_mid, step_mid, dstate = ckpt.restore(
            str(ckdir / "run"), resumed.state_like(), step=middle,
            device=dev)
        resumed.data.restore(dstate)
        got_state, _ = resumed.run(s_mid, step_mid)
        differ = _state_equal(torch, want_state, got_state)
        cont = {r["step"]: r["loss"] for r in fat_run.metrics_log}
        if differ or any(r["loss"] != cont[r["step"]]
                         for r in resumed.metrics_log):
            raise AssertionError(
                f"{arch} Trainer: the resumed run differs from the "
                f"uninterrupted one: {differ[:5]}, losses "
                f"{[r['loss'] for r in resumed.metrics_log]}")
    finally:
        ckpt.save = real_save
    state_gb = sum(t.numel() * t.element_size()
                   for t in leaves(got_state)) / 1e9
    trainer_s = time.perf_counter() - t0
    emit({"phase": "train", "step": "families_trainer", "arch": arch,
          "layers": cfg.n_layers, "encoder_layers": cfg.n_enc_layers,
          "d_model": cfg.d_model, "seq": shape.seq_len,
          "batch": shape.global_batch,
          "layers_why": "a checkpoint stays small: the script writes at "
                        "most 45 GiB to disk in a run",
          "state_gb": state_gb, "checkpoints_written": len(saved),
          "checkpoint_steps": saved, "checkpoints": steps,
          "losses": [r["loss"] for r in fat_run.metrics_log],
          "fat_bers": [r.get("fat_ber") for r in fat_run.metrics_log],
          "step_s": [r["sec"] for r in fat_run.metrics_log],
          f"resume_from_step_{middle}_bitwise": True, "seconds": trainer_s})
    del want_state, got_state, s_mid, small
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def _reduced_scheduler(model, params, backend, policy=None, kv="paged",
                       temperature=0.0, loop="scan"):
    """The reduced model through the Scheduler: 5 requests on 2 slots, two
    buckets, a block size that splits the window.  {rid: tokens}."""
    import numpy as np

    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    rng = np.random.default_rng(31)
    reqs = [Request(rid=i, tokens=[int(t) for t in rng.integers(
                0, model.cfg.vocab, 3 + 3 * (i % 3))], max_new_tokens=4 + i % 3)
            for i in range(5)]
    sched = Scheduler(model, params, SchedulerConfig(
        max_batch=2, buckets=(8, 16), max_new_tokens=6, decode_chunk=3,
        kv=kv, block_size=4, temperature=temperature), policy=policy,
        ft_backend=backend, loop=loop)
    return {rid: r.generated for rid, r in sched.run(reqs).items()}


def _totals(rows, weight):
    """Sums of the per-shape rows' times, each row weighted by
    ``weight(row)`` launches; the bound's side is the one that holds most of
    the summed bound."""
    def total(key):
        return sum(r[key] * weight(r) for r in rows)
    t_bytes = sum(weight(r) * r["bound_ms"] for r in rows
                  if r["bound_by"] == "bytes")
    return dict(plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by="bytes" if t_bytes >= total("bound_ms") / 2
                else "operations",
                library_ms=(None if rows[0]["library_ms"] is None
                            else total("library_ms")),
                kernel_phase_ms=total("kernel_ms"),
                bound_share=total("bound_ms") / total("kernel_ms"))


def kernels_line(name, smi, fused, dla, dla_err, pallas, entry, entry_bound,
                 sched, dse, train, families, mesh):
    """One entry for each of the port's four kernels; fused_decode's also
    holds its scheduler path's run, its DSE path's, its training paths',
    the families phase's and the mesh phase's."""
    src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    rep = "src/repro/kernels/{0}/kernel.py:{1}"
    common = dict(route="cuda", device=name, nvidia_smi=smi)
    gen = (f"one generation (B={B}, prompt {PROMPT}, {NEW} new; danube at "
           f"{SERVE_LAYERS} of its 24 layers): ms from "
           "CUDA events around each launch of the path's run; plain_ms, "
           "bound_ms, library_ms and kernel_phase_ms from the kernel "
           "phase's per-shape times x launches; bound_share = bound_ms / "
           "kernel_phase_ms")
    rows, sched_rows, conv_rows, err, launches, ms = fused
    out = [dict(name="fused_decode", source=src.format("fused_decode"),
                replaces=rep.format("fused_decode", 189), launches=launches,
                max_abs_err=err, ms=ms,
                **_totals(rows, lambda r: r["launches_per_generation"]),
                per=gen + ", fused backend", **common)]
    n_layers = SCHED_LAYERS
    n_prefill = collections.Counter(sched["buckets"])
    kn_count = collections.Counter(LAYER_KN)

    def sched_launches(r):
        M, K, N = r["shape"]
        per = sched["decode_steps"] if M == SCHED["max_batch"] \
            else n_prefill[M]
        return n_layers * kn_count[(K, N)] * per
    tot = _totals(sched_rows, sched_launches)
    out[0].update(
        scheduler_launches=sched["launches"], scheduler_ms=sched["ms"],
        **{f"scheduler_{k}": v for k, v in tot.items()},
        scheduler_per=("the scheduler phase's run (8 requests, danube at "
                       f"{SCHED_LAYERS} of its 24 layers, prefill at "
                       "B=1 per bucket with global t, decode at B=4 with "
                       "per-row t): ms from CUDA events around each launch; "
                       "plain, bound, library and kernel-phase sums from "
                       "the kernel phase's scheduler rows x launches"))
    path_rows = [r for r in conv_rows if r["mode"] == "global t, no DPPU"
                 and r["path"] == "dse"]
    tot = _totals(path_rows, lambda r: dse["per_shape"][tuple(r["shape"])])
    out[0].update(
        dse_launches=dse["launches"], dse_ms=dse["ms"],
        **{f"dse_{k}": v for k, v in tot.items()},
        dse_per=("the dse phase's optimize run (CnnOracle over the reduced "
                 f"VGG, {dse['evaluations']} candidates, 5 conv/head GEMMs "
                 "x 3 fault draws each, global t, no DPPU: the masks never "
                 "reach the datapath, as in the reference): ms from CUDA "
                 "events around each launch; plain, bound, library and "
                 "kernel-phase sums from the kernel phase's conv rows in "
                 "that mode x launches; library_ms pads K = 9 to 16"))
    lm_rows = [r for r in rows if tuple(r["shape"]) in train["per_shape"]]
    tot = _totals(lm_rows, lambda r: train["per_shape"][tuple(r["shape"])])
    out[0].update(
        train_launches=train["launches"], train_ms=train["ms"],
        **{f"train_{k}": v for k, v in tot.items()},
        train_per=(f"the train phase's FAT run ({TRAIN['fat_steps']} steps "
                   f"of full-width danube at B={TRAIN['batch']}, "
                   f"S={TRAIN['seq']}, {TRAIN['policy']} at BER "
                   f"{TRAIN['ber']}: 7 x 24 projections in the forward and "
                   "again in the backward's recompute, global t): ms from "
                   "CUDA events around each launch; plain, bound, library "
                   "and kernel-phase sums from the kernel phase's M = 256 "
                   "prefill rows x launches"))
    cnn_rows = [r for r in conv_rows if r["mode"] == "global t, no DPPU"
                and r["path"] == "train"]
    tot = _totals(cnn_rows,
                  lambda r: train["cnn_per_shape"][tuple(r["shape"])])
    out[0].update(
        train_cnn_launches=train["cnn_launches"],
        **{f"train_cnn_{k}": v for k, v in tot.items()},
        train_cnn_per=(f"the train phase's FAT CNN training "
                       f"({TRAIN['cnn_steps']} steps at batch "
                       f"{TRAIN['cnn_batch']}, cl at "
                       f"{TRAIN['cnn_fat_ber']}: 5 conv/head GEMMs per "
                       "step, global t, no DPPU): plain, bound, library and "
                       "kernel-phase sums from the kernel phase's batch-64 "
                       "conv rows x launches; library_ms pads K = 9 to 16"))
    fam_rows, fam = families
    train_rows = [r for r in fam_rows if r["path"] == "train families"]
    fam_rows = [r for r in fam_rows if r["path"] == "families"]
    tot = _totals(fam_rows, lambda r: r["launches_per_generation"])
    out[0].update(
        families_launches=sum(f["launches"] for f in fam.values()),
        families_launches_per_step={a: f["per_step"]
                                    for a, f in fam.items()},
        families_prefill_launches={a: f["prefill_launches"]
                                   for a, f in fam.items()},
        families_checked_launches=sum(f["checked_launches"]
                                      for f in fam.values()),
        families_scheduler_launches=sum(f["scheduler_launches"]
                                        for f in fam.values()),
        **{f"families_{k}": v for k, v in tot.items()},
        families_per=(f"the families phase's scan generations (B="
                      f"{FAM['batch']}, prompt {FAM['prompt']}, "
                      f"{FAM['new']} new; seamless with {FAM_FRAMES} "
                      "encoder frames, paligemma with its patch rows; "
                      + ", ".join(f"{a} at {family_config(a).n_layers} "
                                  "layers" for a in FAMILIES)
                      + "): launches from the graphs' counts; plain, bound, "
                      "library and kernel-phase sums from the kernel "
                      "phase's family rows x launches"))
    tf = train["families"]
    per_shape = collections.Counter()
    for f in tf.values():
        per_shape.update(f["per_shape"])
    tot = _totals(train_rows, lambda r: per_shape[tuple(r["shape"])])
    out[0].update(
        train_families_launches=sum(f["launches"] for f in tf.values()),
        train_families_ms=sum(f["ms"] for f in tf.values()),
        train_families_launches_per_fat_step={
            a: f["launches"] for a, f in tf.items()},
        train_families_ms_per_fat_step={a: f["ms"] for a, f in tf.items()},
        **{f"train_families_{k}": v for k, v in tot.items()},
        train_families_per=(
            "the train phase's counted FAT step of each family (B="
            f"{TRAIN_FAM['batch']}, S={TRAIN_FAM['seq']}, paligemma "
            f"S={TRAIN_FAM['seq_vision']}; "
            + ", ".join(f"{a} at {family_train_config(a).n_layers} layers"
                        for a in TRAIN_FAMILIES)
            + f"; {TRAIN_FAM['policy']} at BER {TRAIN_FAM['ber']}: every "
            "protected projection in the forward and again in the "
            "backward's recompute, per microbatch, global t): ms from CUDA "
            "events around each launch; plain, bound, library and "
            "kernel-phase sums from the kernel phase's train-family rows x "
            "launches"))
    mesh_rows = [r for r in rows if tuple(r["shape"]) in mesh["per_shape"]]
    tot = _totals(mesh_rows, lambda r: mesh["per_shape"][tuple(r["shape"])])
    out[0].update(
        mesh_launches=mesh["launches"], mesh_ms=mesh["ms"],
        **{f"mesh_{k}": v for k, v in tot.items()},
        mesh_per=(f"the mesh phase's checked run: Engine(mesh=, "
                  f"loop='python') on a one-rank NCCL (1, 1) mesh, danube "
                  f"at {MESH['layers']} layers, B={B}, prompt {PROMPT}, "
                  f"{MESH['checked_new']} new tokens, every launch held to "
                  "fused_ref: ms from CUDA events around each launch; "
                  "plain, bound, library and kernel-phase sums from the "
                  "kernel phase's rows x launches"))
    launches, ms = pallas
    out.append(dict(
        name="protected_mm", source=src.format("protected_mm"),
        replaces=rep.format("protected_mm", 84), launches=launches,
        max_abs_err=dla_err["protected_mm"], ms=ms,
        **_totals(dla["protected_mm"],
                  lambda r: r["launches_per_generation"] * PALLAS_LAYERS
                  // SERVE_LAYERS),
        library="torch._int_mm, the GEMM part",
        per=gen + f", pallas backend, {PALLAS_LAYERS} of the 24 layers",
        **common))
    for kernel, line in (("qmatmul", 55), ("fault_inject", 50)):
        launches, ms = entry[kernel]
        decode = [r for r in dla[kernel] if r["shape"][0] == B]
        tot = _totals(decode, lambda r: 1)
        tot["bound_ms"], tot["bound_by"] = entry_bound[kernel]
        tot["bound_share"] = tot["bound_ms"] / tot["kernel_phase_ms"]
        out.append(dict(
            name=kernel, source=src.format(kernel),
            replaces=rep.format(kernel, line), launches=launches,
            launches_per_generation=0, max_abs_err=dla_err[kernel], ms=ms,
            **tot, library=decode[0]["library"],
            per=("its entry point's run (quant_linear / inject at the 4 "
                 f"decode shapes, M={B}; no serving path launches it): ms "
                 "from CUDA events around each launch, bound_ms from that "
                 "run's inputs, plain_ms, library_ms and kernel_phase_ms "
                 "from the kernel phase's times at those shapes; "
                 "bound_share = bound_ms / kernel_phase_ms"),
            **common))
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, *args)
        key = phase.__name__ + "".join(f"_{a}" for a in args
                                       if isinstance(a, str))
        seconds[key] = time.perf_counter() - t0
        return out
    name, smi = phase_device(torch)
    t0 = time.perf_counter()
    phase_build()
    seconds["phase_build"] = time.perf_counter() - t0
    rows, sched_rows, conv_rows, fam_rows, max_err = run(phase_kernels)
    dla, dla_err = run(phase_dla_kernels)
    entry, entry_bound = run(phase_entry_points)
    m = run(full_model, SERVE_LAYERS)
    fused = run(phase_engine, m)
    run(phase_scan, m, "fused", fused)
    mp = full_model(torch, PALLAS_LAYERS)
    pallas = run(phase_pallas_engine, mp)
    run(phase_scan, mp, "pallas", pallas)
    del mp, m
    torch.cuda.empty_cache()
    ms = full_model(torch, SCHED_LAYERS)
    sched = run(phase_scheduler, ms)
    run(phase_graph_scheduler, ms, sched)
    mesh = run(phase_mesh, ms)
    del ms
    torch.cuda.empty_cache()
    # the dry runs need only the CPU: started after the host-bound timed
    # phases, they overlap the examples
    dryrun = start_dryrun()
    run(phase_dryrun, dryrun, mesh)
    families = run(phase_families)
    run(phase_faults)
    dse = run(phase_dse)
    train = run(phase_train)
    run(phase_split)
    emit({"phase": "seconds", **seconds})
    emit(kernels_line(name, smi, (rows, sched_rows, conv_rows, max_err,
                                  fused["launches"], fused["ms"]), dla,
                      dla_err, (pallas["launches"], pallas["ms"]), entry,
                      entry_bound, sched, dse, train,
                      (fam_rows, families), mesh))
    print("chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernel
against the plain version.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, in order; any failure raises and the script exits nonzero without
its last line:

  1. device: the card's name and power limit;
  2. build: the port's CUDA kernels from the checkout's sources (build/);
  3. kernels: fused_decode against its plain version, bitwise, in every mode
     at the main path's shapes, on random operands and on operands that
     drive the epilogue's clamps (24-bit saturation, t's upper clamp of 16,
     q_scale above the natural t); timed beside its bound, the plain version
     and one PyTorch call (torch._int_mm on the same int8 operands);
  4. engine: full-width h2o-danube-1.8b (random bf16 weights from a seed,
     all 24 layers), B=4, prompt 64, 16 new tokens under crt3 at BER 1e-4:
     fused tokens equal reference tokens, the kernel ran once per
     projection of every step, and its device time over that generation
     (CUDA events around each launch) is the kernels line's ``ms``;
  5. faults: protect_linear fused equals reference on the card, for all 7
     policies with weight faults, per-row keys and an important mask, and
     equals the CPU; the reduced engine under cl with weight faults;
  6. a ``kernels`` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core peak, same source
B, PROMPT, NEW = 4, 64, 16
# (K, N) of the seven projections of one danube layer: wq wk wv wo wi wg wo
LAYER_KN = ((2560, 2560), (2560, 640), (2560, 640), (2560, 2560),
            (2560, 6912), (2560, 6912), (6912, 2560))
POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
MODES = ([(pr, d, False) for pr in (False, True)
          for d in ("none", "reuse", "w", "wcl")]
         + [(pr, d, True) for pr in (False, True) for d in ("none", "w", "wcl")])


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters):
    """Mean device time of ``fn`` in ms over ``iters`` launches, after a
    warm-up, from CUDA events around each launch.  The operands stay in L2
    between launches, as on the main path, where ``quantize`` writes the
    int8 weights (at most 17.7 MB of the 50 MB L2) just before the kernel
    reads them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)
    return name, smi


def phase_build():
    from repro_torch.kernels.fused_decode import kernel
    t0 = time.perf_counter()
    path, report = kernel.build()
    secs = time.perf_counter() - t0
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    emit({"phase": "build", "kernel": "fused_decode", "library":
          str(path.relative_to(ROOT)), "build_s": round(secs, 3)})


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
    xq[0], xq[1], xq[2] = 127, -128, 0
    xq[3] = xq[3] % 3 - 1
    wq[:, 0], wq[:, 1], wq[:, 2] = 127, -128, 0
    return ops


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
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode.ref import fused_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    max_err, rows = 0, []
    per_gen = {}
    for kn in LAYER_KN:
        per_gen[(PROMPT * B,) + kn] = per_gen.get((PROMPT * B,) + kn, 0) + 24
        per_gen[(B,) + kn] = per_gen.get((B,) + kn, 0) + 24 * NEW
    for (M, K, N), count in per_gen.items():
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
                   kernel_ms=cuda_ms(torch, call, 20),
                   bound_ms=b_ms, bound_by=b_by,
                   plain_ms=cuda_ms(torch, plain, 5),
                   library_ms=cuda_ms(torch, lib, 20))
        rows.append(row)
        emit({"phase": "kernel", "kernel": "fused_decode", **row})
        max_err = max(max_err, _check_modes(torch, g, _edges(ops),
                                            (0, 12, 20)))
        del ops
    torch.cuda.synchronize()
    return rows, max_err


class LaunchTimer:
    """Stands in for fused_decode's loaded library during the main path's
    run and records a CUDA event pair around each launch, so the kernels
    line's ``ms`` is the kernel's device time in that run.  A pair that
    finds the card idle also holds the host time of the launch call, from
    the first event to the first kernel's start."""

    def __init__(self, torch, lib):
        self.torch, self.lib, self.events = torch, lib, []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def fused_decode_launch(self, *args):
        start, end = (self.torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        err = self.lib.fused_decode_launch(*args)
        end.record()
        self.events.append((start, end))
        return err

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_engine(torch):
    """Full-width danube, fused vs reference tokens, launches counted."""
    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, ServeConfig
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    model = build(cfg, get_run_config("h2o-danube-1.8b"))
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, PROMPT), generator=g,
                                     device=dev)}
    policy = ft.get_policy("crt3", ber=1e-4, weight_faults=False)
    engines = {b: Engine(model, params, cfg=ServeConfig(max_new_tokens=NEW),
                         policy=policy, ft_backend=b)
               for b in ("fused", "reference")}

    fused = engines["fused"]
    fused.generate(batch, max_new_tokens=0, seed=0)     # warm-up prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused.generate(batch, max_new_tokens=0, seed=0)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    timer, real_lib = LaunchTimer(torch, kernel._lib()), kernel._lib
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
    prof = phase_profile(torch, model, params, batch, policy, toks)
    emit({"phase": "engine", "arch": cfg.name, "layers": cfg.n_layers,
          "params": n_params, "param_dtype": "bfloat16", "batch": B,
          "prompt": PROMPT, "new_tokens": NEW, "policy": "crt3",
          "ber": 1e-4, "init_s": round(init_s, 3),
          "prefill_ms": prefill_ms,
          "decode_tokens_per_s": B * NEW / (total_s - prefill_ms / 1e3),
          "generate_s": total_s, "reference_generate_s": ref_s,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "fused_decode_ms": kernel_ms,
          "tokens_equal": True, "tokens_row0": toks[0].tolist()})
    for name, row in prof.items():
        emit({"phase": "profile", "step": name, **row})
    del engines, fused, params
    torch.cuda.empty_cache()
    return launches, kernel_ms


def _profile(torch, fn):
    """Wall time of ``fn`` and the device time of its kernels, from one run
    under torch.profiler: all kernels, and those of fused_decode."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = kern_us = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.device_time_total
        dev_us += us
        n_kernels += 1
        if "fused_decode_" in e.name:
            kern_us += us
    return {"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
            "fused_decode_ms": kern_us / 1e3, "kernels_launched": n_kernels}


def phase_profile(torch, model, params, batch, policy, toks):
    """Where a prefill and a decode step of the fused engine spend time."""
    from repro_torch.core import prng
    from repro_torch.models.common import FTCtx
    dev = params["embed"].device
    ftc = FTCtx(policy, prng.PRNGKey(0, dev), backend="fused")
    out = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        caches, _ = model.prefill(params, batch, max_len=PROMPT + NEW,
                                  ftc=ftc)
        torch.cuda.synchronize()
        wall = {"prefill": time.perf_counter() - t0}
        out["prefill"] = _profile(torch, lambda: model.prefill(
            params, batch, max_len=PROMPT + NEW, ftc=ftc))
        step = functools.partial(model.decode_step, params, caches,
                                 toks[:, 0], PROMPT, ftc=ftc)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall["decode_step"] = time.perf_counter() - t0
        out["decode_step"] = _profile(torch, step)
    for name, row in out.items():
        row["wall_ms"] = 1e3 * wall[name]
        row["device_busy_share"] = row["device_kernel_ms"] / row["wall_ms"]
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_faults(torch):
    """protect_linear on the card: fused == reference == the CPU, bitwise."""
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
    _, logits = model.prefill(params, batch)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    emit({"phase": "faults", "protect_linear_cases": checked,
          "reduced_engine_tokens_equal": True})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build()
    rows, max_err = phase_kernels(torch)
    launches, kernel_ms = phase_engine(torch)
    phase_faults(torch)

    def total(key):
        return sum(r[key] * r["launches_per_generation"] for r in rows)
    t_bytes = sum(r["launches_per_generation"] * r["bound_ms"]
                  for r in rows if r["bound_by"] == "bytes")
    emit({"kernels": [{
        "name": "fused_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_decode/csrc/fused_decode.cu",
        "replaces": "src/repro/kernels/fused_decode/kernel.py:189",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if t_bytes >= total("bound_ms") / 2
        else "operations",
        "library_ms": total("library_ms"),
        "kernel_phase_ms": total("kernel_ms"),
        "per": f"one generation: {launches} launches (B={B}, prompt "
               f"{PROMPT}, {NEW} new); ms from CUDA events around each "
               "launch of the main path's run; plain_ms, library_ms and "
               "kernel_phase_ms from the kernel phase's per-shape times "
               "x launches",
        "device": name, "nvidia_smi": smi}]})
    print("chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

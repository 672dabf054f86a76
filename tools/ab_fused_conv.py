"""A/B of ``fused_decode`` at the CNN oracle's conv GEMM shapes on the card.

The shapes are those of the reduced VGG (channels 16/32, 16x16 images) under
``CnnOracle`` at its default 384 images: each conv an im2col GEMM, then the
head; plus two of the serving path's shapes.  Each shape runs in the
oracle's modes: global t without a DPPU, and with the DPPU recomputing from
clean weights (``dppu_src="wcl"``, the ``cl`` policy's mode under shared
weight faults).  Each tree's ``repro_torch`` runs in a process of its own,
in the order given, so two versions are compared on one card in one call
(e.g. parent, change, change, parent):

  python tools/ab_fused_conv.py --tree parent=OLD/src --tree change=src \\
      --order parent,change,change,parent

Each run prints one JSON line: the tree, and per shape and mode the kernel's
mean device ms over 20 launches (CUDA events after a warm-up), and whether
its output equals ``fused_ref``'s bitwise.  The last line gives each tree's
median per shape and mode, with the card's name and power limit; the script
fails if any launch differs from the plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (M, K, N): s0_c0, s0_c1, s1_c0, s1_c1, head; then serving decode / prefill
SHAPES = ((98304, 9, 16), (98304, 144, 16), (24576, 144, 32),
          (24576, 288, 32), (384, 512, 8), (4, 2560, 2560),
          (256, 2560, 6912))
MODES = ("none", "wcl")


def worker(label: str, iters: int) -> dict:
    import torch

    from repro_torch.kernels.fused_decode import kernel
    from repro_torch.kernels.fused_decode.ref import fused_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for M, K, N in SHAPES:
        xq = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int8)
        wq, wc = (torch.randint(-128, 128, (K, N), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        flips = [torch.where(torch.rand((M, N), generator=g, device=dev)
                             < 0.05, torch.randint(0, 256, (M, N),
                                                   generator=g, device=dev,
                                                   dtype=torch.int32), 0)
                 .to(torch.int32) for _ in range(2)]
        imp = (torch.rand(N, generator=g, device=dev) < 0.25).to(torch.int32)
        qs = torch.tensor([3], dtype=torch.int32, device=dev)
        for mode in MODES:
            kw = {} if mode == "none" else dict(wq_clean=wc, dflips=flips[1],
                                                imp=imp)

            def call():
                return kernel.fused_decode(xq, wq, flips[0], qs,
                                           dppu_src=mode, **kw)
            y, t = call()
            yr, tr = fused_ref(xq, wq, flips[0], qs.reshape(()), **kw)
            equal = bool(torch.equal(y.to(torch.int32), yr)
                         and int(t[0, 0]) == int(tr))
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
            torch.cuda._sleep(100_000_000)
            for s, e in ev:
                s.record()
                call()
                e.record()
            torch.cuda.synchronize()
            ms = sum(s.elapsed_time(e) for s, e in ev) / iters
            rows.append({"shape": [M, K, N], "dppu_src": mode, "ms": ms,
                         "equal_plain": equal})
    return {"tree": label, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=SRC_DIR, the directory holding repro_torch")
    ap.add_argument("--order", default="",
                    help="comma-separated labels, one run each")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.iters)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = []
    for label in args.order.split(","):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(trees[label]))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", label,
             "--iters", str(args.iters)], env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        runs.append(row)
    bad = [(r["tree"], x["shape"], x["dppu_src"]) for r in runs
           for x in r["rows"] if not x["equal_plain"]]
    med = {label: {f"{x['shape']} {x['dppu_src']}": statistics.median(
        y["ms"] for r in runs if r["tree"] == label for y in r["rows"]
        if y["shape"] == x["shape"] and y["dppu_src"] == x["dppu_src"])
        for x in runs[0]["rows"]} for label in trees}
    print(json.dumps({"nvidia_smi": smi, "median_ms": med}))
    if bad:
        print(f"ab_fused_conv: differs from fused_ref: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

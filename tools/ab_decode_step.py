"""A/B of the port's eager (python-loop) decode step on the card.

Full-width h2o-danube-1.8b with random bf16 weights from a seed, B=4, a
64-token prompt, crt3 at BER 1e-4 on the fused backend, as chip_smoke.py's
engine phase.  Each tree's ``repro_torch`` runs in a process of its own, in
the order given, so two versions are compared on one card in one call
(e.g. parent, change, change, parent):

  python tools/ab_decode_step.py --tree parent=OLD/src --tree change=src \\
      --order parent,change,change,parent [--steps 8]

Each run prints one JSON line: the tree, the wall ms of each decode step
(each synchronized; step 0, the warm-up, is left out of the median), their
median, the tokens, and the card's name and power limit.  The last line
gives each tree's median over its runs; the script fails if the trees'
tokens differ.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

B, PROMPT = 4, 64


def worker(label: str, steps: int) -> dict:
    import torch

    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.core import prng
    from repro_torch.models import build
    from repro_torch.models.common import FTCtx
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    model = build(cfg, get_run_config("h2o-danube-1.8b"))
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, PROMPT), generator=g, device=dev)
    policy = ft.get_policy("crt3", ber=1e-4, weight_faults=False)
    key = prng.PRNGKey(0, device=dev)
    ms, out = [], []
    with torch.no_grad():
        caches, logits = model.prefill(
            params, {"tokens": tokens}, max_len=PROMPT + steps + 1,
            ftc=FTCtx(policy, key, backend="fused"))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caches, logits = model.decode_step(
                params, caches, tok, PROMPT + i,
                ftc=FTCtx(policy, prng.fold_in(key, i + 1), backend="fused"))
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append(tok.tolist())
    return {"tree": label, "step_ms": ms,
            "median_ms": statistics.median(ms[1:]), "tokens": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=SRC_DIR, the directory holding repro_torch")
    ap.add_argument("--order", default="",
                    help="comma-separated labels, one run each")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps)))
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
             "--steps", str(args.steps)], env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["nvidia_smi"] = smi
        print(json.dumps(row), flush=True)
        runs.append(row)
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        print("ab_decode_step: the trees' tokens differ", file=sys.stderr)
        return 1
    print(json.dumps({"nvidia_smi": smi, "median_ms": {
        label: statistics.median(r["median_ms"] for r in runs
                                 if r["tree"] == label)
        for label in trees}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

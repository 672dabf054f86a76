"""Serve a small LM with the PyTorch port while the substrate injects soft
errors, and watch a ``repro_torch.ft`` protection policy keep generations
stable.

  PYTHONPATH=src python examples/torch_fault_tolerant_serving.py [--device cpu]

The port's counterpart of examples/fault_tolerant_serving.py, step for
step.  The serving engine takes a protection policy directly: every
projection of prefill and decode then computes through the faulty
quantized DLA path with that policy's cross-layer protection applied.  The
decode loop is one static step (``Engine(loop="scan")``, the default),
captured once as a CUDA graph on the GPU and replayed per token (eager on
the CPU); the final section serves a small request queue through the
continuous-batching scheduler with per-request fault streams.

Runs on the GPU unless ``--device cpu`` is given; with no GPU and no such
request it raises.  The weights are drawn from ``torch.Generator``, so the
tokens are not the reference example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import device as _device  # noqa: E402
from repro_torch import ft  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    serve_cfg = ServeConfig(max_new_tokens=8)
    engine = Engine(model, params, cfg=serve_cfg)

    g = torch.Generator(device=dev).manual_seed(1)
    prompts = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g,
                                       device=dev)}
    clean = engine.generate(prompts)
    print("clean generations:\n", clean.cpu().numpy())

    # Same engine, same weights, but the DLA substrate now flips bits at
    # BER: compare the unprotected design against circuit-level TMR of the
    # top-3 output bits (both straight from the policy registry).
    ber = 2e-3
    for name in ("base", "crt3"):
        policy = ft.get_policy(name, ber=ber, weight_faults=False)
        faulty = Engine(model, params, cfg=serve_cfg, policy=policy)
        gen = faulty.generate(prompts)
        agree = float((gen == clean).float().mean())
        print(f"BER {ber:g} under {name!r}: "
              f"token agreement with clean = {agree:.2f}")

    print("\n(the cross-layer 'cl' policy additionally recomputes "
          "important channels on the DPPU: feed Algorithm-1 masks through "
          "FTCtx(masks=...); see examples/torch_crosslayer_dse.py)")

    # Continuous batching: a queue of requests through a fixed slot pool,
    # each with its own fault-key stream (alone or crowded, a request's
    # generation is bit-identical: per-request reliability accounting).
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    sched = Scheduler(model, params,
                      SchedulerConfig(max_batch=2, buckets=(8, 16),
                                      max_new_tokens=8, decode_chunk=4),
                      policy=ft.get_policy("crt3", ber=ber,
                                           weight_faults=False))
    toks = prompts["tokens"].cpu()
    reqs = [Request(rid=i, tokens=toks[i % 2][:8 + 4 * (i % 2)].tolist(),
                    max_new_tokens=8) for i in range(4)]
    done = sched.run(reqs)
    for i in sorted(done):
        r = done[i]
        print(f"request {i}: {r.generated} ({r.finish_reason}; "
              f"{len(r.generated)} tokens)")
    print(f"scheduler roundtrips: {sched.stats.roundtrips} for "
          f"{sched.stats.tokens} tokens across {len(reqs)} requests")


if __name__ == "__main__":
    main()

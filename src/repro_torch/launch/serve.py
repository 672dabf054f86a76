"""Serving launcher of the port: batched greedy generation on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      [--smoke] [--batch 4] [--prompt-len 64] [--new 16] \
      [--loop scan|python] [--policy crt3 --ber 1e-4 [--weight-faults]] \
      [--device cpu]

Counterpart of ``repro.launch.serve`` (no mesh) on the fused backend.
``--arch`` takes any architecture the port registers
(``repro_torch.configs.ARCHS``): the dense decoders, the MoE models
(qwen3-moe-235b-a22b, dbrx-132b), mamba2-2.7b, recurrentgemma-9b,
paligemma-3b (fed zero ``patch_embeds``) and seamless-m4t-medium (fed zero
``frames`` of the prompt's length), as the reference's launcher feeds
them.
``--loop scan`` (the default, as the reference's) replays each decode step
as a CUDA graph on the card; ``--loop python`` runs one step per host
round trip.  The weights and prompts are random, from fixed seeds;
``--smoke`` serves the reduced config.  Weight faults are off unless asked
for: at full width their eager draws take minutes per token (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--loop", choices=("scan", "python"), default="scan",
                    help="graph-replayed decode steps (default) or the "
                         "per-token dispatch loop")
    ap.add_argument("--policy", default=None,
                    help="registry policy name (e.g. crt3, cl)")
    ap.add_argument("--ber", type=float, default=1e-4)
    ap.add_argument("--weight-faults", action="store_true",
                    help="also inject weight faults (slow at full width)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import device as _device
    from repro_torch import ft
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch, reduced=args.smoke)
    model = build(cfg, get_run_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev)
    policy = None
    if args.policy:
        policy = ft.get_policy(args.policy, ber=args.ber,
                               weight_faults=args.weight_faults)
    engine = Engine(model, params, cfg=ServeConfig(max_new_tokens=args.new,
                                                   loop=args.loop),
                    policy=policy, ft_backend="fused")
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros(
            (args.batch, cfg.n_frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    if cfg.enc_dec:
        batch["frames"] = torch.zeros(
            (args.batch, args.prompt_len, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    t0 = time.perf_counter()
    out = engine.generate(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape[1]} tokens for {out.shape[0]} requests in "
          f"{engine.stats.roundtrips} host roundtrips ({args.loop} loop), "
          f"{dt:.3f} s on {dev}")
    print(out.cpu())
    return out


if __name__ == "__main__":
    main()

"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --shape train_4k [--steps N] [--ckpt DIR] [--smoke] [--device cpu]

Counterpart of ``repro.launch.train`` on one device: ``--smoke`` trains the
reduced config at a tiny shape (64 positions, 8 rows), any architecture the
port registers, with its ``RUN``'s grad_accum and Adam dtype; the vision
and encoder-decoder families draw their ``patch_embeds`` / ``frames`` in
bfloat16 (``make_batch``); ``--device`` is ``cuda`` unless ``cpu`` is
asked.  The reference's ``--multi-pod`` and ``--distributed`` come with the
port's parallel layer (ROADMAP.md, queue A, item 6).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, tiny shape")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch, reduced=args.smoke)
    run = get_run_config(args.arch)
    model = build(cfg, run)
    shape = (ShapeConfig("smoke", "train", 64, 8) if args.smoke
             else SHAPES[args.shape])
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                       ckpt_every=max(args.steps // 4, 1), log_every=10)
    trainer = Trainer(model, shape, AdamWConfig(dtype=run.adam_dtype), tc,
                      device=args.device)
    _, step = trainer.run()
    print(f"finished at step {step}; stragglers: {trainer.straggler_events}")


if __name__ == "__main__":
    main()

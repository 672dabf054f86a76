"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --shape train_4k [--steps N] [--ckpt DIR] [--smoke] [--device cpu] \
      [--distributed] [--multi-pod]
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 1 \
      -m repro_torch.launch.train --arch h2o-danube-1.8b --smoke \
      --distributed --steps 2

Counterpart of ``repro.launch.train``: ``--smoke`` trains the reduced
config at a tiny shape (64 positions, 8 rows), any architecture the port
registers, with its ``RUN``'s grad_accum and Adam dtype, on the one-rank
(1, 1) mesh (``make_local_mesh``) where the process group has one rank;
the vision and encoder-decoder families draw their ``patch_embeds`` /
``frames`` in bfloat16 (``make_batch``).  Without ``--smoke`` it trains
the full config on the production mesh, (data, model) = (16, 16), with
'pod' in front under ``--multi-pod``.  ``--distributed`` joins the process
group ``torchrun`` describes (``init_process_group`` from its environment:
NCCL on the card, gloo on the CPU), one process per card.  ``--device`` is
``cuda`` unless ``cpu`` is asked.
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group of torchrun's environment")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import (backend_of, make_local_mesh,
                                         make_production_mesh)
    device = args.device
    if args.distributed:
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend_of(device))

    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch, reduced=args.smoke)
    run = get_run_config(args.arch)
    model = build(cfg, run)
    if args.smoke:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_local_mesh(device) if world == 1 else None
        shape = ShapeConfig("smoke", "train", 64, 8)
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
        shape = SHAPES[args.shape]
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                       ckpt_every=max(args.steps // 4, 1), log_every=10)
    trainer = Trainer(model, shape, AdamWConfig(dtype=run.adam_dtype), tc,
                      mesh=mesh, device=device)
    _, step = trainer.run()
    axes = (None if mesh is None
            else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    print(f"finished at step {step}; stragglers: {trainer.straggler_events}"
          f"; mesh: {axes}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

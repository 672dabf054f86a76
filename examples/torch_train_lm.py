"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps on the synthetic pipeline, with checkpoint/restart and
straggler accounting.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
      [--d-model 512] [--device cpu]

The port's counterpart of examples/train_lm.py: an h2o-danube-family
model scaled to ~100M parameters, trained by ``repro_torch.train.Trainer``.
Runs on the GPU unless ``--device cpu`` is given; with no GPU and no such
request it raises.  For a mesh see repro_torch/launch/train.py.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import device as _device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    base = get_config("h2o-danube-1.8b")
    cfg = dataclasses.replace(
        base, name="danube-100m", n_layers=args.layers,
        d_model=args.d_model, n_heads=8, n_kv_heads=4,
        d_head=args.d_model // 8, d_ff=args.d_model * 3, vocab=8192,
        window=args.seq // 2, unroll=False)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))

    n = sum(p.numel() for p in leaves(model.param_specs()))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    shape = ShapeConfig("train", "train", args.seq, args.batch)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=100,
                       ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(model, shape,
                      AdamWConfig(lr=6e-3, warmup_steps=20,
                                  decay_steps=args.steps), tc, device=dev)
    state, step = trainer.run()
    losses = [r["loss"] for r in trainer.metrics_log]
    print(f"done at step {step}: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers observed: {trainer.straggler_events}")
    trainer.save_metrics(os.path.join(args.ckpt_dir, "metrics.jsonl"))


if __name__ == "__main__":
    main()

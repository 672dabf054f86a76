"""Training loop with step-atomic checkpoints, fault-aware training and
straggler detection.

Counterpart of ``repro.train.trainer``:

- step-atomic checkpoints (async write) and resume from the latest, with
  the data iterator's state;
- fault-aware training (FAT): ``TrainerConfig.fat_policy`` threads the
  protection stack through the forward (``make_train_step(policy=...)``,
  every site one ``fused_decode`` launch on the card);
  the fault keys fold from the step counter the checkpoint restores, so a
  resumed run continues the exact fault stream;
- straggler mitigation: a step slower than ``straggler_factor`` x the
  median of a bounded window of recent step times is logged and counted;
  after ``straggler_patience`` slow steps in a row the trainer writes a
  checkpoint.  The first step of every run (kernel builds and warm-up) is
  kept out of the window;
- a mesh (``mesh=``, a DeviceMesh): every rank runs the Trainer on the same
  data stream; the state rests in the FSDP x TP layout
  (``train_step.state_shardings``) and checkpoints hold the whole logical
  shapes (the mesh's first rank writes them);
- elastic re-mesh: after (simulated) rank loss, ``handle_device_loss``
  closes the loop: plan the rescale, form the survivors' mesh, scale
  grad_accum to keep the global batch, restore the latest committed
  checkpoint onto the new shardings with its data position, and hand back
  (state, step) for ``run`` (``repro_torch.train.elastic``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import device as _device
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig, LMIterator
from repro_torch.optim import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import (init_state, make_train_step,
                                         shard_state, state_shardings)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_async: bool = True
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    straggler_window: int = 64   # step-time samples the median is taken over
    seed: int = 0
    # ---- fault-aware training (FAT) schedule ----
    fat_policy: object = None       # policy or registry name (None = clean)
    fat_ber: float = 0.0            # target training BER at end of ramp
    fat_ramp: int = 0               # linear 0 -> fat_ber over this many steps
    fat_seed: int = 17              # root of the training fault-key stream


class _RunningMedian:
    """Median over a bounded window of recent samples: a deque in arrival
    order and a sorted list, one ``insort`` and (once full) one ``bisect``
    removal per sample."""

    def __init__(self, window: int):
        self.window = max(int(window), 1)
        self._fifo: collections.deque = collections.deque()
        self._sorted: list[float] = []

    def add(self, x: float) -> None:
        self._fifo.append(x)
        bisect.insort(self._sorted, x)
        if len(self._fifo) > self.window:
            old = self._fifo.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]

    def __len__(self) -> int:
        return len(self._fifo)

    @property
    def median(self) -> float:
        return self._sorted[len(self._sorted) // 2]


class Trainer:
    """Trains ``model`` on the LM stream of ``shape`` on ``device`` (default
    the GPU)."""

    def __init__(self, model, shape, opt_cfg: AdamWConfig | None = None,
                 cfg: TrainerConfig | None = None, mesh=None,
                 data_cfg: DataConfig | None = None, delay_hook=None,
                 device=None):
        self.model, self.shape = model, shape
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.cfg = cfg or TrainerConfig()
        self.device = _device.resolve(device)
        self.delay_hook = delay_hook  # tests inject artificial stragglers
        self.data = LMIterator(model.cfg, shape, data_cfg,
                               device=self.device)
        self.mesh = mesh
        self._build_step()
        self.metrics_log: list[dict] = []
        self.straggler_events = 0
        self._slow_streak = 0

    def _build_step(self):
        c = self.cfg
        fat = {}
        if c.fat_policy is not None:
            fat = dict(policy=c.fat_policy, ft_ber=c.fat_ber,
                       ft_key=prng.PRNGKey(c.fat_seed, self.device),
                       fat_ramp=c.fat_ramp, ft_backend="fused")
        self.step_fn = make_train_step(self.model, self.opt_cfg,
                                       mesh=self.mesh, **fat)
        self.specs = (None if self.mesh is None
                      else state_shardings(self.state_like(), self.mesh))

    # ------------------------------------------------------------ state ---
    def state_like(self) -> dict:
        """The train state's structure and dtypes, on the meta device."""
        return init_state(self.model, torch.Generator(), self.opt_cfg,
                          device="meta")

    def init_or_restore(self):
        """The latest committed checkpoint's (state, step), its data
        position restored; or a fresh state at step 0."""
        state, step, dstate = ckpt.restore(self.cfg.ckpt_dir,
                                           self.state_like(),
                                           device=self.device,
                                           shardings=self.specs,
                                           mesh=self.mesh)
        if state is None:
            g = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
            state = init_state(self.model, g, self.opt_cfg, self.device)
            if self.mesh is not None:
                state = shard_state(state, self.mesh, self.specs)
            return state, 0
        self.data.restore(dstate)
        return state, int(step)

    # ---------------------------------------------------------- elastic ---
    def handle_device_loss(self, surviving):
        """Close the elastic loop after losing ranks: plan -> re-mesh ->
        restore the latest committed checkpoint -> ready to continue.

        ``surviving`` is the list of live global ranks (or their count: the
        first N of the old mesh).  The global batch is preserved by scaling
        ``grad_accum`` by the plan's factor; the step is rebuilt for the new
        mesh (the same FAT schedule: the restored step counter keeps the
        fault stream on its coordinate).  Returns ``(state, step)`` for
        :meth:`run`; a rank outside the new mesh gets ``(None, step)`` and
        leaves (``self.mesh`` is then None)."""
        from repro_torch.train import elastic

        if self.mesh is None:
            raise ValueError("elastic rescale needs a mesh-backed trainer")
        ranks = (list(surviving) if not isinstance(surviving, int)
                 else elastic.simulate_device_loss(
                     self.mesh, self.mesh.mesh.numel() - surviving))
        model_axis = self.mesh.size(self.mesh.mesh_dim_names.index("model"))
        plan = elastic.plan_rescale(self.mesh, len(ranks), model_axis)
        self.mesh = elastic.survivor_mesh(plan, model_axis, ranks,
                                          self.device.type)
        if plan.grad_accum_scale != 1:
            run2 = dataclasses.replace(
                self.model.run,
                grad_accum=self.model.run.grad_accum * plan.grad_accum_scale)
            self.model = dataclasses.replace(self.model, run=run2)
        if self.mesh is None:
            return None, ckpt.available_steps(self.cfg.ckpt_dir)[-1]
        self._build_step()
        state, step, dstate, _ = elastic.remesh_restore(
            self.cfg.ckpt_dir, self.state_like(), self.mesh,
            device=self.device)
        self.data.restore(dstate)
        return state, int(step)

    # ------------------------------------------------------------- loop ---
    def run(self, state=None, start_step: int | None = None):
        if state is None:
            state, start_step = self.init_or_restore()
        step = start_step or 0
        med = _RunningMedian(self.cfg.straggler_window)
        first = True          # the first step of a run builds and warms up
        waiter = None
        while step < self.cfg.total_steps:
            batch = next(self.data)
            t0 = time.monotonic()
            if self.delay_hook is not None:
                self.delay_hook(step)
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the device
            dt = time.monotonic() - t0
            is_straggler = (not first and len(med) >= 5
                            and dt > self.cfg.straggler_factor * med.median)
            if first:
                first = False
            else:
                med.add(dt)
            if is_straggler:
                self.straggler_events += 1
                self._slow_streak += 1
            else:
                self._slow_streak = 0
            step += 1
            row = {"step": step, "loss": loss, "sec": dt,
                   "straggler": is_straggler,
                   "grad_norm": float(metrics["grad_norm"])}
            if "fat_ber" in metrics:
                row["fat_ber"] = float(metrics["fat_ber"])
            self.metrics_log.append(row)
            if step % self.cfg.log_every == 0:
                print(json.dumps(row))
            must_ckpt = (step % self.cfg.ckpt_every == 0
                         or step == self.cfg.total_steps
                         or self._slow_streak >= self.cfg.straggler_patience)
            if must_ckpt:
                if waiter is not None:
                    waiter.join()   # one writer in flight at most
                waiter = ckpt.save(self.cfg.ckpt_dir, state, step,
                                   data_state=self.data.state(),
                                   keep=self.cfg.keep,
                                   async_write=self.cfg.ckpt_async,
                                   shardings=self.specs, mesh=self.mesh)
                self._slow_streak = 0
        if waiter is not None:
            waiter.join()
        return state, step

    def save_metrics(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for row in self.metrics_log:
                f.write(json.dumps(row) + "\n")

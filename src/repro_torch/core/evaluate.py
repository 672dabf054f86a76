"""Accuracy-under-fault oracles: the models connected to the FT stack.

Counterpart of ``repro.core.evaluate`` (``CnnOracle``, ``trained_cnn``).
These drive the paper's experiments: layer sensitivity (Fig. 5/6),
strategy comparison (Fig. 7) and the Bayesian DSE's accuracy oracle.

The reference runs its ``n_rep`` fault draws, and in ``accuracy_batch``
also its candidates, as lanes of one vmapped executable, a device of JAX's
compile cache.  Here every lane is one forward: on the ``fused`` backend
(the default) each conv and the head under a policy is one hand-written
``fused_decode`` launch.  The numbers are the reference's lane for lane:
``accuracy_batch`` runs each candidate as the reference's batch lanes do,
on its canonical structure (``_batch_canon``) with ``ib_th`` / ``nb_th`` /
``q_scale`` handed to the datapath through ``FTCtx.dyn``, and equals
``accuracy``, which equals ``_accuracy_looped`` (the datapath is integer).

Importance masks are keyed by the probe's tap names (``"{site}/out"``)
while ``linear`` looks a site's mask up by the site name, in the reference
as here, so no mask reaches a CNN's datapath (the recompute policies run
without a DPPU); the port keeps that, as it is held to the reference.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from repro_torch import device as _device
from repro_torch.core import prng
from repro_torch.core.importance import ImportanceResult, neuron_importance
from repro_torch.data.pipeline import vision_batch
from repro_torch.ft import ProtectionPolicy, as_policy, get_policy
from repro_torch.ft.policy import AlgorithmLayer, ArchLayer, CircuitLayer
from repro_torch.models.cnn import CNNConfig, accuracy, apply_cnn, xent_loss
from repro_torch.models.common import FTCtx


def _batch_canon(pol: ProtectionPolicy) -> ProtectionPolicy:
    """Canonical structure of a policy for cross-candidate batching: keep
    the fields that change the datapath's control flow (recompute / TMR
    flags, weight_faults), zero the ones that ride the batch axis or never
    enter the accuracy datapath (dot_size / data_reuse / pe_policy feed the
    area and perf oracles only)."""
    return ProtectionPolicy(
        name="",
        algorithm=AlgorithmLayer(),
        arch=ArchLayer(recompute=pol.arch.recompute,
                       whole_layer_tmr=pol.arch.whole_layer_tmr,
                       temporal=pol.arch.temporal),
        circuit=CircuitLayer(),
        ber=0.0, weight_faults=pol.weight_faults, seed=0)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@dataclasses.dataclass
class CnnOracle:
    """Fault-injection evaluation for a trained CNN, on ``device`` (default
    the GPU; its parameters move there)."""
    params: dict
    cfg: CNNConfig
    n_eval: int = 384
    n_rep: int = 3              # fault-draw repetitions averaged
    data_seed: int = 99
    # Evaluation-set difficulty: 1.6 holds clean accuracy near 0.98, where
    # faults visibly bite (see repro.core.evaluate.CnnOracle).  Must match
    # the train_cnn default so the oracle evaluates in-distribution.
    noise: float = 1.6
    backend: str = "fused"      # protect_linear backend of every site
    device: object = None

    def __post_init__(self):
        self.device = _device.resolve(self.device)
        self.params = _to(self.params, self.device)
        self._imgs, self._labels = vision_batch(
            prng.PRNGKey(7, self.device), self.n_eval, self.cfg.n_classes,
            self.cfg.hw, noise=self.noise, seed=self.data_seed)
        self._imp: ImportanceResult | None = None
        self._sens_cache: dict = {}

    # ---- Algorithm 1 ---------------------------------------------------
    def importance(self) -> ImportanceResult:
        if self._imp is None:
            batches = [
                vision_batch(prng.PRNGKey(i, self.device), 64,
                             self.cfg.n_classes, self.cfg.hw,
                             noise=self.noise, seed=self.data_seed)
                for i in range(4)]

            def apply_fn(params, batch, probe):
                return apply_cnn(params, self.cfg, batch[0], probe=probe)
            self._imp = neuron_importance(
                apply_fn, self.params, batches,
                lambda out, batch: xent_loss(out, batch[1]))
        return self._imp

    def masks(self, s_th: float, policy: str = "uniform"):
        return self.importance().select(s_th, policy)

    # ---- accuracy under fault ------------------------------------------
    def _rep_keys(self, seed: int) -> list[torch.Tensor]:
        return [prng.PRNGKey(seed * 97 + r, self.device)
                for r in range(self.n_rep)]

    @torch.no_grad()
    def _clean(self) -> float:
        logits = apply_cnn(self.params, self.cfg, self._imgs)
        return float(accuracy(logits, self._labels))

    @torch.no_grad()
    def _lane(self, pol, key, masks, protected_layers, dyn=None) -> float:
        """One fault draw: the accuracy of one forward under ``pol``."""
        ftc = FTCtx(pol, key, masks, protected_layers, backend=self.backend,
                    dyn=dyn)
        logits = apply_cnn(self.params, self.cfg, self._imgs, ftc=ftc)
        return float(accuracy(logits, self._labels))

    def accuracy(self, ft: ProtectionPolicy | None, masks=None,
                 protected_layers=None, seed: int = 0) -> float:
        """`ft`: a ProtectionPolicy, a registered policy name, a legacy
        FTConfig, or None for the clean model.  The mean over ``n_rep``
        fault draws, one forward each."""
        pol = as_policy(ft)
        if pol is None or pol.ber == 0:
            return self._clean()
        if masks is None and pol.uses_importance:
            masks = self.masks(pol.algorithm.s_th, pol.algorithm.s_policy)
        accs = [self._lane(pol, key, masks, protected_layers)
                for key in self._rep_keys(seed)]
        return sum(accs) / len(accs)

    def _accuracy_looped(self, ft, masks=None, protected_layers=None,
                         seed: int = 0) -> float:
        """The reference's ground truth of the batched paths, kept under its
        name: one forward per fault draw, as ``accuracy``."""
        return self.accuracy(ft, masks, protected_layers, seed)

    def accuracy_batch(self, fts, protected_layers=None,
                       seed: int = 0) -> list[float]:
        """Accuracy under fault for a batch of candidate policies.

        Each candidate runs on its canonical structure (``_batch_canon``)
        with its ``ber``, its ``ib_th`` / ``nb_th`` / ``q_scale`` through
        ``FTCtx.dyn`` and its own importance masks, one forward per
        (candidate, fault draw) lane; per-candidate results equal
        ``accuracy``."""
        pols = [as_policy(f) for f in fts]
        out: list[float | None] = [None] * len(pols)
        clean = [i for i, p in enumerate(pols) if p is None or p.ber == 0]
        if clean:
            v = self.accuracy(None)
            for i in clean:
                out[i] = v
        keys = self._rep_keys(seed)
        for i, p in enumerate(pols):
            if out[i] is not None:
                continue
            canon = _batch_canon(p).with_ber(p.ber)
            dyn = {"ib_th": p.circuit.ib_th, "nb_th": p.circuit.nb_th,
                   "q_scale": p.algorithm.q_scale}
            masks = (self.masks(p.algorithm.s_th, p.algorithm.s_policy)
                     if p.uses_importance else None)
            reps = [self._lane(canon, key, masks, protected_layers, dyn)
                    for key in keys]
            out[i] = sum(reps) / len(reps)
        return out  # type: ignore[return-value]

    def layer_names(self) -> list[str]:
        drop = {"head"}
        return [k for k in self.params if k not in drop]

    # ---- Fig. 5: per-layer sensitivity ---------------------------------
    def layer_sensitivity(self, ber: float, seed: int = 0) -> dict[str, float]:
        """Accuracy gain from fully protecting one layer vs none protected.

        Memoized in ``_sens_cache`` on everything the measurement depends
        on, ``(ber, seed, n_rep)`` (``n_rep`` is mutable oracle state).
        ``protected_layers`` is not part of the key: every entry uses the
        one-layer protection sets this method itself chooses."""
        key = (ber, seed, self.n_rep)
        if key in self._sens_cache:
            return self._sens_cache[key]
        base_ft = get_policy("arch", ber=ber)
        none = self.accuracy(base_ft, protected_layers=set(), seed=seed)
        out = {}
        for name in self.layer_names():
            a = self.accuracy(base_ft, protected_layers={name}, seed=seed)
            out[name] = a - none
        self._sens_cache[key] = out
        return out

    # ---- Fig. 6: cumulative protection curve ----------------------------
    def cumulative_protection(self, ber: float, seed: int = 0):
        sens = self.layer_sensitivity(ber, seed)
        order = sorted(sens, key=sens.get, reverse=True)
        ft = get_policy("arch", ber=ber)
        curve = [("none", self.accuracy(ft, protected_layers=set(),
                                        seed=seed))]
        prot: set = set()
        for name in order:
            prot.add(name)
            curve.append((name, self.accuracy(ft, protected_layers=set(prot),
                                              seed=seed)))
        return curve


@lru_cache(maxsize=4)
def trained_cnn(arch: str = "vgg", steps: int = 250, device=None
                ) -> CnnOracle:
    """Train (or fetch cached) the reduced paper benchmark CNN on
    ``device`` (default the GPU): key ``PRNGKey(0)`` for the data stream,
    as the reference's (the initial weights are the port's own draws)."""
    from repro_torch.models.cnn import train_cnn
    dev = _device.resolve(device)
    cfg = CNNConfig(arch=arch)
    params, acc = train_cnn(prng.PRNGKey(0, dev), cfg, steps=steps)
    o = CnnOracle(params, cfg, device=dev)
    o.clean_acc = acc
    return o

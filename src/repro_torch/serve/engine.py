"""Batched serving engine: prefill, then decode one token per step, greedy
or at a temperature.

Counterpart of ``repro.serve.engine`` with ``loop="python"``: one prefill
and one decode step per new token, so a generation costs ``1 + n_new`` host
round trips.  Pass a protection policy (object or registry name) and every
projection of prefill and decode computes through the faulty-DLA path:
``ft_backend="fused"`` on the hand-written ``fused_decode`` kernel,
``ft_backend="pallas"`` on the hand-written ``protected_mm`` kernel with
calibrated truncation LSBs ``ft_t``.

The key schedule is the reference's, so the port draws the same faults:
``_call_key`` folds the call index into the config seed (unless a key or
seed pins the call) and splits it into ``ftkey`` and ``skey``; prefill draws
from ``ftkey``, decode step ``i`` from ``fold_in(ftkey, i + 1)``.  At a
temperature above 0 the first token is ``categorical(skey, logits / T)``
with one key for the whole batch, and ``skey = fold_in(skey, i)`` before
step ``i``'s sample (``repro_torch.core.prng.categorical``, jax's Gumbel max
on the port's threefry).

Not ported yet (ROADMAP.md): ``loop="scan"``, whose torch counterpart is a
CUDA-graph capture of the decode step; device meshes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng

LOOPS = ("python",)           # "scan" is not ported (ROADMAP.md)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0
    seed: int = 0
    loop: str = "python"


@dataclasses.dataclass
class ServeStats:
    """Host-dispatch accounting for the last ``generate`` call: one round
    trip for the prefill and one per decode step."""
    roundtrips: int = 0
    tokens: int = 0


class Engine:
    def __init__(self, model, params, cfg: ServeConfig | None = None,
                 policy=None, ft_backend: str = "reference", ft_t=None,
                 loop: str | None = None):
        """``policy``: a protection policy (or registry name) applied to
        every projection; ``ft_backend``: "reference", "fused" or "pallas".
        For "pallas", ``ft_t`` carries the calibrated truncation LSB(s): one
        int or a ``{site: int}`` table (``repro_torch.ft.calibrate_t``); a
        site without one raises, the Engine never calibrates behind the
        caller's back.  Runs on the device the parameters are on."""
        from repro_torch.ft import as_policy
        self.model, self.params = model, params
        self.cfg = cfg or ServeConfig()
        self.loop = loop or self.cfg.loop
        if self.loop == "scan":
            raise NotImplementedError(
                "loop='scan' is not ported: its torch counterpart, a CUDA "
                "graph of the decode step, is queued in ROADMAP.md")
        if self.loop not in LOOPS:
            raise ValueError(f"unknown loop {self.loop!r}; expected {LOOPS}")
        self.policy = as_policy(policy)
        self.ft_backend = ft_backend
        self.ft_t = ft_t
        self.device = params["embed"].device
        self.stats = ServeStats()
        self._n_calls = 0

    def _ftc(self, ftkey):
        if self.policy is None:
            return None
        from repro_torch.models.common import FTCtx
        return FTCtx(self.policy, ftkey, backend=self.ft_backend,
                     t=self.ft_t)

    def _sample(self, logits, key):
        temperature = self.cfg.temperature
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # a true division, as the reference's eager one: a CUDA tensor
        # divided by a Python number is multiplied by its reciprocal
        t = torch.full((), temperature, dtype=torch.float32,
                       device=logits.device)
        return prng.categorical(key, logits / t).to(torch.int32)

    # ------------------------------------------------------------ keys -----
    def _call_key(self, key, seed):
        """Per-call base key: the call index folded into the config seed, or
        the call pinned by ``key=`` / ``seed=``.  Returns (ftkey, skey)."""
        if key is not None and seed is not None:
            raise ValueError("pass at most one of key= / seed=")
        if key is None:
            key = prng.PRNGKey(self.cfg.seed if seed is None else seed,
                               device=self.device)
            if seed is None:
                key = prng.fold_in(key, self._n_calls)
        self._n_calls += 1
        ks = prng.split(prng.as_key(key, self.device))
        return ks[0], ks[1]

    # -------------------------------------------------------- generation ---
    @torch.no_grad()
    def generate(self, batch, max_new_tokens: int | None = None, *,
                 key=None, seed: int | None = None) -> torch.Tensor:
        """batch: {"tokens": (B, S) int tensor}.  Returns (B, new) int32
        tokens on the engine's device."""
        n_new = (self.cfg.max_new_tokens if max_new_tokens is None
                 else max_new_tokens)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        batch = {"tokens": tokens}
        prompt_len = tokens.shape[1]
        ftkey, skey = self._call_key(key, seed)
        caches, logits = self.model.prefill(self.params, batch,
                                            max_len=prompt_len + n_new,
                                            ftc=self._ftc(ftkey))
        tok = self._sample(logits, skey)
        if n_new == 0:                       # prefill-only probe
            self.stats = ServeStats(roundtrips=1, tokens=0)
            return torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                               device=self.device)
        out = []
        for i in range(n_new):
            out.append(tok)
            caches, logits = self.model.decode_step(
                self.params, caches, tok, prompt_len + i,
                ftc=self._ftc(prng.fold_in(ftkey, i + 1)))
            skey = prng.fold_in(skey, i)     # the reference's sampling stream
            tok = self._sample(logits, skey)
        out = torch.stack(out, dim=1)
        self.stats = ServeStats(roundtrips=1 + n_new, tokens=out.numel())
        return out

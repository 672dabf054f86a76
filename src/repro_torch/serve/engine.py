"""Batched serving engine: prefill, then decode one token per step, greedy
or at a temperature.

Counterpart of ``repro.serve.engine``, with its two decode loops:

  * ``loop="scan"`` (the default, as in the reference): the reference runs
    the whole decode loop as one compiled ``lax.scan``; here one decode
    step is a ``serve.graphs.StepGraph``, captured once as a CUDA graph on
    the card and replayed per token (run eagerly on the CPU).  Step ``i``
    reads the step index, the position ``pos0 + i``, the fault key
    ``fold_in(ftkey, i + 1)`` and the sampling key from static device
    buffers, so a generation costs 2 host round trips (the prefill and
    the loop), as ``ServeStats`` counts them;
  * ``loop="python"``: one prefill and one decode step per new token,
    ``1 + n_new`` round trips.

Pass a protection policy (object or registry name) and every projection of
prefill and decode computes through the faulty-DLA path:
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
on the port's threefry).  The first token's division is eager in both
loops; the scan's later samples take ``logits * (1 / T)``, the product the
reference's compiler makes of its division by a constant, and the python
loop's divide, so the two loops sample alike only at temperature 0, as in
the reference.

The scan keeps one set of static caches and one graph, for the shape of
the last prefill's caches (the batch, the capacity of full-attention
layers, the recurrent state rows of R and S layers, and an
encoder-decoder's cross-attention keys and values, as long as its
encoder's input; decode attends to all of them): each generation
copies its prefill's caches into them, and a new shape frees them and
captures a new graph, so a server holds one set whatever the prompts it
sees.

Works on a mesh (``mesh=``, a ``DeviceMesh`` with dims ('data', 'model'), or
('pod', 'data', 'model')): every rank holds the parameters whole, except a
MoE layer's experts, which it holds cut over 'model' (expert parallelism,
``models.moe``; ``parallel.sharding.serving_shardings``): a protected
projection computes on whole operands (``models.common.linear``), so a
rank that held its 'model' shards would gather them back for every call.
The batch's rows are split over the dp axes where they divide
(``batch_shardings``), and the caches the prefill builds are this rank's
rows and kv heads (``cache_shardings``), as the model code under the mesh
context makes them.  Every rank samples from the whole batch's logits
(gathered over dp), so the tokens come back whole on every rank and a
sampling key draws what it draws without a mesh; the tokens equal the
meshless Engine's bit for bit.  Under the scan loop the mesh's collectives
are captured in the step's CUDA graph with its kernels; a collective that
cannot be captured fails the capture, which raises (no eager
fallback).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import prng
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as S
from repro_torch.serve.graphs import StepGraph

LOOPS = ("scan", "python")


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0
    seed: int = 0
    loop: str = "scan"            # "scan" (graphed) | "python" (per-token)


@dataclasses.dataclass
class ServeStats:
    """Host-dispatch accounting for the last ``generate`` call: one round
    trip for the prefill, and one for the scan loop or one per decode step
    of the python loop."""
    roundtrips: int = 0
    tokens: int = 0


def ft_ctx(policy, key, backend, t=None):
    """The forward's fault-tolerance context, or None without a policy."""
    if policy is None:
        return None
    from repro_torch.models.common import FTCtx
    return FTCtx(policy, key, backend=backend, t=t)


def sample_scaled(logits, key, temperature):
    """A compiled loop's sample: ``logits * (1 / T)`` in float32, the
    product the reference's compiler makes of its division by a constant
    (the Engine's scan and the Scheduler); argmax at temperature 0."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    inv = float(np.float32(1) / np.float32(temperature))
    return prng.categorical(key, logits * inv).to(torch.int32)


class Engine:
    def __init__(self, model, params, cfg: ServeConfig | None = None,
                 policy=None, ft_backend: str = "reference", ft_t=None,
                 loop: str | None = None, *, mesh=None):
        """``policy``: a protection policy (or registry name) applied to
        every projection; ``ft_backend``: "reference", "fused" or "pallas".
        For "pallas", ``ft_t`` carries the calibrated truncation LSB(s): one
        int or a ``{site: int}`` table (``repro_torch.ft.calibrate_t``); a
        site without one raises, the Engine never calibrates behind the
        caller's back.  Runs on the device the parameters are on.
        ``mesh``: a DeviceMesh to serve on (the module docstring); every
        rank passes the same whole parameters and batches."""
        from repro_torch.ft import as_policy
        self.model, self.params = model, params
        self.cfg = cfg or ServeConfig()
        self.loop = loop or self.cfg.loop
        if self.loop not in LOOPS:
            raise ValueError(f"unknown loop {self.loop!r}; expected {LOOPS}")
        self.policy = as_policy(policy)
        self.ft_backend = ft_backend
        self.ft_t = ft_t
        self.device = params["embed"].device
        self.mesh = mesh
        self._ctx = None if mesh is None else S.make_ctx(mesh)
        if mesh is not None:
            S.check_model(model.cfg, mesh)
            self.params = S.distribute(
                params, S.serving_shardings(params, mesh), mesh)
        self.stats = ServeStats()
        self._n_calls = 0
        self._scan_step = None       # _ScanStep of the last shape

    def _ftc(self, ftkey):
        return ft_ctx(self.policy, ftkey, self.ft_backend, self.ft_t)

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
        """batch: {"tokens": (B, S) int tensor}, with the vision family's
        ``patch_embeds`` (B, P, D) or the encoder-decoder's ``frames`` (B,
        T, D).  Returns (B, new) int32 tokens on the engine's device."""
        n_new = (self.cfg.max_new_tokens if max_new_tokens is None
                 else max_new_tokens)
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()
                 if k in ("tokens", "patch_embeds", "frames")}
        prompt_len = batch["tokens"].shape[1]
        if self.model.cfg.frontend == "vision":
            prompt_len += self.model.cfg.n_frontend_tokens
        ftkey, skey = self._call_key(key, seed)
        ctx = (None if self._ctx is None
               else self._ctx.for_rows(batch["tokens"].shape[0]))
        with pctx.mesh_ctx(ctx):
            caches, logits = self.model.prefill(
                self.params,
                {k: pctx.local_rows(v) for k, v in batch.items()},
                max_len=prompt_len + n_new, ftc=self._ftc(ftkey))
            tok = self._sample(pctx.gather_rows(logits), skey)
        if n_new == 0:                       # prefill-only probe
            self.stats = ServeStats(roundtrips=1, tokens=0)
            return torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                               device=self.device)
        if self.loop == "scan":
            out = self._scan(caches, tok, prompt_len, ftkey, skey, n_new,
                             ctx)
            self.stats = ServeStats(roundtrips=2, tokens=out.numel())
            return out
        out = []
        with pctx.mesh_ctx(ctx):
            for i in range(n_new):
                out.append(tok)
                caches, logits = self.model.decode_step(
                    self.params, caches, pctx.local_rows(tok),
                    prompt_len + i, ftc=self._ftc(prng.fold_in(ftkey, i + 1)))
                skey = prng.fold_in(skey, i)  # the reference's sampling stream
                tok = self._sample(pctx.gather_rows(logits), skey)
        out = torch.stack(out, dim=1)
        self.stats = ServeStats(roundtrips=1 + n_new, tokens=out.numel())
        return out

    def _scan(self, caches, tok, pos0, ftkey, skey, n_new, ctx=None):
        """The scan loop: ``n_new`` runs of the decode step for these
        caches' shapes; each emits the token it consumes, so the result is
        ``[tok0, ..., tok_{n_new-1}]``, as the reference's scan."""
        shapes = (tuple(tok.shape), tok.dtype) + tuple(
            (name, tuple(c.shape), c.dtype)
            for name, c in tree.items(caches))
        step = self._scan_step
        if step is None or step.shapes != shapes:
            self._scan_step = step = None    # free the old buffers first
            step = self._scan_step = _ScanStep(
                self.model, self.params, caches, tok,
                functools.partial(ft_ctx, self.policy, backend=self.ft_backend,
                                  t=self.ft_t), self.cfg.temperature, shapes,
                ctx)
        step.load(caches, tok, pos0, ftkey, skey)
        out = []
        for _ in range(n_new):
            out.append(step.tok.clone())
            step.graph()
        return torch.stack(out, dim=1)


class _ScanStep:
    """One decode step of the scan loop over static buffers for caches of
    ``shapes``: the caches, whatever the model's cache tree holds (attention
    caches, recurrent state rows; copied in from each prefill), the carried
    token and sampling key, the step index ``i``, the prompt length
    ``pos0`` and the fault key.  Step ``i`` decodes at ``pos0 + i`` under
    ``fold_in(ftkey, i + 1)``, folds ``i`` into the sampling key and
    samples the next token, all on the device; ``graph`` runs it
    (``serve.graphs.StepGraph``).  On a mesh the step runs under the mesh
    context ``ctx``; the token buffer holds the whole batch.  The step holds its buffers and no Engine, so nothing here is a
    reference cycle and the device memory goes with the Engine."""

    def __init__(self, model, params, caches, tok, ftc, temperature,
                 shapes, ctx=None):
        dev = tok.device
        self.shapes = shapes
        self.caches = caches = tree.tree_map(torch.zeros_like, caches)
        self.tok = tok = torch.zeros_like(tok)
        self.i, self.pos0 = i, pos0 = [
            torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
        self.ftkey, self.skey = ftkey, skey = [
            torch.zeros((2,), dtype=torch.int64, device=dev)
            for _ in range(2)]

        def step():
            with pctx.mesh_ctx(ctx):
                _, logits = model.decode_step(
                    params, caches, pctx.local_rows(tok), pos0 + i,
                    ftc=ftc(prng.fold_in(ftkey, i + 1)))
                logits = pctx.gather_rows(logits)
            key = prng.fold_in(skey, i)
            tok.copy_(sample_scaled(logits, key, temperature))
            skey.copy_(key)
            i.add_(1)
        self.graph = StepGraph(step, dev)

    def load(self, caches, tok, pos0, ftkey, skey):
        """A generation's starting state: its prefill's caches, first token,
        prompt length and keys; step index 0."""
        tree.tree_map(lambda buf, c: buf.copy_(c), self.caches, caches)
        self.tok.copy_(tok)
        self.pos0.fill_(pos0)
        self.i.zero_()
        self.ftkey.copy_(ftkey)
        self.skey.copy_(skey)

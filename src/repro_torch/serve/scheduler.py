"""Continuous-batching request scheduler over a paged (or dense) KV cache.

Counterpart of ``repro.serve.scheduler``.  A fixed pool of ``max_batch``
decode *slots* serves a queue of requests:

  * **admit**: a free slot prefills the next queued request (B = 1, its
    prompt right-padded to a bucket) and its caches are written into the
    slot: scattered into freshly allocated KV blocks (paged) or into the
    slot's cache row (dense);
  * **decode**: all slots step together for ``decode_chunk`` tokens per host
    round trip, each at its own position;
  * **evict**: a request leaves its slot when it emits ``eos_id`` or reaches
    its ``max_new_tokens``; its blocks go back to the free list, and its
    block-table rows back to the trash block 0.

KV layouts (``cfg.kv``): ``"paged"``, a per-layer block pool of
``(n_blocks, block_size, KH, Dh)`` addressed through per-slot block tables,
where a request holds ``ceil(total / block_size)`` blocks, ``total =
min(plen + max_new, capacity)``, plus ``ceil(min(total, window) /
block_size)`` for sliding-window layers, so admission is bounded by free
blocks; ``"dense"``, a
capacity-sized cache row per slot, the exactness oracle for the paged one.

Fault-tolerant serving keeps per-request reliability accounting, as the
reference does: request ``rid``'s prefill draws from
``fold_in(fold_in(ftbase, rid), 0)`` and its token ``t`` from
``fold_in(fold_in(ftbase, rid), t + 1)``, passed as a ``(B, 2)`` key batch,
so every projection of a decode step runs per row (its own activation
scale, truncation LSB and flip words; ``fused_decode``'s per-row mode).  A
request's tokens are a function of its id and its own tokens only.  At a
temperature above 0 row b samples ``categorical(fold_in(fold_in(sbase,
rid_b), tstep_b + 1), logits_b * (1 / T))``: the reference's division by a
constant, which its compiler turns into that product.

The loop runs on the device the parameters are on.  The reference scans a
decode chunk inside one executable; here (``loop="scan"``, the default)
one decode step of every slot is a ``serve.graphs.StepGraph``: captured
once per Scheduler as a CUDA graph on the card and replayed
``decode_chunk`` times per chunk, run eagerly on the CPU.  The step reads
the tokens, positions, step indices, row keys and active mask from static
device buffers, which each chunk loads from the host in one copy, and the
Scheduler keeps one set of caches, zeroed at the start of every run, that
the graph owns.  ``loop="python"`` runs the same step eagerly on any
device.  ``SchedStats`` counts the same calls the reference counts as
executables, in both loops.

The recurrent families (R and S layers) and the encoder-decoder family
schedule with exact-length prefill (``buckets=None``), as in the
reference: a right-padded prompt would run its pads through the
recurrence or the encoder.  Their state lives in dense per-slot rows
beside the attention caches under either ``kv`` layout; admission writes a
request's rows into its slot.  An encoder-decoder request carries its
encoder input in ``extras={"frames": (T, D)}``; its slot keeps per-slot
cross-attention rows of ``capacity - max_new_tokens`` positions and the
row's valid length ``cn``, so slots hold encoder contexts of different
lengths.  That needs the paged layout: the dense one has no ``cn`` (the
reference's dense Scheduler fails on such a model), so it is refused.  A
vision request carries ``extras={"patch_embeds": (P, D)}``: its P patch
positions come before the prompt, in the capacity, the block count and
every position (``_front``).

On a mesh (``mesh=``, a DeviceMesh) the parameters are held as the Engine
holds them (whole, the MoE experts cut over 'model'); the slots
are split over the dp axes where ``max_batch`` divides them, and the
caches are held per ``parallel.sharding.cache_shardings``: this rank's
slot rows and kv heads, while a paged pool stays whole over the dp axes
(block tables hold global block ids) and splits only its kv heads over
'model'.  Every rank runs the same host loop (admission, block allocation,
eviction) on the same requests; a B = 1 prefill runs whole on every rank
and its caches go into the slot's owner (its rows) and into every copy of
the pools; a decode step runs each rank's own slots, writes every rank's
new rows into every pool copy, and the chunk's tokens are gathered over
dp once per chunk.  The per-request keys make every protected projection
row-local, so the slots stay split and the tokens equal the meshless
Scheduler's bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import prng
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as S
from repro_torch.serve.engine import LOOPS, ft_ctx, sample_scaled
from repro_torch.serve.graphs import StepGraph


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list                     # prompt token ids
    max_new_tokens: int = 16
    extras: dict | None = None       # extra model inputs, batched per request
    # filled by the scheduler:
    generated: list = dataclasses.field(default_factory=list)
    finish_reason: str | None = None   # "eos" | "length"


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 4               # concurrent decode slots
    buckets: tuple | None = (8, 16)  # prompt pad lengths; None = exact-length
    max_prompt: int | None = None    # prompt cap when buckets is None
    max_new_tokens: int = 16         # per-request cap (cache headroom)
    decode_chunk: int = 4            # decode steps per host round trip
    temperature: float = 0.0
    eos_id: int = -1                 # < 0: no EOS eviction
    seed: int = 0
    kv: str = "paged"                # "paged" | "dense" KV-cache layout
    block_size: int = 8              # tokens per KV block (paged)
    n_blocks: int | None = None      # pool size incl. trash block (paged;
    #                                  default: full provisioning)


@dataclasses.dataclass
class SchedStats:
    prefill_calls: int = 0
    insert_calls: int = 0
    chunk_calls: int = 0
    retire_calls: int = 0
    tokens: int = 0
    blocks_in_use_peak: int = 0

    @property
    def roundtrips(self) -> int:
        return (self.prefill_calls + self.insert_calls + self.chunk_calls
                + self.retire_calls)


class Scheduler:
    def __init__(self, model, params, cfg: SchedulerConfig | None = None,
                 policy=None, ft_backend: str = "reference", mesh=None,
                 loop: str = "scan"):
        """``policy``: a protection policy (or registry name) applied to
        every projection, on ``ft_backend`` "reference" or "fused" (per-row
        keys need one of the two; the reference's ``ft_t`` serves only the
        pallas backend, which it refuses too).  ``loop``: "scan" replays
        the decode step as a CUDA graph on the card, "python" runs it
        eagerly.  Runs on the device the parameters are on.  ``mesh``: a
        DeviceMesh to serve on (the module docstring); every rank passes the
        same whole parameters and requests."""
        from repro_torch.ft import as_policy
        if loop not in LOOPS:
            raise ValueError(f"unknown loop {loop!r}; expected {LOOPS}")
        self.loop = loop
        self.model, self.params = model, params
        self.cfg = cfg or SchedulerConfig()
        self.policy = as_policy(policy)
        self.ft_backend = ft_backend
        self.device = params["embed"].device
        self.stats = SchedStats()
        self.mesh = mesh
        self._ctx = None
        self._slot0, self._nloc = 0, self.cfg.max_batch
        if mesh is not None:
            ctx = S.make_ctx(mesh)
            S.check_model(model.cfg, mesh)
            self._ctx = ctx.for_rows(self.cfg.max_batch)
            if self._ctx.rows:
                self._nloc = self.cfg.max_batch // ctx.dp_size
                self._slot0 = ctx.dp_coord() * self._nloc
            self.params = S.distribute(
                params, S.serving_shardings(params, mesh), mesh)

        mcfg = model.cfg
        kinds = T.layer_kinds(mcfg)
        self._kinds = kinds
        exact = self.cfg.buckets is None
        if self.cfg.kv not in ("paged", "dense"):
            raise ValueError(f"unknown kv layout {self.cfg.kv!r}")
        if (set(kinds) & {"R", "S"} or mcfg.enc_dec) and not exact:
            raise ValueError(
                "bucketed prefill supports attention families only: "
                "right-padded prompts would integrate pad tokens into "
                "recurrent/encoder state.  Recurrent (R/S) and enc-dec "
                "models schedule with buckets=None (exact-length "
                "prefill); their recurrent/SSM state lives in dense "
                "per-slot rows under either kv layout")
        if mcfg.enc_dec and self.cfg.kv != "paged":
            raise ValueError(
                "an encoder-decoder model schedules with kv='paged': the "
                "dense layout's cross-attention rows have no per-slot valid "
                "length cn, so a slot could not hold an encoder context "
                "shorter than the buffer")
        self._front = (mcfg.n_frontend_tokens if mcfg.frontend == "vision"
                       else 0)
        if (not exact and "L" in kinds
                and self._front + max(self.cfg.buckets) > mcfg.window):
            raise ValueError(
                f"buckets {self.cfg.buckets} (+ {self._front} frontend "
                f"tokens) exceed the sliding window {mcfg.window}: pad "
                "tokens would evict real history from the rolling cache "
                "(use buckets=None for exact-length prefill)")
        if exact and self.cfg.max_prompt is None:
            raise ValueError("buckets=None (exact-length prefill) needs "
                             "cfg.max_prompt to bound slot capacity")
        if self.policy is not None and ft_backend not in ("reference",
                                                          "fused"):
            raise ValueError(
                "per-request fault streams need ft_backend='reference' or "
                "'fused' (per-row keys, per-row weight-fault streams); the "
                "pallas backend takes a single global key and a static t")

        # cache capacity: every slot can hold the largest admitted prompt
        # plus a full generation
        max_prompt = (self.cfg.max_prompt if exact
                      else max(self.cfg.buckets))
        self.capacity = max_prompt + self.cfg.max_new_tokens + self._front
        self._window = mcfg.window if "L" in kinds else 0
        bs = self.cfg.block_size
        self._wg = -(-self.capacity // bs)
        self._wl = -(-self._window // bs) if self._window else 0
        if self.cfg.kv == "paged":
            self.n_blocks = (self.cfg.n_blocks
                             if self.cfg.n_blocks is not None
                             else 1 + self.cfg.max_batch
                             * (self._wg + self._wl))
            if self.n_blocks < 2:
                raise ValueError("paged KV needs n_blocks >= 2 (block 0 is "
                                 "the trash block)")
        else:
            self.n_blocks = 0

        ks = prng.split(prng.PRNGKey(self.cfg.seed, device=self.device))
        self._ftbase, self._sbase = ks[0], ks[1]
        self._caches = None          # one set per Scheduler (_run_caches)
        self._step = None            # the chunk's decode step (_ChunkStep)

    # ------------------------------------------------------------ steps ----
    def _ftc(self, keys):
        return ft_ctx(self.policy, keys, self.ft_backend)

    def _sample(self, logits, rids, tsteps):
        return _sample_rows(logits, rids, tsteps, sbase=self._sbase,
                            temperature=self.cfg.temperature)

    def _prefill_one(self, batch1, last_idx, rid):
        """B = 1 prefill under the request's key ``fold(fold(ftbase, rid),
        0)``; its first token at ``tstep = -1``."""
        ftk = prng.fold_in(prng.fold_in(self._ftbase, rid), 0)
        ctx = self._ctx and self._ctx.for_rows(1)
        with pctx.mesh_ctx(ctx):
            caches, logits = self.model.prefill(
                self.params, batch1, max_len=self.capacity,
                ftc=self._ftc(ftk), last_index=last_idx)
        rids = torch.full((1,), rid, dtype=torch.int64, device=self.device)
        tok0 = self._sample(logits, rids, torch.full_like(rids, -1))
        return caches, int(tok0[0])

    def _scatter_pool(self, pool, rows, bt_row, wdw, plen):
        """Write prefill positions ``idx < min(plen, wdw)`` (``< plen`` for a
        global layer) of ``rows`` (1, S1, KH, Dh) into their physical rows of
        ``pool``; bucket pads and capacity growth write nowhere."""
        P, bs = pool.shape[0], pool.shape[1]
        n = min(plen, wdw) if wdw else plen
        idx = torch.arange(n, device=pool.device)
        fi = bt_row[idx // bs].long() * bs + idx % bs
        pool.view(P * bs, *pool.shape[2:])[fi] = rows[0, :n].to(pool.dtype)

    def _insert(self, caches, c1, slot, plen, bt_g, bt_l):
        """Write a B = 1 prefill's caches into ``slot``: paged attention
        leaves are scattered through the slot's new block table; dense
        leaves (dense KV, the R and S layers' state rows) are slot-row
        writes; cross-attention rows fill the slot's first ``s1e`` (the
        encoder input's length) positions, and ``cn[slot] = s1e``.  On a
        mesh every rank writes the pools; only the slot's owner its rows.
        """
        own = self._own(slot)
        for lid, kind in zip(caches, self._kinds):
            for key, dst in caches[lid].items():
                new = c1[lid][key]
                if key == "cross":
                    if own is None:
                        continue
                    s1e = new["ck"].shape[1]
                    for name in ("ck", "cv"):
                        dst[name][own, :s1e] = new[name][0].to(
                            dst[name].dtype)
                    dst["cn"][own] = s1e
                    continue
                if "bt" in dst:
                    wdw = self._window if kind == "L" else 0
                    row = bt_l if wdw else bt_g
                    for name in ("k", "v"):
                        self._scatter_pool(dst[name], new[name], row, wdw,
                                           plen)
                    if own is not None:
                        dst["bt"][own] = row
                    continue
                if own is not None:
                    for name, buf in dst.items():
                        buf[own] = new[name][0].to(buf.dtype)

    def _own(self, slot):
        """The index of ``slot`` among this rank's slot rows, or None where
        another dp rank holds it."""
        i = slot - self._slot0
        return i if 0 <= i < self._nloc else None

    def _retire(self, caches, slot):
        """Point the evicted slot's block tables back at the trash block, so
        its row, which goes on decoding, writes nowhere a request reads."""
        own = self._own(slot)
        for c in caches.values():
            if "bt" in c.get("attn", {}) and own is not None:
                c["attn"]["bt"][own] = 0

    def _chunk(self, caches, tok, pos, tstep, rids, active):
        """``decode_chunk`` decode steps of every slot; tokens, positions
        and step indices advance only in active rows.  Returns the new
        (tok, pos, tstep) and the (B, decode_chunk) tokens, on the host."""
        if self._step is None:
            self._step = _ChunkStep(
                self.model, self.params, caches, self._nloc,
                self.cfg.decode_chunk,
                self._ftbase, functools.partial(
                    ft_ctx, self.policy, backend=self.ft_backend),
                functools.partial(_sample_rows, sbase=self._sbase,
                                  temperature=self.cfg.temperature),
                self._ctx)
        st = self._step
        rows = slice(self._slot0, self._slot0 + self._nloc)
        st.load(np.stack([tok, pos, tstep, rids, active])[:, rows])
        run = st.graph if self.loop == "scan" else st.graph.step
        for _ in range(self.cfg.decode_chunk):
            run()
        out = torch.cat([torch.stack([st.tok, st.pos, st.tstep]), st.toks])
        if self._ctx is not None and self._ctx.rows:
            out = pctx.all_gather(self._ctx, out, 1, "dp")
        host = out.cpu().numpy()
        return (host[0].astype(np.int32), host[1].astype(np.int32),
                host[2].astype(np.int32), host[3:].T)

    # ------------------------------------------------------------ helpers --
    def _bucket(self, n: int) -> int:
        if self.cfg.buckets is None:
            if n > self.cfg.max_prompt:
                raise ValueError(f"prompt length {n} exceeds cfg.max_prompt "
                                 f"{self.cfg.max_prompt}")
            return n
        for b in sorted(self.cfg.buckets):
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{max(self.cfg.buckets)}")

    def _make_batch1(self, req: Request):
        L = len(req.tokens)
        toks = torch.zeros((1, self._bucket(L)), dtype=torch.int64)
        toks[0, :L] = torch.as_tensor(req.tokens, dtype=torch.int64)
        batch1 = {"tokens": toks.to(self.device)}
        for k, v in (req.extras or {}).items():
            batch1[k] = torch.as_tensor(v, device=self.device)[None]
        last_idx = torch.full((1,), self._front + L - 1, device=self.device)
        return batch1, last_idx, self._front + L

    def _blocks_needed(self, plen: int, max_new: int) -> int:
        if self.cfg.kv != "paged":
            return 0
        bs = self.cfg.block_size
        total = min(plen + max_new, self.capacity)
        need = -(-total // bs)
        if self._window:
            need += -(-min(total, self._window) // bs)
        return need

    def _run_caches(self):
        """Zero caches for a run: allocated once per Scheduler, since the
        chunk's graph owns them, and zeroed (block tables back at the trash
        block) at the start of every later run."""
        if self._caches is None:
            paged = ((self.cfg.block_size, self.n_blocks)
                     if self.cfg.kv == "paged" else None)
            enc_len = (self.capacity - self.cfg.max_new_tokens
                       if self.model.cfg.enc_dec else None)
            self._caches = self.model.init_cache(
                self.cfg.max_batch, self.capacity, device=self.device,
                paged=paged, enc_len=enc_len)
            if self.mesh is not None:
                self._caches = S.distribute(
                    self._caches, S.cache_shardings(self._caches, self.mesh),
                    self.mesh)
        else:
            for c in tree.leaves(self._caches):
                c.zero_()
        return self._caches

    # ---------------------------------------------------------------- run --
    @torch.no_grad()
    def run(self, requests) -> dict:
        """Serve ``requests`` to completion; returns {rid: Request} with
        ``generated`` / ``finish_reason`` filled."""
        cfg = self.cfg
        B = cfg.max_batch
        bs = cfg.block_size
        self.stats = SchedStats()
        seen_rids = set()
        for req in requests:
            plen = self._front + self._bucket(len(req.tokens))  # fail fast
            if req.rid in seen_rids:
                raise ValueError(
                    f"duplicate request id {req.rid}: results are keyed by "
                    "rid and the per-request fault streams derive from it")
            seen_rids.add(req.rid)
            if req.max_new_tokens > cfg.max_new_tokens:
                raise ValueError(
                    f"request {req.rid} wants {req.max_new_tokens} tokens "
                    f"but the slot capacity budgets cfg.max_new_tokens="
                    f"{cfg.max_new_tokens}: decoding past capacity would "
                    "overwrite cache history")
            if self.model.cfg.enc_dec and req.extras:
                fl = len(req.extras["frames"])
                if fl > self.capacity - cfg.max_new_tokens:
                    raise ValueError(
                        f"request {req.rid} encoder input length {fl} "
                        f"exceeds the cross-attention capacity "
                        f"{self.capacity - cfg.max_new_tokens} "
                        "(cfg.max_prompt)")
            if (cfg.kv == "paged"
                    and self._blocks_needed(plen, req.max_new_tokens)
                    > self.n_blocks - 1):
                raise ValueError(
                    f"request {req.rid} needs "
                    f"{self._blocks_needed(plen, req.max_new_tokens)} KV "
                    f"blocks but the pool has {self.n_blocks - 1} "
                    "allocatable: raise cfg.n_blocks or block_size")
            req.generated = []              # a re-submitted Request restarts
            req.finish_reason = None
        queue = collections.deque(requests)
        slots: list[Request | None] = [None] * B
        out = {}

        caches = self._run_caches()
        tok = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        tstep = np.zeros((B,), np.int32)
        rids = np.zeros((B,), np.int32)
        free_blocks = collections.deque(range(1, self.n_blocks))
        slot_blocks: list[list] = [[] for _ in range(B)]

        def alloc_tables(plen, max_new):
            """Pop blocks for a request; return (bt_g, bt_l) table rows."""
            total = min(plen + max_new, self.capacity)
            g_need = -(-total // bs)
            l_need = (-(-min(total, self._window) // bs)
                      if self._window else 0)
            got = [free_blocks.popleft() for _ in range(g_need + l_need)]
            bt_g = np.zeros((self._wg,), np.int32)
            bt_g[:g_need] = got[:g_need]
            bt_l = np.zeros((max(self._wl, 1),), np.int32)
            if l_need:
                bt_l[:l_need] = got[g_need:]
            return got, bt_g, bt_l

        def release(s):
            if cfg.kv == "paged":
                free_blocks.extend(slot_blocks[s])
                slot_blocks[s] = []

        def finish(s, req, reason):
            req.finish_reason = reason
            out[req.rid] = req
            slots[s] = None
            release(s)

        while queue or any(s is not None for s in slots):
            # ---- admit into free slots (a request that finishes at
            # prefill, EOS first token or max_new_tokens == 1, does not
            # use up the slot's turn; the slot retries the queue) ---------
            admitted = 0
            for s in range(B):
                while slots[s] is None and queue:
                    req = queue[0]
                    need = self._blocks_needed(
                        self._front + self._bucket(len(req.tokens)),
                        req.max_new_tokens)
                    if need > len(free_blocks):
                        break               # wait for evictions to free blocks
                    queue.popleft()
                    batch1, last_idx, plen = self._make_batch1(req)
                    c1, t0 = self._prefill_one(batch1, last_idx, req.rid)
                    self.stats.prefill_calls += 1
                    req.generated.append(t0)
                    self.stats.tokens += 1
                    if cfg.eos_id >= 0 and t0 == cfg.eos_id:
                        req.finish_reason = "eos"
                        out[req.rid] = req
                        continue
                    if len(req.generated) >= req.max_new_tokens:
                        req.finish_reason = "length"
                        out[req.rid] = req
                        continue
                    if cfg.kv == "paged":
                        got, bt_g, bt_l = alloc_tables(plen,
                                                       req.max_new_tokens)
                        slot_blocks[s] = got
                        in_use = self.n_blocks - 1 - len(free_blocks)
                        self.stats.blocks_in_use_peak = max(
                            self.stats.blocks_in_use_peak, in_use)
                    else:
                        bt_g = np.zeros((self._wg,), np.int32)
                        bt_l = np.zeros((max(self._wl, 1),), np.int32)
                    self._insert(caches, c1, s, plen,
                                 torch.from_numpy(bt_g).to(self.device),
                                 torch.from_numpy(bt_l).to(self.device))
                    self.stats.insert_calls += 1
                    slots[s] = req
                    admitted += 1
                    tok[s], pos[s], tstep[s], rids[s] = t0, plen, 0, req.rid

            active = np.array([r is not None for r in slots])
            if not active.any():
                if queue and not admitted:
                    raise RuntimeError(
                        "scheduler stalled: no active slots and the next "
                        "request cannot be admitted (KV block pool too "
                        "small?)")
                continue

            # ---- one decode chunk --------------------------------------
            tok, pos, tstep, toks = self._chunk(caches, tok, pos, tstep,
                                                rids, active)
            self.stats.chunk_calls += 1

            # ---- harvest + evict ---------------------------------------
            evicted = []
            for s in range(B):
                req = slots[s]
                if req is None:
                    continue
                for t in toks[s]:
                    req.generated.append(int(t))
                    self.stats.tokens += 1
                    if cfg.eos_id >= 0 and int(t) == cfg.eos_id:
                        finish(s, req, "eos")
                        evicted.append(s)
                        break
                    if len(req.generated) >= req.max_new_tokens:
                        finish(s, req, "length")
                        evicted.append(s)
                        break
            if cfg.kv == "paged":
                for s in evicted:
                    self._retire(caches, s)
                    self.stats.retire_calls += 1
        return out


def _sample_rows(logits, rids, tsteps, sbase, temperature):
    """Row b's token; at a temperature, from the key ``fold_in(fold_in(
    sbase, rid_b), tstep_b + 1)``, the logits scaled by ``1 / T``."""
    keys = (prng.fold_in(prng.fold_in(sbase, rids), tsteps + 1)
            if temperature > 0 else None)
    return sample_scaled(logits, keys, temperature)


class _ChunkStep:
    """One decode step of every slot over static buffers: the tokens,
    positions, step indices and request ids (int64, (B,)), the active mask,
    the row keys ``fold_in(ftbase, rid)``, the index ``j`` of the step in
    its chunk and the chunk's (decode_chunk, B) tokens; the Scheduler's
    caches.  ``graph`` runs it (``serve.graphs.StepGraph``).  On a mesh the
    rows are this rank's slots, under the mesh context ``ctx``.  The step holds its
    buffers and no Scheduler, so nothing here is a reference cycle."""

    def __init__(self, model, params, caches, B, decode_chunk, ftbase, ftc,
                 sample, ctx=None):
        dev = ftbase.device
        self.tok, self.pos, self.tstep, self.rids = tok, pos, tstep, rids = [
            torch.zeros((B,), dtype=torch.int64, device=dev)
            for _ in range(4)]
        self.active = active = torch.zeros((B,), dtype=torch.bool,
                                           device=dev)
        self.rowkeys = rowkeys = torch.zeros((B, 2), dtype=torch.int64,
                                             device=dev)
        self.j = j = torch.zeros((), dtype=torch.int64, device=dev)
        self.toks = toks = torch.zeros((decode_chunk, B), dtype=torch.int64,
                                       device=dev)
        self._ftbase = ftbase

        def step():
            keys = prng.fold_in(rowkeys, tstep + 1)
            with pctx.mesh_ctx(ctx):
                _, logits = model.decode_step(params, caches, tok, pos,
                                              ftc=ftc(keys))
            nxt = sample(logits, rids, tstep).to(torch.int64)
            toks.index_copy_(0, j.reshape(1), nxt.reshape(1, B))
            act = active.to(torch.int64)
            tok.copy_(torch.where(active, nxt, tok))
            pos.add_(act)
            tstep.add_(act)
            j.add_(1)
        self.graph = StepGraph(step, dev)

    def load(self, host: np.ndarray):
        """A chunk's starting state from the host's (5, B) rows of tokens,
        positions, step indices, request ids and active flags, in one
        host-to-device copy."""
        rows = torch.from_numpy(host.astype(np.int64)).to(self.tok.device)
        for buf, row in zip((self.tok, self.pos, self.tstep, self.rids),
                            rows):
            buf.copy_(row)
        self.active.copy_(rows[4] != 0)
        self.rowkeys.copy_(prng.fold_in(self._ftbase, self.rids))
        self.j.zero_()

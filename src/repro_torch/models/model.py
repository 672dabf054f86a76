"""Public model API: build a Model from (ModelConfig, RunConfig).

Counterpart of ``repro.models.model``: ``init``, ``loss`` (training),
``prefill`` (with the cache ``grow``), ``decode_step``, ``init_cache`` and
the dry run's ``batch_specs``, ``cache_specs`` and ``param_specs`` (meta
tensors).  Parameters and caches are plain dicts of tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention, ssm, transformer as T
from repro_torch.models.common import dtype_of, rms_norm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    run: RunConfig = RunConfig()

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters with the reference's init distributions, drawn
        from ``generator`` (which must live on ``device``)."""
        return T.init_params(generator, self.cfg, self.run,
                             _device.resolve(device))

    def loss(self, params, batch, ftc=None):
        """Mean next-token cross-entropy of ``batch`` under ``ftc`` (None:
        the clean forward, or the ``run.ft_emu`` cost emulation where it is
        set).  An encoder-decoder encodes its ``frames`` first; the vision
        family's loss leaves out the patch positions (labels -1).  Returns
        (loss, {"nll", "aux"}); aux is the MoE's load-balance term (0
        for other families)."""
        cfg, run = self.cfg, self.run
        if ftc is None and run.ft_emu:
            from repro_torch.models.common import EmuCtx
            ftc = EmuCtx(run.ft_emu, run.ft_s_th)
        x, labels, mask, enc_out = T.assemble_inputs(params, cfg, batch)
        if cfg.enc_dec:
            enc_out = T.encode(params, enc_out, cfg=cfg, run=run, ftc=ftc)
        h, _, aux = T.backbone(params, x, cfg=cfg, run=run, mode="train",
                               ftc=ftc, enc_out=enc_out)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        nll = T.chunked_xent(params, cfg, run, h, labels, mask)
        return nll + aux, {"nll": nll, "aux": aux}

    def prefill(self, params, batch, max_len: int | None = None, ftc=None,
                last_index=None):
        """Forward over a prompt, building the caches.  ``max_len`` reserves
        decode room in full-attention caches; rolling (window) caches and
        recurrent state keep their fixed sizes.  ``last_index`` (B,) takes
        each row's logits at its last real token of a right-padded prompt.
        An encoder-decoder's prompt runs its ``frames`` through the encoder
        first; its ``cross`` caches keep the encoder's length.
        Returns (caches, last_token_logits)."""
        cfg, run = self.cfg, self.run
        x, _, _, enc_out = T.assemble_inputs(params, cfg, batch)
        if cfg.enc_dec:
            enc_out = T.encode(params, enc_out, cfg=cfg, run=run, ftc=ftc)
        h, caches, _ = T.backbone(params, x, cfg=cfg, run=run,
                                  mode="prefill", ftc=ftc, enc_out=enc_out)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        if max_len is not None:
            S = x.shape[1]
            pad = max(max_len - S, 0)
            for lid, kind in zip(caches, T.layer_kinds(cfg)):
                # only full-attention caches grow; rolling (window) caches
                # and the R/S layers' state rows keep their sizes
                if pad and (kind == "G" or (kind == "L" and not cfg.window)):
                    caches[lid]["attn"] = {
                        n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
                        for n, c in caches[lid]["attn"].items()}
        return caches, T.last_logits(params, cfg, h, last_index)

    def decode_step(self, params, caches, token, pos, ftc=None):
        """One-token decode.  token: (B,) int; pos: an int shared by the
        batch or a (B,) tensor of per-row positions.  Returns (new_caches,
        logits (B, V))."""
        cfg, run = self.cfg, self.run
        B = token.shape[0]
        x = T.embed_tokens(params, cfg, token[:, None])
        pos = _device.scalar(pos, torch.int64, token.device)
        positions = (pos.reshape(B, 1) if pos.dim()
                     else pos.expand(B).reshape(B, 1))
        h, new_caches, _ = T.backbone(params, x, cfg=cfg, run=run,
                                      mode="decode", caches=caches,
                                      positions=positions, ftc=ftc)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return new_caches, T.last_logits(params, cfg, h)

    def init_cache(self, batch: int, seq_len: int, device=None, *,
                   paged=None, enc_len: int | None = None):
        """Zero caches for decoding at context length ``seq_len``, one
        ``l{i}`` entry per layer whatever the config (the reference stacks
        scanned segments).  ``paged=(block_size, n_blocks)`` gives every
        attention layer the paged layout (``attention.init_paged_cache``);
        the R and S layers' state stays in dense per-slot rows under either
        layout: ``{"rglru": {"h", "conv"}}`` and ``{"ssd": {"state",
        "conv"}}``, the recurrent state in float32 and the conv history in
        the compute dtype.  An encoder-decoder's attention layers also get
        dense per-slot ``{"cross": {"ck", "cv"}}`` rows of ``enc_len``
        (default ``seq_len``) encoder positions; passing ``enc_len`` adds
        the per-row int32 valid length ``cn`` (the Scheduler's layout, where
        slots hold encoder contexts of different lengths)."""
        cfg = self.cfg
        dev = _device.resolve(device)
        dtype = dtype_of(self.run.compute_dtype)
        e_len = enc_len if enc_len is not None else seq_len

        def cross():
            shp = (batch, e_len, cfg.n_kv_heads, cfg.d_head)
            c = {"ck": zeros(shp), "cv": zeros(shp)}
            if enc_len is not None:
                c["cn"] = zeros((batch,), torch.int32)
            return c

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def layer(kind):
            if kind == "R":
                return {"rglru": {
                    "h": zeros((batch, cfg.rglru_width), torch.float32),
                    "conv": zeros((batch, cfg.rglru_conv - 1,
                                   cfg.rglru_width))}}
            if kind == "S":
                d_inner, H = ssm.dims(cfg)
                s = cfg.ssm
                return {"ssd": {
                    "state": zeros((batch, H, s.head_dim, s.d_state),
                                   torch.float32),
                    "conv": zeros((batch, s.conv_width - 1,
                                   d_inner + 2 * s.d_state))}}
            if paged is None:
                c = {"attn": attention.init_cache(cfg, kind, batch, seq_len,
                                                  dtype, dev)}
            else:
                c = {"attn": attention.init_paged_cache(
                    cfg, kind, batch, seq_len, *paged, dtype, dev)}
            if cfg.enc_dec:
                c["cross"] = cross()
            return c
        return {f"l{i}": layer(kind)
                for i, kind in enumerate(T.layer_kinds(cfg))}

    def batch_specs(self, shape) -> dict:
        """Meta tensors of one input batch of ``shape`` (a ``ShapeConfig``),
        in the reference's shapes and dtypes: int32 ``tokens``, and the
        vision family's ``patch_embeds`` or the encoder-decoder's
        ``frames`` in the compute dtype."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dtype = dtype_of(self.run.compute_dtype)

        def meta(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")
        if cfg.frontend == "vision":
            P = cfg.n_frontend_tokens
            return {"tokens": meta((B, S - P), torch.int32),
                    "patch_embeds": meta((B, P, cfg.d_model), dtype)}
        if cfg.enc_dec:
            return {"tokens": meta((B, S), torch.int32),
                    "frames": meta((B, S, cfg.d_model), dtype)}
        return {"tokens": meta((B, S), torch.int32)}

    def cache_specs(self, batch: int, seq_len: int) -> dict:
        """``init_cache``'s tree as meta tensors (no memory)."""
        return self.init_cache(batch, seq_len, device="meta")

    def param_specs(self, seed: int = 0) -> dict:
        """``init``'s tree as meta tensors (no memory)."""
        return self.init(torch.Generator().manual_seed(seed), device="meta")


def build(cfg: ModelConfig, run: RunConfig | None = None) -> Model:
    return Model(cfg, run or RunConfig())

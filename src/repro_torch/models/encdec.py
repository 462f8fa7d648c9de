"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``).

The conv/audio frontend is a stub, as in the reference: callers feed
precomputed frame embeddings (B, S_enc, D) to the encoder. LayerNorm, GELU,
biased projections (``bq``, ``bv``, ``bo``; no ``bk``) and sinusoidal
positions; the decoder has causal self-attention and cross-attention over
the encoder output.

Parameters are a plain dict with the reference's keys; ``enc_layers`` and
``dec_layers`` are Python lists of per-layer dicts (a loop replaces the
reference's ``lax.scan``). Under ``cfg.remat`` each layer is recomputed
in the backward (``common.remat_call``; the reference's ``jax.checkpoint``),
which changes memory, not values. Caches are
dicts of tensors written in place: the self-attention cache grows a token
per decode step, the cross cache holds the encoder's K/V, written once by
``prefill``. With ``kv_quant`` both are int8 codes with per-(token, head)
scales; the decode step reads the cross cache through
``int8_decode_attention`` at the last encoder index, so every encoder
position is valid.

PTQ covers the decoder only (``quant_blocks``): the encoder runs once in
full precision and every decoder block's apply bakes its output for the
whole calibration set, so a block can only take the whole set at once
(``recipe.batch_size >= n_calib``), as in the reference, which fails with a
reshape error where the port raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.context import QuantCtx
from repro_torch.core.reconstruct import BlockHandle, Site
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.serve import kv as skv

A_NAMES = ("wq", "wk", "wv", "wo")


def _timescale(D: int, device) -> torch.Tensor:
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(10000.0, device=device), 2 * dim / D)


def _sinusoid(S: int, D: int, device) -> torch.Tensor:
    """(S, D) float32: sin then cos of pos / 10000^(2i/D)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    ang = pos / _timescale(D, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid_at(pos, D: int, device) -> torch.Tensor:
    """(D,) float32 embedding of one position (an int or a 0-d tensor)."""
    p = torch.as_tensor(pos, device=device).float()
    ang = p / _timescale(D, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_params(gen, cfg, dtype, device) -> dict:
    D, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    s = D**-0.5
    normal = common.normal

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "wq": normal(gen, (D, H * Dh), s, dtype, device),
        "bq": zeros(H * Dh),
        "wk": normal(gen, (D, H * Dh), s, dtype, device),
        "wv": normal(gen, (D, H * Dh), s, dtype, device),
        "bv": zeros(H * Dh),
        "wo": normal(gen, (H * Dh, D), (H * Dh) ** -0.5, dtype, device),
        "bo": zeros(D),
    }


def _mlp_params(gen, cfg, dtype, device) -> dict:
    p = common.mlp_params(gen, cfg.d_model, cfg.d_ff, "gelu", dtype, device)
    p["b_up"] = torch.zeros((cfg.d_ff,), dtype=dtype, device=device)
    p["b_down"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def _enc_layer_params(gen, cfg, dtype, device) -> dict:
    return {
        "ln1": common.norm_params("layernorm", cfg.d_model, dtype, device),
        "attn": _attn_params(gen, cfg, dtype, device),
        "ln2": common.norm_params("layernorm", cfg.d_model, dtype, device),
        "mlp": _mlp_params(gen, cfg, dtype, device),
    }


def _dec_layer_params(gen, cfg, dtype, device) -> dict:
    return {
        "ln1": common.norm_params("layernorm", cfg.d_model, dtype, device),
        "attn": _attn_params(gen, cfg, dtype, device),
        "ln_x": common.norm_params("layernorm", cfg.d_model, dtype, device),
        "xattn": _attn_params(gen, cfg, dtype, device),
        "ln2": common.norm_params("layernorm", cfg.d_model, dtype, device),
        "mlp": _mlp_params(gen, cfg, dtype, device),
    }


def _mha(p, xq, xkv, ctx, name, causal, cfg, kv_override=None):
    """Multi-head attention of ``xq`` over ``xkv`` (or over the given
    ``kv_override`` = (k, v)); returns (out, (k, v))."""
    B, Sq, _ = xq.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q = common.split_heads(ctx.linear(f"{name}.wq", xq, p["wq"], p["bq"]),
                           H, Dh)
    if kv_override is None:
        k = common.split_heads(ctx.linear(f"{name}.wk", xkv, p["wk"]), H, Dh)
        v = common.split_heads(
            ctx.linear(f"{name}.wv", xkv, p["wv"], p["bv"]), H, Dh)
    else:
        k, v = kv_override
    o = attn.attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    out = ctx.linear(f"{name}.wo", common.merge_heads(o), p["wo"], p["bo"])
    return out, (k, v)


def _one_token_attn(p, z, ctx, name, cfg, attend):
    """q of one token, ``attend(q)`` over a cache, then the output
    projection: the decode form of ``_mha``."""
    B = z.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    q = common.split_heads(ctx.linear(f"{name}.wq", z, p["wq"], p["bq"]),
                           H, Dh)
    return ctx.linear(f"{name}.wo", attend(q).reshape(B, 1, H * Dh), p["wo"],
                      p["bo"])


class EncDecLM:
    def __init__(self, cfg):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM takes the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` (on its own device), in
        the config's dtype, placed on ``device`` (None means CUDA)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        return {
            "embed": common.normal(generator, (cfg.vocab, cfg.d_model), 0.02,
                                   dtype, dev),
            "enc_layers": [_enc_layer_params(generator, cfg, dtype, dev)
                           for _ in range(cfg.enc_layers)],
            "enc_norm": common.norm_params("layernorm", cfg.d_model, dtype,
                                           dev),
            "dec_layers": [_dec_layer_params(generator, cfg, dtype, dev)
                           for _ in range(cfg.n_layers)],
            "dec_norm": common.norm_params("layernorm", cfg.d_model, dtype,
                                           dev),
            "lm_head": common.normal(generator, (cfg.d_model, cfg.vocab),
                                     cfg.d_model**-0.5, dtype, dev),
        }

    # ------------------------------------------------------------ encoder
    def encode(self, params, frames: torch.Tensor, ctx) -> torch.Tensor:
        """frames: precomputed (B, S_enc, D) embeddings (the frontend
        stub) -> the encoder output, attention over every frame (no
        mask). Sites are named ``enc.*``."""
        cfg = self.cfg
        B, S, D = frames.shape
        x = frames + _sinusoid(S, D, frames.device).to(frames.dtype)[None]
        def layer(p_l, h):
            z = common.apply_norm("layernorm", h, p_l["ln1"])
            a, _ = _mha(p_l["attn"], z, z, ctx, "enc.attn", False, cfg)
            h = h + a
            z = common.apply_norm("layernorm", h, p_l["ln2"])
            return h + common.mlp(p_l["mlp"], z, ctx, "enc.mlp", "gelu")

        for p_l in params["enc_layers"]:
            x = common.remat_call(cfg.remat, layer, p_l, x)
        return common.apply_norm("layernorm", x, params["enc_norm"])

    # ------------------------------------------------------------ decoder
    def _dec_layer(self, p_l, h, enc_out, ctx, name, collect=False,
                   self_kv=None, cross_kv=None, pos=None):
        """One decoder layer. Full sequence (``self_kv`` None): causal
        self-attention, cross-attention over ``enc_out`` (or over the
        cached ``cross_kv`` = (k, v)). Decode: ``self_kv`` is the layer's
        cache, (k, v) or int8 (k, k_scale, v, v_scale), read up to
        ``pos``; an int8 ``cross_kv`` (4 tensors) is read at its last
        index. ``collect`` also returns ((k, v) of self-attention, (k, v)
        of cross-attention); None where the layer read a cache."""
        cfg = self.cfg
        z = common.apply_norm("layernorm", h, p_l["ln1"])
        if self_kv is None:
            a, self_out = _mha(p_l["attn"], z, z, ctx, f"{name}.attn", True,
                               cfg)
        else:
            if len(self_kv) == 4:
                def attend(q):
                    return skv.int8_decode_attention(q, *self_kv, pos)
            else:
                def attend(q):
                    return attn.decode_attention(q, self_kv[0], self_kv[1],
                                                 pos)
            a = _one_token_attn(p_l["attn"], z, ctx, f"{name}.attn", cfg,
                                attend)
            self_out = None
        h = h + a
        z = common.apply_norm("layernorm", h, p_l["ln_x"])
        if cross_kv is not None and len(cross_kv) == 4:
            # int8 cross cache: every encoder position is valid, so the
            # bidirectional Sq=1 attention is decode attention at the last
            # encoder index
            last = cross_kv[0].shape[1] - 1
            xa = _one_token_attn(
                p_l["xattn"], z, ctx, f"{name}.xattn", cfg,
                lambda q: skv.int8_decode_attention(q, *cross_kv, last))
            xkv = None
        elif cross_kv is not None and common.is_dtensor(cross_kv[0]):
            # a sequence-parallel cross cache: the same decode attention
            # at the last encoder index, which never gathers the cache
            last = cross_kv[0].shape[1] - 1
            xa = _one_token_attn(
                p_l["xattn"], z, ctx, f"{name}.xattn", cfg,
                lambda q: attn.decode_attention(q, *cross_kv, last))
            xkv = None
        else:
            xa, xkv = _mha(p_l["xattn"], z, enc_out, ctx, f"{name}.xattn",
                           False, cfg, kv_override=cross_kv)
        h = h + xa
        z = common.apply_norm("layernorm", h, p_l["ln2"])
        h = h + common.mlp(p_l["mlp"], z, ctx, f"{name}.mlp", "gelu")
        if collect:
            return h, (self_out, xkv)
        return h

    def decode_full(self, params, tokens: torch.Tensor, enc_out: torch.Tensor,
                    ctx, collect: bool = False):
        """tokens (B, S) -> (normed hidden (B, S, D), per-layer
        ((k, v), (xk, xv)) with ``collect``, else None). Sites are named
        ``dec.*``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = common.embed_tokens(params["embed"], tokens)
        x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)[None]
        kvs: List[Tuple] = []
        for p_l in params["dec_layers"]:
            if collect:
                x, kv = self._dec_layer(p_l, x, enc_out, ctx, "dec",
                                        collect=True)
                kvs.append(kv)
            else:
                x = common.remat_call(
                    cfg.remat, lambda p, h: self._dec_layer(p, h, enc_out, ctx,
                                                            "dec"), p_l, x)
        x = common.apply_norm("layernorm", x, params["dec_norm"])
        return x, (kvs if collect else None)

    def loss(self, params, batch: Dict[str, torch.Tensor], ctx
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch`` (``frames``, ``tokens``, ``labels``,
        optional ``mask``): the chunked cross entropy of the decoder over
        the encoded frames. Returns (ce, {"ce"})."""
        enc_out = self.encode(params, batch["frames"], ctx)
        x, _ = self.decode_full(params, batch["tokens"], enc_out, ctx)
        ce = common.fused_cross_entropy(x, params["lm_head"], batch["labels"],
                                        batch.get("mask"), self.cfg.xent_chunk)
        return ce, {"ce": ce}

    # -------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, enc_len: int, dtype=None,
                   kv_quant: bool = False, device: DeviceLike = None):
        """Zeroed self (``k``, ``v``: (L, batch, max_len, H, Dh)) and cross
        (``xk``, ``xv``: (L, batch, enc_len, H, Dh)) caches; ``kv_quant``
        makes both int8 codes with per-(token, head) float32 ``*_scale``
        (..., 1)."""
        cfg = self.cfg
        skv.check_kv_quant_supported(cfg, kv_quant)
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
        cache = {}
        for nm, S in (("k", max_len), ("v", max_len), ("xk", enc_len),
                      ("xv", enc_len)):
            if kv_quant:
                cache[nm] = torch.zeros((L, batch, S, H, Dh), dtype=torch.int8,
                                        device=dev)
                cache[f"{nm}_scale"] = torch.zeros(
                    (L, batch, S, H, 1), dtype=torch.float32, device=dev)
            else:
                cache[nm] = torch.zeros((L, batch, S, H, Dh), dtype=dtype,
                                        device=dev)
        return cache

    def prefill(self, params, tokens: torch.Tensor, frames: torch.Tensor,
                cache, ctx):
        """Encode ``frames`` (B, enc_len, D), run the decoder over
        ``tokens`` (B, S) and fill ``cache`` in place: the self cache's
        first S positions and the whole cross cache. A cross cache of
        another length than the frames' is replaced by one of theirs, as
        the reference's prefill replaces it. Returns (last hidden (B, 1, D),
        cache)."""
        enc_out = self.encode(params, frames, ctx)
        x, kvs = self.decode_full(params, tokens, enc_out, ctx, collect=True)
        S = tokens.shape[1]
        quant = "k_scale" in cache
        S_enc = enc_out.shape[1]
        for nm in ("xk", "xv") + (("xk_scale", "xv_scale") if quant else ()):
            c = cache[nm]
            if c.shape[2] != S_enc:
                cache[nm] = c.new_empty(c.shape[:2] + (S_enc,) + c.shape[3:])
        for li, ((sk, sv), (xk, xv)) in enumerate(kvs):
            for nm, t, sl in (("k", sk, slice(0, S)), ("v", sv, slice(0, S)),
                              ("xk", xk, slice(None)), ("xv", xv, slice(None))):
                if quant:
                    codes, scl = skv.kv_quantize(t)
                    cache[nm][li, :, sl] = codes
                    cache[f"{nm}_scale"][li, :, sl] = scl
                else:
                    cache[nm][li, :, sl] = t.to(cache[nm].dtype)
        return x[:, -1:], cache

    def decode_step(self, params, token: torch.Tensor, cache, pos, ctx):
        """token (B, 1) int at the uniform position ``pos`` (an int or a
        0-d tensor). Writes the self cache in place; returns (logits
        (B, 1, V), cache). Sites are named ``dec.*``, as in the
        reference."""
        cfg = self.cfg
        B = token.shape[0]
        H, Dh = cfg.n_heads, cfg.head_dim
        p_i = int(pos)
        x = common.embed_tokens(params["embed"], token)
        x = x + _sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None]
        quant = "k_scale" in cache
        self_names = ("k", "k_scale", "v", "v_scale") if quant else ("k", "v")
        cross_names = (("xk", "xk_scale", "xv", "xv_scale") if quant
                       else ("xk", "xv"))
        for li, p_l in enumerate(params["dec_layers"]):
            a = p_l["attn"]
            z = common.apply_norm("layernorm", x, p_l["ln1"])
            k = common.split_heads(ctx.linear("dec.attn.wk", z, a["wk"]),
                                   H, Dh)
            v = common.split_heads(
                ctx.linear("dec.attn.wv", z, a["wv"], a["bv"]), H, Dh)
            for nm, t in (("k", k), ("v", v)):
                if quant:
                    codes, scl = skv.kv_quantize(t)
                    common.put_tokens(cache[nm], (li,), p_i, codes)
                    common.put_tokens(cache[f"{nm}_scale"], (li,), p_i, scl)
                else:
                    common.put_tokens(cache[nm], (li,), p_i, t)
            x = self._dec_layer(p_l, x, None, ctx, "dec",
                                self_kv=tuple(cache[n][li] for n in self_names),
                                cross_kv=tuple(cache[n][li]
                                               for n in cross_names),
                                pos=p_i)
        x = common.apply_norm("layernorm", x, params["dec_norm"])
        return self.logits(params, x), cache

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """(..., D) decoder hidden -> (..., V) logits in its dtype."""
        return x @ params["lm_head"].to(x.dtype)

    # ---------------------------------------------------------- PTQ plan
    def quant_blocks(self, params, batch_tokens: torch.Tensor,
                     frames: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[BlockHandle], Any]:
        """Decoder layers only (the encoder stays in full precision, as in
        the reference): (x0 hidden stream, BlockHandles ``layers.<i>`` with
        ten sites each (``attn``/``xattn`` ``wq``/``wk``/``wv``/``wo``,
        ``mlp.w_up``/``w_down``), assemble_fn). The encoder runs once over
        ``frames`` (B, S_enc, D), and every block's apply bakes its output:
        the blocks share the ``apply_key`` ``(call_token,)`` with a token
        fresh to this call. A block applied to fewer rows than ``frames``
        holds raises ``ValueError``: a minibatch smaller than the
        calibration set cannot be paired with the baked encoder output."""
        cfg = self.cfg
        with torch.no_grad():
            enc_out = self.encode(params, frames, QuantCtx(mode="fp"))
        x0 = common.embed_tokens(params["embed"], batch_tokens)
        x0 = x0 + _sinusoid(batch_tokens.shape[1], cfg.d_model,
                            x0.device).to(x0.dtype)[None]
        n_calib = enc_out.shape[0]
        call_token = object()
        blocks = []
        for i, p_l in enumerate(params["dec_layers"]):
            name = f"layers.{i}"
            sites: Dict[str, Site] = {}
            for n in A_NAMES:
                sites[f"{name}.attn.{n}"] = Site(("attn", n))
                sites[f"{name}.xattn.{n}"] = Site(("xattn", n))
            for n in ("w_up", "w_down"):
                sites[f"{name}.mlp.{n}"] = Site(("mlp", n))

            def apply_fn(p, x, ctx, _n=name):
                if x.shape[0] != n_calib:
                    raise ValueError(
                        f"{cfg.name} block {_n}: got {x.shape[0]} rows, but "
                        f"its baked encoder output holds every one of the "
                        f"{n_calib} calibration samples; reconstruct with "
                        f"recipe.batch_size >= {n_calib} (the whole set)")
                return self._dec_layer(p, x, enc_out, ctx, _n)

            blocks.append(BlockHandle(name=name, params=p_l, apply=apply_fn,
                                      sites=sites, apply_key=(call_token,)))

        def assemble(finalized):
            out = dict(params)
            out["dec_layers"] = list(finalized)
            return out

        return x0, blocks, assemble

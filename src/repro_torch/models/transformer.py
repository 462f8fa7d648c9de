"""Decoder-only transformer LM, dense and moe families (port of
``repro/models/transformer.py``).

Parameters are a plain dict with the reference's keys; ``layers`` is a
Python list of per-layer dicts (a plain loop replaces the reference's
``lax.scan``). Every matmul routes through ``QuantCtx``, so the same code
runs the fp teacher, LSQ calibration, the recon forward and int-weight
serving. Caches are dicts of tensors written in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.context import QuantCtx
from repro_torch.core.reconstruct import BlockHandle, Site
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.serve import kv as skv


def _cache_write(buf: torch.Tensor, li: int, pos, val: torch.Tensor) -> None:
    """Insert one token's (B, 1, ...) entry into layer ``li`` of a
    (L, B, Smax, ...) cache at ``pos``: a scalar, or (B,) slot depths."""
    val = val[:, 0].to(buf.dtype)
    if torch.is_tensor(pos) and pos.dim():
        buf[li, torch.arange(val.shape[0], device=buf.device), pos] = val
    else:
        buf[li, :, int(pos)] = val


def _layer_params(gen, cfg, dtype, device, kind: str) -> dict:
    """kind: dense | moe."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D**-0.5
    normal = common.normal
    p = {
        "ln1": common.norm_params(cfg.norm, D, dtype, device),
        "attn": {
            "wq": normal(gen, (D, H * Dh), s, dtype, device),
            "wk": normal(gen, (D, Hkv * Dh), s, dtype, device),
            "wv": normal(gen, (D, Hkv * Dh), s, dtype, device),
            "wo": normal(gen, (H * Dh, D), (H * Dh) ** -0.5, dtype, device),
        },
        "ln2": common.norm_params(cfg.norm, D, dtype, device),
        "mlp": (moe.moe_params(gen, cfg, dtype, device) if kind == "moe"
                else common.mlp_params(gen, D, cfg.d_ff, dtype, device)),
    }
    if cfg.attn_bias:
        for nm, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p["attn"][nm] = torch.zeros((width,), dtype=dtype, device=device)
    return p


class TransformerLM:
    def __init__(self, cfg):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: only the dense and moe families are ported, "
                "see ROADMAP")
        if cfg.use_mla or cfg.first_dense > 0:
            raise NotImplementedError(
                f"{cfg.name}: MLA attention and leading dense layers "
                "(deepseek-v3) are not ported yet, see ROADMAP")
        self.cfg = cfg
        self.kind = "moe" if cfg.is_moe else "dense"

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` (on its own device), in
        the config's dtype, placed on ``device`` (None means CUDA)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        params: Dict[str, Any] = {
            "embed": common.normal(generator, (cfg.vocab, cfg.d_model), 0.02,
                                   dtype, dev),
            "final_norm": common.norm_params(cfg.norm, cfg.d_model, dtype, dev),
            "layers": [_layer_params(generator, cfg, dtype, dev, self.kind)
                       for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = common.normal(
                generator, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5, dtype,
                dev)
        return params

    # ------------------------------------------------------------ layers
    def _rope(self, positions: torch.Tensor):
        return common.rope_sin_cos(positions, self.cfg.head_dim,
                                   self.cfg.rope_theta)

    def _attn_full(self, p, x, ctx, name, sin, cos):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        a = p["attn"]
        q = ctx.linear(f"{name}.wq", x, a["wq"], a.get("bq")).reshape(B, S, H, Dh)
        k = ctx.linear(f"{name}.wk", x, a["wk"], a.get("bk")).reshape(B, S, Hkv, Dh)
        v = ctx.linear(f"{name}.wv", x, a["wv"], a.get("bv")).reshape(B, S, Hkv, Dh)
        q = common.apply_rope(q, sin, cos)
        k = common.apply_rope(k, sin, cos)
        o = attn.attention(q, k, v, causal=True, window=cfg.local_window,
                           chunk=cfg.attn_chunk)
        return ctx.linear(f"{name}.wo", o.reshape(B, S, H * Dh), a["wo"]), (k, v)

    def _ffn(self, p, h, ctx, name):
        """The layer's FFN: (out, aux loss); aux is 0 for a dense layer."""
        if self.kind == "moe":
            return moe.moe_ffn(p["mlp"], h, self.cfg, ctx, name)
        out = common.mlp(p["mlp"], h, ctx, f"{name}.mlp", self.cfg.act)
        return out, torch.zeros((), dtype=torch.float32, device=h.device)

    def layer_apply(self, p, x, ctx, name, sin, cos):
        """Full-sequence layer; returns (y, aux_loss, (k, v))."""
        cfg = self.cfg
        h = common.apply_norm(cfg.norm, x, p.get("ln1"))
        a_out, kv = self._attn_full(p, h, ctx, name, sin, cos)
        x = x + a_out * cfg.resid_mult
        h = common.apply_norm(cfg.norm, x, p.get("ln2"))
        m_out, aux = self._ffn(p, h, ctx, name)
        x = x + m_out * cfg.resid_mult
        return x, aux, kv

    # ----------------------------------------------------------- forward
    def backbone(self, params, tokens: torch.Tensor, ctx: QuantCtx,
                 collect_kv: bool = False):
        """tokens (B, S) -> (hidden (B, S, D), summed aux loss, per-layer
        [(k, v)] or None). Sites are named ``layers.<site>`` (no layer
        index), as in the reference's scanned forward."""
        cfg = self.cfg
        x = common.embed_tokens(params["embed"], tokens, cfg.emb_mult)
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        sin, cos = self._rope(pos)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        for p_l in params["layers"]:
            x, a, kv = self.layer_apply(p_l, x, ctx, "layers", sin, cos)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
        x = common.apply_norm(cfg.norm, x, params.get("final_norm"))
        return x, aux, (kvs if collect_kv else None)

    def lm_head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """(..., D) hidden -> (..., V) logits in the hidden's dtype."""
        return (x @ self.lm_head(params).to(x.dtype)) * self.cfg.logit_mult

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   kv_quant: bool = False, device: DeviceLike = None):
        """Zeroed (L, batch, max_len, Hkv, Dh) K/V cache; ``kv_quant``: int8
        codes plus per-(token, head) float32 scales."""
        cfg = self.cfg
        skv.check_kv_quant_supported(cfg, kv_quant)
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if kv_quant:
            s_shape = kv_shape[:-1] + (1,)
            return {
                "k": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(s_shape, dtype=torch.float32, device=dev),
                "v_scale": torch.zeros(s_shape, dtype=torch.float32, device=dev),
            }
        return {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
                "v": torch.zeros(kv_shape, dtype=dtype, device=dev)}

    def prefill(self, params, tokens: torch.Tensor, cache, ctx: QuantCtx,
                true_len: Optional[torch.Tensor] = None):
        """Run the full sequence and fill ``cache[:, :, :S]`` in place;
        returns (last hidden (B, 1, D), cache). ``true_len`` (B,) marks each
        row's real prompt length inside a right-padded bucket: the hidden is
        gathered at ``true_len - 1``."""
        x, _, kvs = self.backbone(params, tokens, ctx, collect_kv=True)
        S = tokens.shape[1]
        for li, (k, v) in enumerate(kvs):
            if "k_scale" in cache:
                for nm, t in (("k", k), ("v", v)):
                    codes, scl = skv.kv_quantize(t)
                    cache[nm][li, :, :S] = codes
                    cache[f"{nm}_scale"][li, :, :S] = scl
            else:
                cache["k"][li, :, :S] = k.to(cache["k"].dtype)
                cache["v"][li, :, :S] = v.to(cache["v"].dtype)
        if true_len is not None:
            B = x.shape[0]
            idx = torch.as_tensor(true_len, device=x.device).long() - 1
            return x[torch.arange(B, device=x.device), idx][:, None], cache
        return x[:, -1:], cache

    def decode_step(self, params, token: torch.Tensor, cache, pos,
                    ctx: QuantCtx):
        """token (B, 1) int; pos an int (uniform batch) or (B,) int tensor
        (serving slots). Writes the cache in place; returns
        (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x = common.embed_tokens(params["embed"], token, cfg.emb_mult)
        B = x.shape[0]
        if torch.is_tensor(pos) and pos.dim():
            pos_arr = pos.reshape(B, 1)
        else:
            pos_arr = torch.full((B, 1), int(pos), device=x.device)
        sin, cos = self._rope(pos_arr)
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for li, p_l in enumerate(params["layers"]):
            z = common.apply_norm(cfg.norm, x, p_l.get("ln1"))
            a = p_l["attn"]
            q = ctx.linear("layers.wq", z, a["wq"], a.get("bq")).reshape(B, 1, H, Dh)
            k = ctx.linear("layers.wk", z, a["wk"], a.get("bk")).reshape(B, 1, Hkv, Dh)
            v = ctx.linear("layers.wv", z, a["wv"], a.get("bv")).reshape(B, 1, Hkv, Dh)
            q = common.apply_rope(q, sin, cos)
            k = common.apply_rope(k, sin, cos)
            if "k_scale" in cache:
                for nm, t in (("k", k), ("v", v)):
                    codes, scl = skv.kv_quantize(t)
                    _cache_write(cache[nm], li, pos, codes)
                    _cache_write(cache[f"{nm}_scale"], li, pos, scl)
                # dequant-free: scales fold in after the contractions
                o = skv.int8_decode_attention(
                    q, cache["k"][li], cache["k_scale"][li], cache["v"][li],
                    cache["v_scale"][li], pos, window=cfg.local_window)
            else:
                _cache_write(cache["k"], li, pos, k)
                _cache_write(cache["v"], li, pos, v)
                o = attn.decode_attention(q, cache["k"][li], cache["v"][li],
                                          pos, window=cfg.local_window)
            a_out = ctx.linear("layers.wo", o.reshape(B, 1, H * Dh), a["wo"])
            x = x + a_out * cfg.resid_mult
            z = common.apply_norm(cfg.norm, x, p_l.get("ln2"))
            m_out, _ = self._ffn(p_l, z, ctx, "layers")
            x = x + m_out * cfg.resid_mult
        x = common.apply_norm(cfg.norm, x, params.get("final_norm"))
        return self.logits(params, x), cache

    # --------------------------------------------------------- PTQ plan
    def _layer_sites(self, kind: str) -> Dict[str, Site]:
        sites = {f"layers.{n}": Site(("attn", n)) for n in ("wq", "wk", "wv", "wo")}
        if kind == "moe":
            sites.update(moe.moe_sites("layers", self.cfg))
        else:
            sites.update({f"layers.mlp.{n}": Site(("mlp", n))
                          for n in ("w_up", "w_down", "w_gate")})
        return sites

    def quant_blocks(self, params, batch_tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[BlockHandle], Any]:
        """Returns (x0 hidden stream, per-layer BlockHandles, assemble_fn).
        Block sites are named ``layers.<i>.<site>`` so rules such as
        ``layers.0.*`` address one layer; ``assemble_fn(finalized)`` returns
        the params with the finalized (QTensor) layers. Every block carries
        the ``apply_key`` ``(call_token, kind)`` with a token fresh to this
        call (the closures bake its rope tables), so the layers share one
        reconstruction engine per distinct plan."""
        cfg = self.cfg
        x0 = common.embed_tokens(params["embed"], batch_tokens, cfg.emb_mult)
        S = batch_tokens.shape[1]
        # batch-size-1 rope tables broadcast over the calibration batch
        sin, cos = self._rope(torch.arange(S, device=x0.device)[None])
        call_token = object()
        blocks = []
        for i, p_l in enumerate(params["layers"]):
            bname = f"layers.{i}"
            sites = {k.replace("layers", bname, 1): v
                     for k, v in self._layer_sites(self.kind).items()}

            def apply_fn(p, x, ctx, _bn=bname):
                return self.layer_apply(p, x, ctx, _bn, sin, cos)[0]

            blocks.append(BlockHandle(name=bname, params=p_l, apply=apply_fn,
                                      sites=sites,
                                      apply_key=(call_token, self.kind)))

        def assemble(finalized):
            out = dict(params)
            out["layers"] = list(finalized)
            return out

        return x0, blocks, assemble

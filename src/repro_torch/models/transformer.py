"""Decoder-only transformer LM, the dense, moe and vlm families (port of
``repro/models/transformer.py``): qwen2.5, smollm, granite, olmo,
llama4-scout, deepseek-v3 and phi3-vision.

Parameters are a plain dict with the reference's keys; ``layers`` is a
Python list of per-layer dicts (a plain loop replaces the reference's
``lax.scan``). deepseek's leading dense layers are a second list,
``dense_layers``, in front of ``layers``; its attention is MLA
(``models/mla.py``), its cache the compressed latent, and its training loss
adds the mtp head's. Every matmul routes through ``QuantCtx``, so the same code
runs the fp teacher, LSQ calibration, the recon forward and int-weight
serving. Caches are dicts of tensors written in place. A norm without
parameters (``layernorm_nonparam``) has no key in the tree (no ``ln1``,
``ln2`` or ``final_norm``), as in the reference; ``p.get`` then gives None.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.context import QuantCtx
from repro_torch.core.reconstruct import BlockHandle, Site
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, mla, moe
from repro_torch.serve import kv as skv

MTP_WEIGHT = 0.3


def _cache_write(buf: torch.Tensor, li: int, pos, val: torch.Tensor) -> None:
    """Insert one token's (B, 1, ...) entry into layer ``li`` of a
    (L, B, Smax, ...) cache at ``pos``: a scalar, or (B,) slot depths."""
    if torch.is_tensor(pos) and pos.dim():
        val = val[:, 0].to(buf.dtype)
        buf[li, torch.arange(val.shape[0], device=buf.device), pos] = val
    else:
        common.put_tokens(buf, (li,), int(pos), val[:, :1])


def _attn_params(gen, cfg, dtype, device) -> dict:
    if cfg.use_mla:
        return mla.mla_params(gen, cfg, dtype, device)
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D**-0.5
    normal = common.normal
    p = {
        "wq": normal(gen, (D, H * Dh), s, dtype, device),
        "wk": normal(gen, (D, Hkv * Dh), s, dtype, device),
        "wv": normal(gen, (D, Hkv * Dh), s, dtype, device),
        "wo": normal(gen, (H * Dh, D), (H * Dh) ** -0.5, dtype, device),
    }
    if cfg.attn_bias:
        for nm, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[nm] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _layer_params(gen, cfg, dtype, device, kind: str) -> dict:
    """kind: dense | moe."""
    D = cfg.d_model
    p = {
        "ln1": common.norm_params(cfg.norm, D, dtype, device),
        "attn": _attn_params(gen, cfg, dtype, device),
        "ln2": common.norm_params(cfg.norm, D, dtype, device),
        "mlp": (moe.moe_params(gen, cfg, dtype, device) if kind == "moe"
                else common.mlp_params(gen, D, cfg.d_ff, cfg.act, dtype,
                                       device)),
    }
    return {k: v for k, v in p.items() if v is not None}


class TransformerLM:
    def __init__(self, cfg):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: TransformerLM takes the dense, "
                             f"moe and vlm families, not {cfg.family!r}")
        self.cfg = cfg
        self.kind = "moe" if cfg.is_moe else "dense"  # the kind of "layers"

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
        }
        if params["final_norm"] is None:
            del params["final_norm"]
        n_dense = cfg.first_dense if cfg.is_moe else 0
        if n_dense:
            params["dense_layers"] = [
                _layer_params(generator, cfg, dtype, dev, "dense")
                for _ in range(n_dense)]
        params["layers"] = [_layer_params(generator, cfg, dtype, dev, self.kind)
                            for _ in range(cfg.n_layers - n_dense)]
        if not cfg.tie_embeddings:
            params["lm_head"] = common.normal(
                generator, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5, dtype,
                dev)
        if cfg.mtp:
            D = cfg.d_model
            params["mtp"] = {
                "proj": common.normal(generator, (2 * D, D), (2 * D) ** -0.5,
                                      dtype, dev),
                "layer": _layer_params(generator, cfg, dtype, dev, self.kind),
                "norm": common.norm_params("rmsnorm", D, dtype, dev),
            }
        return params

    def _segments(self, params) -> List[Tuple[str, str]]:
        """(params key, kind) of each run of layers, in order: deepseek's
        leading ``dense_layers``, then ``layers``."""
        segs = [("dense_layers", "dense")] if "dense_layers" in params else []
        return segs + [("layers", self.kind)]

    def _all_layers(self, params) -> List[Tuple[dict, str]]:
        """(layer params, kind) of every layer, both segments in order."""
        return [(p_l, kind) for key, kind in self._segments(params)
                for p_l in params[key]]

    # ------------------------------------------------------------ layers
    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return common.rope_sin_cos(
            positions, cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim,
            cfg.rope_theta)

    def _attn_full(self, p, x, ctx, name, sin, cos):
        cfg = self.cfg
        if cfg.use_mla:
            return mla.mla_forward(p["attn"], x, cfg, ctx, name, sin, cos)
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        a = p["attn"]
        q = common.split_heads(
            ctx.linear(f"{name}.wq", x, a["wq"], a.get("bq")), H, Dh)
        k = common.split_heads(
            ctx.linear(f"{name}.wk", x, a["wk"], a.get("bk")), Hkv, Dh)
        v = common.split_heads(
            ctx.linear(f"{name}.wv", x, a["wv"], a.get("bv")), Hkv, Dh)
        q = common.apply_rope(q, sin, cos)
        k = common.apply_rope(k, sin, cos)
        o = attn.attention(q, k, v, causal=True, window=cfg.local_window,
                           chunk=cfg.attn_chunk)
        return ctx.linear(f"{name}.wo", common.merge_heads(o), a["wo"]), (k, v)

    def _ffn(self, p, h, ctx, name, kind):
        """The layer's FFN: (out, aux loss); aux is 0 for a dense layer."""
        if kind == "moe":
            return moe.moe_ffn(p["mlp"], h, self.cfg, ctx, name)
        out = common.mlp(p["mlp"], h, ctx, f"{name}.mlp", self.cfg.act)
        return out, torch.zeros((), dtype=torch.float32, device=h.device)

    def layer_apply(self, p, x, ctx, name, sin, cos,
                    kind: Optional[str] = None):
        """Full-sequence layer of ``kind`` (default: the kind of
        ``layers``); returns (y, aux_loss, kv): (k, v), or MLA's
        (ckv, k_rope)."""
        cfg = self.cfg
        h = common.apply_norm(cfg.norm, x, p.get("ln1"))
        a_out, kv = self._attn_full(p, h, ctx, name, sin, cos)
        x = x + a_out * cfg.resid_mult
        h = common.apply_norm(cfg.norm, x, p.get("ln2"))
        m_out, aux = self._ffn(p, h, ctx, name, kind or self.kind)
        x = x + m_out * cfg.resid_mult
        return x, aux, kv

    # ----------------------------------------------------------- forward
    def backbone(self, params, tokens: torch.Tensor, ctx: QuantCtx,
                 extra_embeds: Optional[torch.Tensor] = None,
                 collect_kv: bool = False):
        """tokens (B, S) [+ (B, P, D) prefix embeddings, e.g. image patches]
        -> (hidden (B, P + S, D), summed aux loss, the kv of every layer
        (both segments, in order) or None). Sites are named
        ``layers.<site>`` (no layer index; ``dense.<site>`` in deepseek's
        leading dense layers), as in the reference's scanned forward.
        Under ``cfg.remat`` each layer is recomputed in the backward."""
        cfg = self.cfg
        x = common.embed_tokens(params["embed"], tokens, cfg.emb_mult)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        sin, cos = self._rope(pos)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        for key, kind in self._segments(params):
            name = "dense" if key == "dense_layers" else "layers"
            for p_l in params[key]:
                x, a, kv = common.remat_call(cfg.remat, self.layer_apply, p_l,
                                             x, ctx, name, sin, cos, kind)
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

    def loss(self, params, batch: Dict[str, torch.Tensor], ctx: QuantCtx
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask`` and ``patch_embeds`` (B, P, D)): the chunked cross entropy
        plus 0.01 x the MoE aux loss, plus ``MTP_WEIGHT`` x the mtp head's
        cross entropy when the config has one. With patch embeddings the
        labels are left-padded by P and the P prefix positions masked out.
        Returns (total, {"ce", "aux"[, "mtp_ce"]})."""
        cfg = self.cfg
        pe = batch.get("patch_embeds")
        x, aux, _ = self.backbone(params, batch["tokens"], ctx, pe)
        mask = batch.get("mask")
        labels = batch["labels"]
        if pe is not None:
            P = pe.shape[1]
            mask = common.pad(mask.float() if mask is not None else
                              torch.ones(labels.shape, dtype=torch.float32,
                                         device=x.device), (P, 0))
            labels = common.pad(labels, (P, 0))
        ce = common.fused_cross_entropy(x, self.lm_head(params), labels, mask,
                                        cfg.xent_chunk, cfg.logit_mult)
        metrics = {"ce": ce, "aux": aux}
        total = ce + 0.01 * aux
        if cfg.mtp:
            mtp_ce = self._mtp_loss(params, x, batch, ctx)
            metrics["mtp_ce"] = mtp_ce
            total = total + MTP_WEIGHT * mtp_ce
        return total, metrics

    def _mtp_loss(self, params, h, batch, ctx):
        """DeepSeek-style 1-depth multi-token prediction: predict t+2 from
        [h_t ; emb(t+1)] through one extra block and the shared head."""
        cfg = self.cfg
        m = params["mtp"]
        emb_next = common.embed_tokens(params["embed"], batch["tokens"],
                                       cfg.emb_mult)
        # align: h[:, :-1] with the embeddings of tokens[:, 1:]
        cat = torch.cat([h[:, :-1], emb_next[:, 1:]], dim=-1)
        z = common.keep_placement(ctx.linear("mtp.proj", cat, m["proj"]))
        z = common.rmsnorm(z, m["norm"]["scale"])
        B, S, _ = z.shape
        sin, cos = self._rope(torch.arange(S, device=z.device)[None].expand(B, S))
        z, _, _ = self.layer_apply(m["layer"], z, ctx, "mtp.layer", sin, cos)
        return common.fused_cross_entropy(z, self.lm_head(params),
                                          batch["labels"][:, 1:], None,
                                          cfg.xent_chunk, cfg.logit_mult)

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   kv_quant: bool = False, device: DeviceLike = None):
        """Zeroed (L, batch, max_len, Hkv, Dh) K/V cache; ``kv_quant``: int8
        codes plus per-(token, head) float32 scales. MLA caches the latent:
        ``ckv`` (L, batch, max_len, kv_lora_rank) and ``kr`` (..., qk_rope_dim)
        (no int8 form: ``kv_quant`` raises)."""
        cfg = self.cfg
        skv.check_kv_quant_supported(cfg, kv_quant)
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        L = cfg.n_layers
        if cfg.use_mla:
            return {
                "ckv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=dev),
                "kr": torch.zeros((L, batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=dev),
            }
        kv_shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
                extra_embeds: Optional[torch.Tensor] = None,
                true_len: Optional[torch.Tensor] = None):
        """Run the full sequence (after the ``extra_embeds`` prefix, if any)
        and fill ``cache[:, :, :S]`` in place; returns (last hidden
        (B, 1, D), cache). ``true_len`` (B,) marks each row's real length
        inside a right-padded bucket: the hidden is gathered at
        ``true_len - 1``."""
        x, _, kvs = self.backbone(params, tokens, ctx, extra_embeds,
                                  collect_kv=True)
        S = x.shape[1]
        names = ("ckv", "kr") if self.cfg.use_mla else ("k", "v")
        for li, kv in enumerate(kvs):
            for nm, t in zip(names, kv):
                if "k_scale" in cache:
                    codes, scl = skv.kv_quantize(t)
                    common.put_tokens(cache[nm], (li,), 0, codes)
                    common.put_tokens(cache[f"{nm}_scale"], (li,), 0, scl)
                else:
                    common.put_tokens(cache[nm], (li,), 0, t)
        if true_len is not None:
            B = x.shape[0]
            idx = torch.as_tensor(true_len, device=x.device).long() - 1
            return x[torch.arange(B, device=x.device), idx][:, None], cache
        return x[:, -1:], cache

    def decode_step(self, params, token: torch.Tensor, cache, pos,
                    ctx: QuantCtx):
        """token (B, 1) int; pos an int (uniform batch) or (B,) int tensor
        (serving slots; MLA takes a scalar only). Writes the cache in place;
        returns (logits (B, 1, V), cache). Sites are named ``layers.<site>``
        in both segments, as in the reference."""
        cfg = self.cfg
        if torch.is_tensor(pos) and pos.dim() and cfg.use_mla:
            raise skv.unsupported(
                "mla", f"{cfg.name}: MLA decode takes a uniform scalar "
                "position; slot-based serving is not supported")
        x = common.embed_tokens(params["embed"], token, cfg.emb_mult)
        B = x.shape[0]
        if torch.is_tensor(pos) and pos.dim():
            pos_arr = pos.reshape(B, 1)
        else:
            pos_arr = torch.full((B, 1), int(pos), device=x.device)
        sin, cos = self._rope(pos_arr)
        for li, (p_l, kind) in enumerate(self._all_layers(params)):
            z = common.apply_norm(cfg.norm, x, p_l.get("ln1"))
            a_out = self._decode_attn(p_l["attn"], z, cache, li, pos, ctx,
                                      sin, cos)
            x = x + a_out * cfg.resid_mult
            z = common.apply_norm(cfg.norm, x, p_l.get("ln2"))
            m_out, _ = self._ffn(p_l, z, ctx, "layers", kind)
            x = x + m_out * cfg.resid_mult
        x = common.apply_norm(cfg.norm, x, params.get("final_norm"))
        return self.logits(params, x), cache

    def _decode_attn(self, a, z, cache, li, pos, ctx, sin, cos):
        """One token's attention of layer ``li``: writes its cache entry
        (the MLA latent; or K/V, int8 with ``k_scale`` in the cache) and
        attends over the cache (MLA in the absorbed form)."""
        cfg = self.cfg
        if cfg.use_mla:
            ckv, kr = mla._kv_latent(a, z, cfg, ctx, "layers", sin, cos)
            _cache_write(cache["ckv"], li, pos, ckv)
            _cache_write(cache["kr"], li, pos, kr)
            return mla.mla_decode(a, z, cfg, ctx, "layers", sin, cos,
                                  cache["ckv"][li], cache["kr"][li], pos)
        B = z.shape[0]
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = common.split_heads(
            ctx.linear("layers.wq", z, a["wq"], a.get("bq")), H, Dh)
        k = common.split_heads(
            ctx.linear("layers.wk", z, a["wk"], a.get("bk")), Hkv, Dh)
        v = common.split_heads(
            ctx.linear("layers.wv", z, a["wv"], a.get("bv")), Hkv, Dh)
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
        return ctx.linear("layers.wo", o.reshape(B, 1, H * Dh), a["wo"])

    # --------------------------------------------------------- PTQ plan
    def _layer_sites(self, kind: str) -> Dict[str, Site]:
        if self.cfg.use_mla:
            sites = mla.mla_sites("layers", self.cfg)
        else:
            sites = {f"layers.{n}": Site(("attn", n))
                     for n in ("wq", "wk", "wv", "wo")}
        if kind == "moe":
            sites.update(moe.moe_sites("layers", self.cfg))
        else:
            # w_gate is a site for swiglu only, as in the reference (a
            # geglu gate stays fp)
            names = ["w_up", "w_down"] + (["w_gate"] if self.cfg.act == "swiglu"
                                          else [])
            sites.update({f"layers.mlp.{n}": Site(("mlp", n)) for n in names})
        return sites

    def quant_blocks(self, params, batch_tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[BlockHandle], Any]:
        """Returns (x0 hidden stream, per-layer BlockHandles, assemble_fn).
        Block sites are named ``layers.<i>.<site>`` so rules such as
        ``layers.0.*`` address one layer; ``assemble_fn(finalized)`` returns
        the params with the finalized (QTensor) layers. Every block carries
        the ``apply_key`` ``(call_token, kind)`` with a token fresh to this
        call (the closures bake its rope tables), so the layers of one kind
        share one reconstruction engine per distinct plan. deepseek's
        leading dense layers come first and the index ``<i>`` runs on over
        both segments; ``assemble_fn`` splits them back into
        ``dense_layers`` and ``layers``. The mtp head is no block: it stays
        in full precision."""
        cfg = self.cfg
        x0 = common.embed_tokens(params["embed"], batch_tokens, cfg.emb_mult)
        S = batch_tokens.shape[1]
        # batch-size-1 rope tables broadcast over the calibration batch
        sin, cos = self._rope(torch.arange(S, device=x0.device)[None])
        call_token = object()
        blocks = []
        for i, (p_l, kind) in enumerate(self._all_layers(params)):
            bname = f"layers.{i}"
            sites = {k.replace("layers", bname, 1): v
                     for k, v in self._layer_sites(kind).items()}

            def apply_fn(p, x, ctx, _bn=bname, _kind=kind):
                return self.layer_apply(p, x, ctx, _bn, sin, cos, _kind)[0]

            blocks.append(BlockHandle(name=bname, params=p_l, apply=apply_fn,
                                      sites=sites,
                                      apply_key=(call_token, kind)))
        segs = self._segments(params)

        def assemble(finalized):
            out = dict(params)
            start = 0
            for key, _ in segs:
                n = len(params[key])
                out[key] = list(finalized[start:start + n])
                start += n
            return out

        return x0, blocks, assemble

"""RecurrentGemma / Griffin hybrid, the hybrid family: RG-LRU recurrent
blocks and local-attention blocks (port of ``repro/models/rglru.py``).

Layer pattern "RRA" (two recurrent blocks per local-attention block). The
RG-LRU linear recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) runs
over the sequence as a log-depth (Hillis-Steele) scan in torch ops for
training and prefill, in place of the reference's
``jax.lax.associative_scan``; decode is the O(1) state update. Local
attention decodes against a ring of ``min(local_window, max_len)`` slots,
so decode memory is O(window), not O(sequence).

Parameters are a plain dict with the reference's keys; ``layers`` is a
Python list of ``{"mix": recurrent or attention block, "ffn": geglu MLP}``
dicts. ``lam``, ``b_a`` and ``b_i`` are float32 whatever the config's
dtype. Quantized sites: ``layers.<i>.{w_x,w_gate,w_o}``,
``layers.<i>.rglru.{w_a,w_i}``, ``layers.<i>.{wq,wk,wv,wo}`` and
``layers.<i>.mlp.{w_up,w_down,w_gate}``: geglu's gate is a site here,
unlike in ``TransformerLM``. Sites carry the layer index in every mode
(the reference unrolls the 26 layers), so deploy mode finds the
activation states. The cache is ``{"layers": [...]}``, one dict a layer,
written in place: ``h`` (B, lru_width) and ``conv`` (B, 3, lru_width), the
last three pre-conv inputs, in float32; or the ring ``k``/``v`` (B, W,
Hkv, Dh) and the positions it holds, ``kpos`` (W,) int32 (-1: empty).
There is no int8 cache (``kv_quant_unsupported:hybrid``).

The reference's GriffinLM has no ``jax.checkpoint``; the port's
``backbone`` recomputes each layer in the backward under ``cfg.remat``
(``common.remat_call``), which changes memory, not values.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.reconstruct import BlockHandle, Site
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.serve import kv as skv

C_RGLRU = 8.0
CONV_TAIL = 3  # the 4-tap conv's state: the last 3 pre-conv inputs


# ------------------------------------------------------------------ RG-LRU
def rglru_params(gen, cfg, dtype, device) -> dict:
    R = cfg.lru_width
    s = R**-0.5
    f32 = dict(dtype=torch.float32, device=device)
    # lam such that a = exp(-c softplus(lam) r) sits in (0.9, 0.999)
    lin = torch.linspace(0.9, 0.999, R, **f32)
    return {
        "w_a": common.normal(gen, (R, R), s, dtype, device),
        "b_a": torch.zeros((R,), **f32),
        "w_i": common.normal(gen, (R, R), s, dtype, device),
        "b_i": torch.zeros((R,), **f32),
        "lam": torch.log(torch.expm1(-torch.log(lin) / C_RGLRU)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _rglru_gates(p, x, ctx, name):
    """(a, b) of the recurrence, float32: a = exp(log_a) with log_a =
    -8 softplus(lam) r, b = sqrt(max(1 - exp(2 log_a), 1e-9)) (i x)."""
    r = torch.sigmoid(ctx.linear(f"{name}.w_a", x, p["w_a"]).float()
                      + p["b_a"])
    i = torch.sigmoid(ctx.linear(f"{name}.w_i", x, p["w_i"]).float()
                      + p["b_i"])
    log_a = -C_RGLRU * _softplus(p["lam"]) * r  # (B,S,R), negative
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i * x.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, for (B, S, R)
    tensors: a Hillis-Steele scan of the pairs (a, b) under the reference's
    combine ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), ceil(log2 S)
    levels of whole-tensor ops (differentiable; no loop over S)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))  # b = 0 before the start
        b = a * b_prev + b
        if 2 * d < S:  # the last level needs no new a
            a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        d *= 2
    return b


def rglru_scan(p, x, ctx, name, h0=None):
    """x (B,S,R) -> (y (B,S,R) in x's dtype, h_final (B,R) float32)."""
    a, b = _rglru_gates(p, x, ctx, name)
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(p, x, ctx, name, h_prev):
    """x (B,1,R), h_prev (B,R) -> (y (B,1,R), h (B,R) float32)."""
    a, b = _rglru_gates(p, x, ctx, name)
    h = a[:, 0] * h_prev.float() + b[:, 0]
    return h[:, None, :].to(x.dtype), h


# ------------------------------------------------------------ block params
def recurrent_block_params(gen, cfg, dtype, device) -> dict:
    D, R = cfg.d_model, cfg.lru_width
    return {
        "ln": common.norm_params("rmsnorm", D, dtype, device),
        "w_x": common.normal(gen, (D, R), D**-0.5, dtype, device),
        "w_gate": common.normal(gen, (D, R), D**-0.5, dtype, device),
        "conv_w": common.normal(gen, (4, R), 0.2, dtype, device),
        "conv_b": torch.zeros((R,), dtype=dtype, device=device),
        "rglru": rglru_params(gen, cfg, dtype, device),
        "w_o": common.normal(gen, (R, D), R**-0.5, dtype, device),
    }


def attn_block_params(gen, cfg, dtype, device) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D**-0.5
    return {
        "ln": common.norm_params("rmsnorm", D, dtype, device),
        "wq": common.normal(gen, (D, H * Dh), s, dtype, device),
        "wk": common.normal(gen, (D, Hkv * Dh), s, dtype, device),
        "wv": common.normal(gen, (D, Hkv * Dh), s, dtype, device),
        "wo": common.normal(gen, (H * Dh, D), (H * Dh) ** -0.5, dtype,
                            device),
    }


def mlp_block_params(gen, cfg, dtype, device) -> dict:
    return {
        "ln": common.norm_params("rmsnorm", cfg.d_model, dtype, device),
        "mlp": common.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                 device),
    }


def _causal_conv(x, w, bias, init=None):
    """The 4-tap causal conv along the sequence in x's dtype: x (B, S, R),
    w (K, R); ``init`` (B, K-1, R) holds the inputs before x (zeros
    without it)."""
    K = w.shape[0]
    if init is None:
        ext = F.pad(x, (0, 0, K - 1, 0))
    else:
        ext = torch.cat([init.to(x.dtype), x], dim=1)
    out = sum(ext[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + bias


# ----------------------------------------------------------- block applies
def _gated_out(p, y, h, x, ctx, name):
    gate = common.gelu(ctx.linear(f"{name}.w_gate", h, p["w_gate"]).float())
    return ctx.linear(f"{name}.w_o", (y.float() * gate).to(x.dtype), p["w_o"])


def recurrent_block(p, x, cfg, ctx, name, h0=None, conv_init=None,
                    return_state=False):
    """The recurrent block over a sequence; with ``return_state`` also
    (h_last (B, R) float32, conv_tail): the last 3 pre-conv inputs."""
    h = common.apply_norm("rmsnorm", x, p["ln"])
    xr = ctx.linear(f"{name}.w_x", h, p["w_x"])
    conv_tail = xr[:, -CONV_TAIL:, :]
    xr = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_init)
    y, h_last = rglru_scan(p["rglru"], xr, ctx, f"{name}.rglru", h0)
    out = x + _gated_out(p, y, h, x, ctx, name)
    if return_state:
        return out, (h_last, conv_tail)
    return out


def recurrent_block_step(p, x, cfg, ctx, name, h_prev, conv_state):
    """Decode step: x (B, 1, D); conv_state (B, 3, R) raw pre-conv inputs.
    Returns (y, h (B, R) float32, conv_state' in x's dtype)."""
    h = common.apply_norm("rmsnorm", x, p["ln"])
    xr = ctx.linear(f"{name}.w_x", h, p["w_x"])
    window = torch.cat([conv_state.to(xr.dtype), xr], dim=1)
    conv_new = window[:, 1:, :]
    xc = torch.einsum("bkc,kc->bc", window.float(),
                      p["conv_w"].float()) + p["conv_b"]
    y, h_new = rglru_step(p["rglru"], xc[:, None, :].to(x.dtype), ctx,
                          f"{name}.rglru", h_prev)
    return x + _gated_out(p, y, h, x, ctx, name), h_new, conv_new


def _qkv(p, h, cfg, ctx, name, sin, cos):
    B, S, _ = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ctx.linear(f"{name}.wq", h, p["wq"]).reshape(B, S, H, Dh)
    k = ctx.linear(f"{name}.wk", h, p["wk"]).reshape(B, S, Hkv, Dh)
    v = ctx.linear(f"{name}.wv", h, p["wv"]).reshape(B, S, Hkv, Dh)
    return (common.apply_rope(q, sin, cos), common.apply_rope(k, sin, cos),
            v)


def local_attn_block(p, x, cfg, ctx, name, sin, cos, return_kv=False):
    """MQA over a sliding window of ``local_window`` keys."""
    B, S, _ = x.shape
    h = common.apply_norm("rmsnorm", x, p["ln"])
    q, k, v = _qkv(p, h, cfg, ctx, name, sin, cos)
    o = attn.attention(q, k, v, causal=True, window=cfg.local_window,
                       chunk=cfg.attn_chunk)
    out = x + ctx.linear(f"{name}.wo",
                         o.reshape(B, S, cfg.n_heads * cfg.head_dim), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def local_attn_block_step(p, x, cfg, ctx, name, sin, cos, k_ring, v_ring,
                          kpos_ring, pos: int):
    """Ring-buffer decode at the Python position ``pos``: writes slot
    ``pos % W`` of k_ring/v_ring (B, W, Hkv, Dh) and kpos_ring (W,) in
    place and attends over the slots whose position lies in (pos - W,
    pos]. Returns (y, k_ring, v_ring, kpos_ring)."""
    B = x.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = k_ring.shape[1]
    h = common.apply_norm("rmsnorm", x, p["ln"])
    q, k, v = _qkv(p, h, cfg, ctx, name, sin, cos)
    slot = pos % W
    k_ring[:, slot] = k[:, 0].to(k_ring.dtype)
    v_ring[:, slot] = v[:, 0].to(v_ring.dtype)
    # fill_ takes pos as a kernel argument; ``kpos_ring[slot] = pos`` would
    # copy a host scalar to the card (and wait for it) on every call
    kpos_ring.narrow(0, slot, 1).fill_(pos)
    qg = q.reshape(B, 1, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_ring.float()) * Dh**-0.5
    valid = (kpos_ring >= 0) & (kpos_ring <= pos) & (kpos_ring > pos - W)
    s = torch.where(valid, s, torch.full_like(s, attn.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, v_ring.float()).to(x.dtype)
    out = x + ctx.linear(f"{name}.wo", o.reshape(B, 1, H * Dh), p["wo"])
    return out, k_ring, v_ring, kpos_ring


# ------------------------------------------------------------------ the LM
class GriffinLM:
    """The unrolled layer pattern (each layer named ``layers.<i>``)."""

    def __init__(self, cfg):
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: GriffinLM takes the hybrid family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        pat = cfg.layer_pattern or "RRA"
        self.kinds = [pat[i % len(pat)] for i in range(cfg.n_layers)]

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random weights drawn from ``generator`` (on its own device), in
        the config's dtype, placed on ``device`` (None means CUDA)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        layers = []
        for kind in self.kinds:
            mix = (recurrent_block_params if kind == "R"
                   else attn_block_params)(generator, cfg, dtype, dev)
            layers.append({"mix": mix,
                           "ffn": mlp_block_params(generator, cfg, dtype,
                                                   dev)})
        return {
            "embed": common.normal(generator, (cfg.vocab, cfg.d_model), 0.02,
                                   dtype, dev),
            "layers": layers,
            "final_norm": common.norm_params("rmsnorm", cfg.d_model, dtype,
                                             dev),
            "lm_head": common.normal(generator, (cfg.d_model, cfg.vocab),
                                     cfg.d_model**-0.5, dtype, dev),
        }

    def _rope(self, B: int, S: int, device, offset: int = 0):
        pos = (offset + torch.arange(S, device=device))[None].expand(B, S)
        return common.rope_sin_cos(pos, self.cfg.head_dim,
                                   self.cfg.rope_theta)

    def _layer(self, i, p, x, ctx, sin, cos, collect=False):
        """Layer ``i``: its mixing block, then the MLP block. Returns (x,
        state): with ``collect`` the recurrent block's (h_last, conv_tail)
        or the attention block's (k, v), else None."""
        cfg = self.cfg
        name = f"layers.{i}"  # canonical "layers.<i>.<site>" naming
        st = None
        if self.kinds[i] == "R":
            x = recurrent_block(p["mix"], x, cfg, ctx, name,
                                return_state=collect)
        else:
            x = local_attn_block(p["mix"], x, cfg, ctx, name, sin, cos,
                                 return_kv=collect)
        if collect:
            x, st = x
        h = common.apply_norm("rmsnorm", x, p["ffn"]["ln"])
        x = x + common.mlp(p["ffn"]["mlp"], h, ctx, f"{name}.mlp", cfg.act)
        return x, st

    def backbone(self, params, tokens: torch.Tensor, ctx,
                 collect: bool = False) -> Tuple[torch.Tensor, List[Any]]:
        """tokens (B, S) -> (final-normed hidden (B, S, D), per-layer states
        (``collect``) or Nones). Under ``cfg.remat`` each layer is
        recomputed in the backward."""
        cfg = self.cfg
        x = common.embed_tokens(params["embed"], tokens, cfg.emb_mult)
        B, S, _ = x.shape
        sin, cos = self._rope(B, S, x.device)
        states = []
        for i, p in enumerate(params["layers"]):
            if collect:
                x, st = self._layer(i, p, x, ctx, sin, cos, True)
            else:
                x = common.remat_call(
                    cfg.remat, lambda p_, x_, _i=i: self._layer(
                        _i, p_, x_, ctx, sin, cos)[0], p, x)
                st = None
            states.append(st)
        x = common.apply_norm("rmsnorm", x, params["final_norm"])
        return x, states

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["lm_head"].to(x.dtype)

    def loss(self, params, batch: Dict[str, torch.Tensor], ctx
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss (``tokens``, ``labels``, optional ``mask``): the
        chunked cross entropy. Returns (ce, {"ce"})."""
        x, _ = self.backbone(params, batch["tokens"], ctx)
        ce = common.fused_cross_entropy(x, params["lm_head"], batch["labels"],
                                        batch.get("mask"), self.cfg.xent_chunk)
        return ce, {"ce": ce}

    # ------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   kv_quant: bool = False, device: DeviceLike = None):
        """Per layer: ``h`` and ``conv`` zeros (float32), or a ring of
        ``W = min(local_window, max_len)`` K/V slots in ``dtype`` (default
        the config's) with ``kpos`` -1. ``kv_quant`` raises
        ``KVQuantUnsupported`` (``kv_quant_unsupported:hybrid``)."""
        cfg = self.cfg
        skv.check_kv_quant_supported(cfg, kv_quant)
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        W = min(cfg.local_window or max_len, max_len)
        f32 = dict(dtype=torch.float32, device=dev)
        layers = []
        for kind in self.kinds:
            if kind == "R":
                layers.append({
                    "h": torch.zeros((batch, cfg.lru_width), **f32),
                    "conv": torch.zeros((batch, CONV_TAIL, cfg.lru_width),
                                        **f32)})
            else:
                shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
                layers.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev),
                    "kpos": torch.full((W,), -1, dtype=torch.int32,
                                       device=dev)})
        return {"layers": layers}

    def prefill(self, params, tokens: torch.Tensor, cache, ctx):
        """Run ``tokens`` (B, S) and write every layer's state into
        ``cache`` in place: the recurrent state and conv tail (left-padded
        with zeros when S < 3), and the last ``min(W, S)`` keys and values
        into the ring slots of their positions. Returns (final-normed
        hidden of the last position (B, 1, D), cache)."""
        x, states = self.backbone(params, tokens, ctx, collect=True)
        S = tokens.shape[1]
        for kind, st, c in zip(self.kinds, states, cache["layers"]):
            if kind == "R":
                h_last, tail = st
                if tail.shape[1] < CONV_TAIL:  # short prefill: left-pad
                    tail = F.pad(tail, (0, 0, CONV_TAIL - tail.shape[1], 0))
                c["h"].copy_(h_last)
                c["conv"].copy_(tail)
            else:
                k, v = st
                W = c["k"].shape[1]
                n = min(W, S)
                positions = torch.arange(S - n, S, device=k.device)
                slots = positions % W
                c["k"][:, slots] = k[:, -n:].to(c["k"].dtype)
                c["v"][:, slots] = v[:, -n:].to(c["v"].dtype)
                c["kpos"][slots] = positions.to(torch.int32)
        return x[:, -1:], cache

    def decode_step(self, params, token: torch.Tensor, cache, pos, ctx):
        """token (B, 1) int at the Python position ``pos`` (a uniform
        batch; the slot engine refuses the family). Updates the cache in
        place; returns (logits (B, 1, V), cache). No device tensor is
        built from ``pos``: the ring slot and the mask compare with it as
        a host scalar."""
        cfg = self.cfg
        pos = int(pos)
        x = common.embed_tokens(params["embed"], token, cfg.emb_mult)
        B = x.shape[0]
        pos_arr = torch.full((B, 1), pos, device=x.device)
        sin, cos = common.rope_sin_cos(pos_arr, cfg.head_dim, cfg.rope_theta)
        for i, (p, c) in enumerate(zip(params["layers"], cache["layers"])):
            name = f"layers.{i}"
            if self.kinds[i] == "R":
                x, h_new, conv_new = recurrent_block_step(
                    p["mix"], x, cfg, ctx, name, c["h"], c["conv"])
                c["h"].copy_(h_new)
                c["conv"].copy_(conv_new)
            else:
                x, _, _, _ = local_attn_block_step(
                    p["mix"], x, cfg, ctx, name, sin, cos, c["k"], c["v"],
                    c["kpos"], pos)
            h = common.apply_norm("rmsnorm", x, p["ffn"]["ln"])
            x = x + common.mlp(p["ffn"]["mlp"], h, ctx, f"{name}.mlp", cfg.act)
        x = common.apply_norm("rmsnorm", x, params["final_norm"])
        return self.logits(params, x), cache

    # --------------------------------------------------------- PTQ plan
    def quant_blocks(self, params, batch_tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[BlockHandle], Any]:
        """(x0 hidden stream, one BlockHandle ``layers.<i>`` per layer,
        assemble_fn). Sites: the MLP's ``w_up``, ``w_down`` and ``w_gate``;
        a recurrent block's ``w_x``, ``w_gate``, ``w_o`` and
        ``rglru.{w_a,w_i}``; an attention block's ``wq``, ``wk``, ``wv`` and
        ``wo``. The ``apply_key`` is ``(call_token, kind)``, kind R or A, with
        a token fresh to this call: two engines per distinct plan."""
        cfg = self.cfg
        x0 = common.embed_tokens(params["embed"], batch_tokens, cfg.emb_mult)
        S = batch_tokens.shape[1]
        sin, cos = self._rope(1, S, x0.device)  # broadcast over the batch
        mlp_names = ["w_up", "w_down"] + (
            ["w_gate"] if cfg.act in ("swiglu", "geglu") else [])
        blocks = []
        call_token = object()
        for i, p_l in enumerate(params["layers"]):
            name = f"layers.{i}"
            sites = {f"{name}.mlp.{n}": Site(("ffn", "mlp", n))
                     for n in mlp_names}
            if self.kinds[i] == "R":
                for n in ("w_x", "w_gate", "w_o"):
                    sites[f"{name}.{n}"] = Site(("mix", n))
                for n in ("w_a", "w_i"):
                    sites[f"{name}.rglru.{n}"] = Site(("mix", "rglru", n))
            else:
                for n in ("wq", "wk", "wv", "wo"):
                    sites[f"{name}.{n}"] = Site(("mix", n))

            def apply_fn(p, x, ctx, _i=i):
                return self._layer(_i, p, x, ctx, sin, cos)[0]

            blocks.append(BlockHandle(name=name, params=p_l, apply=apply_fn,
                                      sites=sites,
                                      apply_key=(call_token, self.kinds[i])))

        def assemble(finalized):
            out = dict(params)
            out["layers"] = list(finalized)
            return out

        return x0, blocks, assemble

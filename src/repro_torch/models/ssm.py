"""Mamba2 (state-space duality, SSD) language model (port of
``repro/models/ssm.py``).

The chunked SSD scan (Dao & Gu 2024, "ssd_minimal") in float32 einsums:
intra-chunk quadratic blocks, per-chunk end states, an inter-chunk state
recurrence (a loop over chunks in place of the reference's ``lax.scan``)
and the off-diagonal term. Decode is the O(1)-state recurrent update.

Quantized sites: ``in_proj`` and ``out_proj``, the two big matmuls. The
depthwise conv1d, A/dt/D and the norms stay in full precision, as in the
reference. Parameters are a plain dict with the reference's keys;
``layers`` is a Python list of per-layer dicts. Caches are dicts of
float32 tensors written in place: ``conv`` (L, B, K-1, conv_dim), the raw
inputs of the conv window, and ``ssm`` (L, B, H, P, N). There is no int8
cache: ``init_cache(kv_quant=True)`` raises ``KVQuantUnsupported``
(``kv_quant_unsupported:ssm``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.reconstruct import BlockHandle, Site
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.serve import kv as skv


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def layer_params(gen, cfg, dtype, device) -> dict:
    """One layer's weights; ``a_log``, ``dt_bias`` and ``d_skip`` are
    float32 whatever the config's dtype."""
    d_inner, n_heads, conv_dim = _dims(cfg)
    D = cfg.d_model
    d_proj = 2 * d_inner + 2 * cfg.ssm_state + n_heads  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": common.norm_params("rmsnorm", D, dtype, device),
        "in_proj": common.normal(gen, (D, d_proj), D**-0.5, dtype, device),
        "conv_w": common.normal(gen, (cfg.ssm_conv, conv_dim), 0.2, dtype,
                                device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "d_skip": torch.ones((n_heads,), **f32),
        "gate_norm": common.norm_params("rmsnorm", d_inner, dtype, device),
        "out_proj": common.normal(gen, (d_inner, D), d_inner**-0.5, dtype,
                                  device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): cs[i] - cs[j] on and below the diagonal,
    -inf above it (set before any ``exp``, so no inf - inf reaches the
    backward)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.full_like(seg, float("-inf")))


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, init_state=None):
    """Chunked SSD scan, float32.

    x  (b, s, h, p)   inputs (already multiplied by dt)
    dA (b, s, h)      per-step log decay (negative)
    Bm (b, s, n), Cm (b, s, n)  input/output projections (one group)
    Returns (y (b, s, h, p), final_state (b, h, p, n)). ``s`` must be a
    multiple of ``min(chunk, s)``, as in the reference."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, f"sequence {s} is no multiple of the chunk {chunk}"
    c = s // chunk
    xc = x.reshape(b, c, chunk, h, p)
    Ac = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)

    A_cum = torch.cumsum(Ac, dim=-1)
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))  # (b,h,c,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # 2. per-chunk end states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    # 3. inter-chunk recurrence; prev[i] is the state entering chunk i
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state)
    chunk_decay = torch.exp(A_cum[..., -1])  # (b,h,c)
    prev = []
    for i in range(c):
        prev.append(st)
        st = st * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (b,c,h,p,n)
    # 4. inter-chunk output contribution
    state_decay = torch.exp(A_cum)  # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, st


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence: xbc (B, S, C), w (K, C),
    in xbc's dtype (not a quantized site)."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(K))
    return out + bias


def _split_proj(zxbcdt: torch.Tensor, cfg):
    d_inner, _, conv_dim = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _gated_out(p, y, z, u, ctx, name):
    """The gate, the gate norm and ``out_proj``."""
    y = common.rmsnorm((y * F.silu(z.float())).to(u.dtype),
                       p["gate_norm"]["scale"])
    return ctx.linear(f"{name}.out_proj", y, p["out_proj"])


def layer_forward(p, u: torch.Tensor, cfg, ctx, name: str, init_state=None,
                  conv_init=None):
    """Full-sequence mamba2 layer. Returns (y, (conv_tail, final_state)):
    the raw (pre-conv) last K-1 inputs of the conv and the SSM state after
    the last token."""
    d_inner, n_heads, _ = _dims(cfg)
    B_, S, _ = u.shape
    h = common.apply_norm("rmsnorm", u, p["ln"])
    zxbcdt = ctx.linear(f"{name}.in_proj", h, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    if conv_init is not None:
        xbc_ext = torch.cat([conv_init.to(xbc.dtype), xbc], dim=1)
        xbc_conv = _causal_conv(xbc_ext, p["conv_w"], p["conv_b"])[:, -S:]
    else:
        xbc_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc_conv = F.silu(xbc_conv.float())
    x = xbc_conv[..., :d_inner].reshape(B_, S, n_heads, cfg.ssm_headdim)
    Bm = xbc_conv[..., d_inner:d_inner + cfg.ssm_state]
    Cm = xbc_conv[..., d_inner + cfg.ssm_state:]

    dt = _softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    dA = -torch.exp(p["a_log"]) * dt  # negative log decay
    y, final_state = ssd_chunked(x * dt[..., None], dA, Bm, Cm,
                                 cfg.attn_chunk, init_state)
    y = y + p["d_skip"][None, None, :, None] * x
    y = y.reshape(B_, S, d_inner)
    out = _gated_out(p, y, z, u, ctx, name)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):, :]
    return u + out, (conv_tail, final_state)


def layer_decode(p, u: torch.Tensor, cfg, ctx, name: str,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token: u (B, 1, D); conv_state (B, K-1, conv_dim) raw inputs;
    ssm_state (B, H, P, N). Returns (y, conv_state', ssm_state')."""
    d_inner, n_heads, _ = _dims(cfg)
    B_ = u.shape[0]
    h = common.apply_norm("rmsnorm", u, p["ln"])
    zxbcdt = ctx.linear(f"{name}.in_proj", h, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)  # (B,1,*)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    conv_state_new = window[:, 1:, :]
    xbc_conv = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xbc_conv = F.silu(xbc_conv)[:, None, :]  # (B,1,conv_dim)
    x = xbc_conv[..., :d_inner].reshape(B_, n_heads, cfg.ssm_headdim)
    Bm = xbc_conv[:, 0, d_inner:d_inner + cfg.ssm_state]
    Cm = xbc_conv[:, 0, d_inner + cfg.ssm_state:]

    dt_ = _softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    dA = torch.exp(-torch.exp(p["a_log"]) * dt_)  # (B,H)
    xdt = x * dt_[..., None]
    ssm_new = (ssm_state * dA[..., None, None]
               + torch.einsum("bhp,bn->bhpn", xdt, Bm))
    y = (torch.einsum("bhpn,bn->bhp", ssm_new, Cm)
         + p["d_skip"][None, :, None] * x)
    y = y.reshape(B_, 1, d_inner)
    return u + _gated_out(p, y, z, u, ctx, name), conv_state_new, ssm_new


class MambaLM:
    def __init__(self, cfg):
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: MambaLM takes the ssm family, not "
                             f"{cfg.family!r}")
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
            "layers": [layer_params(generator, cfg, dtype, dev)
                       for _ in range(cfg.n_layers)],
            "final_norm": common.norm_params("rmsnorm", cfg.d_model, dtype,
                                             dev),
            "lm_head": common.normal(generator, (cfg.d_model, cfg.vocab),
                                     cfg.d_model**-0.5, dtype, dev),
        }

    def backbone(self, params, tokens: torch.Tensor, ctx,
                 collect_state: bool = False) -> torch.Tensor:
        """tokens (B, S) -> normed hidden (B, S, D). Sites are named
        ``layers.*``. ``collect_state`` is the reference's signature; it
        changes nothing there either (``prefill`` collects the states).
        Under ``cfg.remat`` each layer is recomputed in the backward."""
        del collect_state
        cfg = self.cfg
        x = common.embed_tokens(params["embed"], tokens)
        for p_l in params["layers"]:
            x = common.remat_call(
                cfg.remat, lambda p, u: layer_forward(p, u, cfg, ctx,
                                                      "layers")[0], p_l, x)
        return common.apply_norm("rmsnorm", x, params["final_norm"])

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return x @ params["lm_head"].to(x.dtype)

    def loss(self, params, batch: Dict[str, torch.Tensor], ctx
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss (``tokens``, ``labels``, optional ``mask``): the
        chunked cross entropy. Returns (ce, {"ce"})."""
        x = self.backbone(params, batch["tokens"], ctx)
        ce = common.fused_cross_entropy(x, params["lm_head"], batch["labels"],
                                        batch.get("mask"), self.cfg.xent_chunk)
        return ce, {"ce": ce}

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   kv_quant: bool = False, device: DeviceLike = None):
        """Zeroed float32 ``conv`` (L, batch, K-1, conv_dim) and ``ssm``
        (L, batch, H, P, N) states; ``max_len`` and ``dtype`` are unused
        (the state does not grow). ``kv_quant`` raises
        ``KVQuantUnsupported`` (``kv_quant_unsupported:ssm``)."""
        cfg = self.cfg
        skv.check_kv_quant_supported(cfg, kv_quant)
        dev = resolve_device(device)
        _, n_heads, conv_dim = _dims(cfg)
        L = cfg.n_layers
        return {
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=torch.float32, device=dev),
            "ssm": torch.zeros((L, batch, n_heads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=dev),
        }

    def prefill(self, params, tokens: torch.Tensor, cache, ctx):
        """Run ``tokens`` (B, S; S >= K-1, and a multiple of the chunk
        when longer than it) and write every layer's conv tail and final
        state into ``cache`` in place; returns (last hidden (B, 1, D),
        cache)."""
        x = common.embed_tokens(params["embed"], tokens)
        for li, p_l in enumerate(params["layers"]):
            x, (conv_tail, state) = layer_forward(p_l, x, self.cfg, ctx,
                                                  "layers")
            cache["conv"][li] = conv_tail
            cache["ssm"][li] = state
        x = common.apply_norm("rmsnorm", x, params["final_norm"])
        return x[:, -1:], cache

    def decode_step(self, params, token: torch.Tensor, cache, pos, ctx):
        """token (B, 1) int; ``pos`` is unused (the state carries the
        position). Updates the cache in place; returns (logits (B, 1, V),
        cache). Sites are named ``layers.*``, as in the reference."""
        del pos
        x = common.embed_tokens(params["embed"], token)
        for li, p_l in enumerate(params["layers"]):
            x, conv_n, ssm_n = layer_decode(p_l, x, self.cfg, ctx, "layers",
                                            cache["conv"][li],
                                            cache["ssm"][li])
            cache["conv"][li] = conv_n
            cache["ssm"][li] = ssm_n
        x = common.apply_norm("rmsnorm", x, params["final_norm"])
        return self.logits(params, x), cache

    def quant_blocks(self, params, batch_tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[BlockHandle], Any]:
        """(x0 hidden stream, BlockHandles ``layers.<i>`` with the sites
        ``layers.<i>.in_proj`` and ``layers.<i>.out_proj``, assemble_fn).
        Every block carries the ``apply_key`` ``(call_token,)`` with a token
        fresh to this call, so the layers share one engine per plan."""
        cfg = self.cfg
        x0 = common.embed_tokens(params["embed"], batch_tokens)
        call_token = object()
        blocks = []
        for i, p_l in enumerate(params["layers"]):
            bname = f"layers.{i}"
            sites = {f"{bname}.in_proj": Site(("in_proj",)),
                     f"{bname}.out_proj": Site(("out_proj",))}

            def apply_fn(p, x, ctx, _bn=bname):
                return layer_forward(p, x, cfg, ctx, _bn)[0]

            blocks.append(BlockHandle(name=bname, params=p_l, apply=apply_fn,
                                      sites=sites, apply_key=(call_token,)))

        def assemble(finalized):
            out = dict(params)
            out["layers"] = list(finalized)
            return out

        return x0, blocks, assemble

"""Plain forward of a dense decoder-only transformer: pre-norm layers of
rotary GQA attention and a gated (SwiGLU) MLP, the layout of OLMo
(non-parametric LayerNorm) and Qwen2.5 (RMSNorm, QKV bias).

Every matrix product goes through ``lin(site, x, w, b)`` so a caller can
quantize weights or activations, or round them to a lower precision.
Attention is the full softmax over each sequence's causal prefix, one
sequence at a time. Follows the published descriptions; departures: none
beyond the norms' epsilons (1e-5 LayerNorm, 1e-6 RMSNorm).

Precision: ``act`` is the type of the weights and of the stream between
operations. In float32 (the default) everything is float32. In bfloat16,
a configuration's stated type, the weights and every activation a layer
hands on are bfloat16 and products take bfloat16 operands, while norms,
rotary embedding, attention and the gate's SiLU compute in float32 and
round their result.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from bench import weights

Lin = Callable[[str, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def plain_lin(site: str, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


class Model:
    """The reference model of one configuration (its ``arch`` dict) and
    run seed; weights are regenerated from the seed one layer at a time,
    in ``act`` (float32 unless given). A configuration names its reference
    module; every such module has a ``Model`` with ``layer``, ``sites``,
    ``block``, ``embed``, ``final_norm`` and ``head``."""

    SITES = ("wq", "wk", "wv", "wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")

    def __init__(self, arch: Dict[str, Any], seed: int, device,
                 act: torch.dtype = torch.float32):
        self.arch, self.seed, self.device = arch, seed, torch.device(device)
        self.dtype = getattr(torch, arch["dtype"])
        self.act = act
        self.Dh = weights.head_dim(arch)

    # ---------------------------------------------------------- weights
    def layer(self, i: int) -> Dict[str, Dict[str, torch.Tensor]]:
        raw = weights.make_layer(self.arch, self.seed, i, self.device, self.dtype)
        return {g: {k: v.to(self.act) for k, v in d.items()}
                for g, d in raw.items()}

    def sites(self, p) -> Dict[str, torch.Tensor]:
        """A layer's quantized matrices by site name (``wq``, ``mlp.w_up``)."""
        return {s: p["mlp" if "." in s else "attn"][s.rpartition(".")[2]]
                for s in self.SITES}

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = weights.make_embed(self.arch, self.seed, self.device, self.dtype)
        return F.embedding(tokens.to(self.device), emb).to(self.act) \
            * self.arch.get("emb_mult", 1.0)

    def head(self) -> torch.Tensor:
        if self.arch.get("tie_embeddings"):
            return weights.make_embed(self.arch, self.seed, self.device,
                                      self.dtype).float().T
        return weights.make_head(self.arch, self.seed, self.device,
                                 self.dtype).float()

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        p = weights.make_final_norm(self.arch, self.seed, self.device, self.dtype)
        return self.norm(x, None if p is None else {k: v.float() for k, v in p.items()})

    # ------------------------------------------------------------- math
    def norm(self, x: torch.Tensor, p: Optional[Dict[str, torch.Tensor]]):
        kind = self.arch["norm"]
        x = x.float()
        if kind == "rmsnorm":
            y = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6)
            y = y if p is None else y * (1.0 + p["scale"].float())
            return y.to(self.act)
        mu = x.mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        if kind == "layernorm" and p is not None:
            y = y * p["scale"].float() + p["bias"].float()
        return y.to(self.act)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Rotate-half rotary embedding of x (B, S, H, Dh) at ``pos`` (S,)."""
        half = self.Dh // 2
        freqs = self.arch["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * freqs
        s, c = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(self.act)

    def attention(self, q, k, v) -> torch.Tensor:
        """Causal softmax attention, GQA; q (B, S, H, Dh), k/v (B, S, Hkv, Dh);
        float32 inside."""
        q, k, v = q.float(), k.float(), v.float()
        B, S, H, Dh = q.shape
        g = H // k.shape[2]
        out = []
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        for b in range(B):
            kb = k[b].repeat_interleave(g, dim=1)
            vb = v[b].repeat_interleave(g, dim=1)
            s = torch.einsum("qhd,khd->hqk", q[b], kb) * Dh ** -0.5
            s = s.masked_fill(~mask, float("-inf"))
            out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vb))
        return torch.stack(out).to(self.act)

    def block(self, p, x: torch.Tensor, lin: Lin = plain_lin,
              name: str = "layers") -> torch.Tensor:
        """One layer over x (B, S, D); sites are named ``<name>.wq``,
        ``<name>.mlp.w_up`` and so on."""
        a = self.arch
        B, S, _ = x.shape
        H, Hkv, Dh = a["n_heads"], a["n_kv_heads"], self.Dh
        pos = torch.arange(S, device=x.device)
        at = p["attn"]
        h = self.norm(x, p.get("ln1"))
        q = lin(f"{name}.wq", h, at["wq"], at.get("bq")).view(B, S, H, Dh)
        k = lin(f"{name}.wk", h, at["wk"], at.get("bk")).view(B, S, Hkv, Dh)
        v = lin(f"{name}.wv", h, at["wv"], at.get("bv")).view(B, S, Hkv, Dh)
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        x = x + lin(f"{name}.wo", o.reshape(B, S, H * Dh), at["wo"], None) \
            * a.get("resid_mult", 1.0)
        h = self.norm(x, p.get("ln2"))
        m = p["mlp"]
        gate = lin(f"{name}.mlp.w_gate", h, m["w_gate"], None)
        up = lin(f"{name}.mlp.w_up", h, m["w_up"], None)
        y = lin(f"{name}.mlp.w_down", F.silu(gate.float()).to(self.act) * up,
                m["w_down"], None)
        return x + y * a.get("resid_mult", 1.0)

"""Weights and token streams made from ``--seed``, on the run's device.

Both sides of a comparison take their inputs from here: the program gets
the parameter tree in the layout of ``repro_torch``'s transformer, the plain
reference regenerates any one layer on its own (each layer has a generator
of its own, seeded from the run's seed and the layer's index), so it never
reads a tensor the program has held. Each layer's matrices come from one
``torch.randn`` call in the served dtype, scaled in place.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import torch


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of a run seeded ``seed``."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, tag))
    return gen


def head_dim(arch: Dict[str, Any]) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def layer_matrices(arch: Dict[str, Any]) -> List[Tuple[Tuple[str, str], Tuple[int, int], float]]:
    """((group, name), shape, std) of one layer's matrices, in draw order."""
    D, F = arch["d_model"], arch["d_ff"]
    H, Hkv, Dh = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    out = [(("attn", "wq"), (D, H * Dh), D ** -0.5),
           (("attn", "wk"), (D, Hkv * Dh), D ** -0.5),
           (("attn", "wv"), (D, Hkv * Dh), D ** -0.5),
           (("attn", "wo"), (H * Dh, D), (H * Dh) ** -0.5),
           (("mlp", "w_up"), (D, F), D ** -0.5),
           (("mlp", "w_down"), (F, D), F ** -0.5)]
    if arch["act"] in ("swiglu", "geglu"):
        out.append((("mlp", "w_gate"), (D, F), D ** -0.5))
    return out


def layer_vectors(arch: Dict[str, Any]) -> List[Tuple[Tuple[str, str], int, float, float]]:
    """((group, name), size, mean, std) of one layer's vectors: norm scales
    (rmsnorm's zero-centred gamma) and the QKV biases."""
    D = arch["d_model"]
    H, Hkv, Dh = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    out = []
    if arch["norm"] == "rmsnorm":
        out += [(("ln1", "scale"), D, 0.0, 0.1), (("ln2", "scale"), D, 0.0, 0.1)]
    elif arch["norm"] == "layernorm":
        out += [(("ln1", "scale"), D, 1.0, 0.1), (("ln1", "bias"), D, 0.0, 0.1),
                (("ln2", "scale"), D, 1.0, 0.1), (("ln2", "bias"), D, 0.0, 0.1)]
    if arch.get("attn_bias"):
        out += [(("attn", "bq"), H * Dh, 0.0, 0.1),
                (("attn", "bk"), Hkv * Dh, 0.0, 0.1),
                (("attn", "bv"), Hkv * Dh, 0.0, 0.1)]
    return out


def make_layer(arch: Dict[str, Any], seed: int, index: int, device,
               dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """Layer ``index``'s parameters as ``{group: {name: tensor}}``."""
    gen = generator(seed, f"layer.{index}", device)
    mats = layer_matrices(arch)
    total = sum(a * b for _, (a, b), _ in mats)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for (group, name), (a, b), std in mats:
        out.setdefault(group, {})[name] = flat[at:at + a * b].view(a, b).mul_(std)
        at += a * b
    vecs = layer_vectors(arch)
    if vecs:
        small = torch.randn(sum(n for _, n, _, _ in vecs), generator=gen,
                            dtype=torch.float32, device=device)
        at = 0
        for (group, name), n, mean, std in vecs:
            out.setdefault(group, {})[name] = (
                small[at:at + n] * std + mean).to(dtype)
            at += n
    return out


def make_embed(arch: Dict[str, Any], seed: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    gen = generator(seed, "embed", device)
    return torch.randn((arch["vocab"], arch["d_model"]), generator=gen,
                       dtype=dtype, device=device).mul_(0.02)


def make_head(arch: Dict[str, Any], seed: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    gen = generator(seed, "head", device)
    return torch.randn((arch["d_model"], arch["vocab"]), generator=gen,
                       dtype=dtype, device=device).mul_(arch["d_model"] ** -0.5)


def make_final_norm(arch: Dict[str, Any], seed: int, device,
                    dtype: torch.dtype):
    if arch["norm"] != "rmsnorm":
        return None
    gen = generator(seed, "final_norm", device)
    return {"scale": (torch.randn((arch["d_model"],), generator=gen,
                                  device=device) * 0.1).to(dtype)}


def program_params(arch: Dict[str, Any], seed: int, device,
                   head: bool = True) -> Dict[str, Any]:
    """The parameter tree ``repro_torch``'s transformer reads (its
    ``init``'s layout), every tensor from the seed."""
    dtype = getattr(torch, arch["dtype"])
    params: Dict[str, Any] = {"embed": make_embed(arch, seed, device, dtype)}
    fn = make_final_norm(arch, seed, device, dtype)
    if fn is not None:
        params["final_norm"] = fn
    params["layers"] = [make_layer(arch, seed, i, device, dtype)
                        for i in range(arch["n_layers"])]
    if head and not arch.get("tie_embeddings"):
        params["lm_head"] = make_head(arch, seed, device, dtype)
    return params


def tokens(seed: int, tag: str, shape, vocab: int, device) -> torch.Tensor:
    """Uniform token ids in [0, vocab) of ``shape`` (int64)."""
    gen = generator(seed, tag, device)
    return torch.randint(0, vocab, tuple(shape), generator=gen, device=device)


def zipf_tokens(seed: int, tag: str, n: int, length: int, vocab: int,
                exponents, device) -> torch.Tensor:
    """``n`` sequences of ``length`` token ids, like documents: each draws
    from a Zipf law (the frequency of the r-th commonest token falls as
    r^-a) over its own random ranking of the vocabulary, its exponent ``a``
    uniform over ``exponents``. Rows then differ as documents do, in which
    tokens they use and how often they repeat them."""
    gen = generator(seed, tag, device)
    lo, hi = exponents
    a = lo + (hi - lo) * torch.rand((n, 1), generator=gen, device=device,
                                    dtype=torch.float64)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks[None, :] ** -a, dim=1)
    cdf = cdf / cdf[:, -1:]
    u = torch.rand((n, length), generator=gen, device=device,
                   dtype=torch.float64)
    r = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    order = torch.argsort(torch.rand((n, vocab), generator=gen, device=device),
                          dim=1)
    return torch.gather(order, 1, r)

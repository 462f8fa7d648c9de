"""Attention primitives (port of ``repro/models/attention.py``): chunked
online-softmax attention for prefill, single-token decode attention and
``attention_full``, the plain O(Sq * Sk) oracle.

Both support GQA (n_kv_heads <= n_heads), causal masking and sliding
windows, in float32. The chunked path scans KV chunks with a running
(max, sum, acc), so the (Sq, Sk) score matrix exists one chunk at a time.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.models import common

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int):
    """(Sq, Sk) boolean validity mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              chunk: int = 1024, kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q.dtype.

    Causal self-attention longer than one chunk splits the queries into at
    most four chunks, each against its causal KV prefix, as the reference
    does (same math, fewer flops). On DTensors it runs on each rank's
    shards (``_per_rank``)."""
    if common.is_dtensor(q):
        return _per_rank(functools.partial(
            attention, causal=causal, window=window, q_offset=q_offset,
            chunk=chunk, kv_len=kv_len), q, k, v)
    Sq, Sk = q.shape[1], k.shape[1]
    if (causal and window == 0 and q_offset == 0 and Sq == Sk
            and kv_len is None and chunk < Sq and Sq % chunk == 0):
        n_q = 4 if Sq <= 8192 else 2
        qchunk = max(chunk, Sq // n_q)
        outs = []
        for i in range(Sq // qchunk):
            hi = (i + 1) * qchunk
            outs.append(_attention_inner(
                q[:, i * qchunk:hi], k[:, :hi], v[:, :hi], causal=True,
                window=0, q_offset=i * qchunk, chunk=chunk, kv_len=None))
        return torch.cat(outs, dim=1)
    return _attention_inner(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, chunk=chunk, kv_len=kv_len)


def _per_rank(fn, q, k, v):
    """``fn(q, k, v)`` on DTensors: attention is local to a batch row and a
    KV head group, so q, k and v take the batch over the data axes and the
    heads over ``model`` where both head counts divide it (else
    replicated), and ``fn`` runs on each rank's shards (``local_map``)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    h_ax = "model" if q.shape[2] % m == 0 and k.shape[2] % m == 0 else None
    with common.ambient_mesh(mesh):
        q, k, v = (common.shard_hint(t, "dp", None, h_ax, None)
                   for t in (q, k, v))
    return local_map(fn, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=mesh)(q, k, v)


def _attention_inner(q, k, v, *, causal, window, q_offset, chunk, kv_len):
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = D**-0.5
    chunk = min(chunk, Sk)
    if Sk % chunk:  # pad KV to a chunk multiple; padded keys masked by kv_len
        pad = chunk - Sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = min(kv_len, Sk) if kv_len is not None else Sk
        Sk += pad
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    m_run = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32, device=dev)
    for start in range(0, Sk, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        k_pos = start + torch.arange(chunk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
        valid = _mask(q_pos, k_pos, causal, window)
        if kv_len is not None:
            valid = valid & (k_pos[None, :] < kv_len)
        s = torch.where(valid[None, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,Hkv,G,Sq,Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv)
    return out.to(q.dtype)


def batch_only(q: torch.Tensor) -> torch.Tensor:
    """A decode query as the caches hold it: the batch over the data axes,
    the heads replicated (the caches shard the sequence, not the heads,
    over ``model``). The identity on a plain tensor."""
    if not common.is_dtensor(q):
        return q
    with common.ambient_mesh(q.device_mesh):
        return common.shard_hint(q, "dp")


def softmax_last(s: torch.Tensor) -> torch.Tensor:
    """``torch.softmax(s, dim=-1)``. A DTensor sharded along its last dim
    (the scores over a sequence-parallel cache) is normalized by its max
    and its sum, each reduced over the ranks as a small partial (one
    all-reduce each): the scores are never gathered."""
    if not common.is_dtensor(s):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def pos_mask(pos, B: int, Smax: int, window: int, device) -> torch.Tensor:
    """(B, Smax) validity mask for decode; ``pos`` is scalar or (B,)."""
    k_pos = torch.arange(Smax, device=device)
    pos = torch.as_tensor(pos, device=device)
    posb = pos.reshape(-1, 1).expand(B, 1) if pos.dim() else pos.expand(B, 1)
    valid = k_pos[None, :] <= posb
    if window > 0:
        valid &= k_pos[None, :] > posb - window
    return valid


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain O(Sq * Sk)-memory attention, the oracle of the chunked path
    (tests, small shapes): q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D), GQA by
    head groups; keys at or past ``kv_len`` masked out."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (D**-0.5)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    valid = _mask(q_pos, k_pos, causal, window)
    if kv_len is not None:
        valid = valid & (k_pos[None, :] < kv_len)
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode: q (B,1,Hq,D) vs cache (B,Smax,Hkv,D). ``pos`` is
    the current token's index (the cache holds pos+1 valid entries), a
    scalar or (B,) per-slot depths."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    q = batch_only(q)
    qg = q.reshape(B, 1, Hkv, G, D).float()
    s = common.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * (D**-0.5)
    valid = pos_mask(pos, B, Smax, window, q.device)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = softmax_last(s)
    out = common.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)

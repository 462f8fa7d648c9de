"""Shared model components: norms, RoPE, MLPs, embeddings and the chunked
cross entropy (port of ``repro/models/common.py``). The reference's
``stack_layers`` / ``scan_layers`` become a plain Python loop over a list of
per-layer dicts in the models.

Placement hints (``shard_hint``) and the helpers that keep a ``DTensor``
program local where GSPMD keeps the reference's local (``split_heads``,
``merge_heads``, ``put_tokens``, ``local_rows``) act on DTensors only: on a
plain tensor, or with no mesh ambient, each is what the plain code did, so
every path of one process runs as before. They build on ``core.dist``'s
primitives (the ambient mesh, ``is_dtensor``, ``unshard_dp``, ``einsum``),
which the models reach through this module.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.context import QuantCtx
from repro_torch.core.dist import (ambient_mesh, einsum,  # noqa: F401
                                   get_ambient_mesh, is_dtensor,
                                   local_slices, placements, unshard_dp)


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())  # gamma stored zero-centred
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()  # stored as ones, not zero-centred
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Optional[dict]) -> torch.Tensor:
    """kind: rmsnorm | layernorm | layernorm_nonparam (OLMo). Under a mesh
    the stream comes to the norm whole along its width (a partial sum is
    reduced there), its rows over the data axes."""
    x = shard_hint(x, "dp")
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"] if p else None)
    if kind == "layernorm":
        return layernorm(x, p.get("scale") if p else None,
                         p.get("bias") if p else None)
    if kind == "layernorm_nonparam":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def norm_params(kind: str, d: int, dtype, device) -> Optional[dict]:
    """The norm's parameters; None for ``layernorm_nonparam``, whose key the
    models then leave out of the tree, as the reference does."""
    if kind == "rmsnorm":  # gamma, applied as (1 + gamma)
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm_nonparam":
        return None
    raise ValueError(kind)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> sin/cos (..., head_dim/2) in float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B or 1, S, D/2). Rotate-half convention."""
    x32 = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    s = sin[:, :, None, :]
    c = cos[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation, torch's gelu to erf
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x: torch.Tensor, ctx: QuantCtx, name: str,
        act: str = "swiglu", batch_dims: int = 0) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU MLP; every matmul quantizable via ctx.
    ``batch_dims=1``: the weights are stacked experts (E, d_in, d_out) and x
    is (..., E, n, d_in)."""
    if act in ("swiglu", "geglu"):
        g = ctx.linear(f"{name}.w_gate", x, p["w_gate"], batch_dims=batch_dims)
        u = ctx.linear(f"{name}.w_up", x, p["w_up"], batch_dims=batch_dims)
        nl = F.silu if act == "swiglu" else gelu
        h = nl(g.float()).to(x.dtype) * u
    elif act == "gelu":
        h = ctx.linear(f"{name}.w_up", x, p["w_up"], p.get("b_up"),
                       batch_dims=batch_dims)
        h = gelu(h.float()).to(x.dtype)
    else:
        raise ValueError(f"unknown act {act!r}")
    return ctx.linear(f"{name}.w_down", h, p["w_down"], p.get("b_down"),
                      batch_dims=batch_dims)


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
               device, lead: tuple = ()) -> dict:
    """MLP weights; ``w_gate`` only for the gated acts (swiglu, geglu);
    ``lead=(E,)`` stacks E experts in front."""
    std_in = d_model**-0.5
    std_out = d_ff**-0.5
    p = {
        "w_up": normal(gen, lead + (d_model, d_ff), std_in, dtype, device),
        "w_down": normal(gen, lead + (d_ff, d_model), std_out, dtype, device),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, lead + (d_model, d_ff), std_in, dtype,
                             device)
    return p


def normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std^2) drawn on the generator's device, then moved."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return t.to(device=device, dtype=dtype)


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and autograd records, through
    ``torch.utils.checkpoint`` (non-reentrant): the activations inside
    ``fn`` are recomputed in the backward instead of kept, the reference's
    ``jax.checkpoint`` under ``cfg.remat``. Values and gradients are
    unchanged."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 mult: float = 1.0) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens`` times ``mult``. Through
    ``F.embedding``, whose backward sums each row's gradients in a fixed
    order on the CPU; indexing's backward (``index_put_`` with
    ``accumulate=True``) adds them with atomics there, so a training run
    and its resumed copy would differ in the last bits. Under a mesh the
    rows ride the data axes, the width replicated (the stream's placement
    in every layer)."""
    return shard_hint(F.embedding(tokens, unshard_dp(embed)), "dp") * mult


def _chunk_loss(xb: torch.Tensor, lb: torch.Tensor, mb: torch.Tensor,
                w_out: torch.Tensor, logit_scale: float):
    logits = (xb.float() @ w_out.float()) * logit_scale
    if is_dtensor(logits):
        # the vocab may be sharded: reductions over it, each brought whole
        # along the model axis at once (no gather of the logits)
        m = shard_hint(logits.detach().amax(dim=-1, keepdim=True), "dp")
        se = shard_hint(torch.exp(logits - m).sum(-1, keepdim=True), "dp")
        lse = (m + torch.log(se))[..., 0]
        hit = torch.arange(logits.shape[-1], device=lb.device) == lb[..., None]
        gold = shard_hint(torch.where(hit, logits, 0.0).sum(-1), "dp")
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
    return torch.sum((lse - gold) * mb), torch.sum(mb)


def fused_cross_entropy(x: torch.Tensor, w_out: torch.Tensor,
                        labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, chunk: int = 512,
                        logit_scale: float = 1.0) -> torch.Tensor:
    """Mean next-token CE without materializing (B, S, V) logits.

    Loops over sequence chunks of ``chunk`` positions; each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``), so peak
    memory is O(B * chunk * V) instead of O(B * S * V). A remainder becomes
    one extra chunk: on a plain tensor padded to ``chunk`` with mask 0, as
    the reference's ``jnp.pad`` (the same reduction, so the same bits); on a
    DTensor sliced to its own shorter length, because DTensor's
    redistribution planner fails on the pad of a sharded tensor (torch 2.11
    on a CUDA mesh) and the padded rows add only zeros."""
    B, S, D = x.shape
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        # partial sums (the mtp layer's output, which no norm reduces)
        # are summed first: sliced into chunks, DTensor would shard them
        # over the sequence, a placement the logits' product refuses
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    w_out = unshard_dp(w_out)
    chunk = min(chunk, S)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    bounds = [(c * chunk, (c + 1) * chunk) for c in range(n_chunks)]
    if rem and is_dtensor(x):
        bounds.append((S - rem, S))
    elif rem:  # fold the remainder into one extra masked chunk via padding
        pad = chunk - rem
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        bounds.append((S - rem, S - rem + chunk))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in bounds:
        l, n = checkpoint(_chunk_loss, x[:, lo:hi], labels[:, lo:hi].long(),
                          mask[:, lo:hi], w_out, logit_scale,
                          use_reentrant=False)
        tot = tot + l
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------ placements
def pad(x: torch.Tensor, widths, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)`` (constant mode). A DTensor is
    padded shard by shard: DTensor's own pad fails in its redistribution
    planner on a CUDA mesh (torch 2.11), so the padded dims are made whole
    on every rank and partial sums are summed first, then each rank pads
    its piece."""
    if not is_dtensor(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate
    dims = {x.dim() - 1 - i // 2 for i, n in enumerate(widths) if n}
    pl = tuple(Replicate() if p.is_partial() or (p.is_shard() and
                                                 p.dim in dims) else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    shape = list(x.shape)
    for i, n in enumerate(widths):
        shape[x.dim() - 1 - i // 2] += n
    local = F.pad(x.to_local(), widths, value=value)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, x.device_mesh, pl,
                              shape=torch.Size(shape), stride=stride)


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute a DTensor to the placements ``axes`` name on the
    ambient mesh (the reference's ``with_sharding_constraint`` hint).

    ``axes`` entries: None, a mesh axis name, "dp" (the data, and pod,
    axes present), or a tuple of names. Axes missing from the mesh
    degrade to replication, and so does a dim that their size does not
    divide. The identity on a plain tensor or with no ambient mesh."""
    mesh = get_ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    spec = []
    for dim, a in zip(x.shape, axes):
        if a == "dp":
            a = tuple(n for n in ("pod", "data") if n in names)
        elif isinstance(a, str):
            a = (a,) if a in names else ()
        elif isinstance(a, tuple):
            a = tuple(n for n in a if n in names)
        else:
            a = ()
        n = 1
        for nm in a:
            n *= sizes[nm]
        spec.append(a if a and dim % n == 0 else ())
    spec += [()] * (x.dim() - len(spec))
    pl = placements(tuple(spec), mesh)
    y = x.redistribute(mesh, pl)
    if any(p.is_partial() for p in x.placements):
        # the gradient comes to these placements before it reaches x:
        # DTensor turns no partial gradient into x's masked partial (the
        # vocab-parallel embedding's output)
        y = y.redistribute(mesh, pl)
    return y


class _KeepPlacement(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        g = g.redistribute(*ctx.spec)
        return DTensor.from_local(g.to_local().contiguous(), *ctx.spec,
                                  shape=g.shape, stride=g.stride())


def keep_placement(x: torch.Tensor) -> torch.Tensor:
    """The identity, whose gradient comes back to ``x``'s own placements
    (contiguous on each rank) before it goes on. A weight's gradient
    product meets its activation's gradient there, where the layers above
    may have handed it another placement (a norm's backward may shard the
    sequence), which the product then sees flattened and strided: DTensor's
    matmul rule refuses that. The identity on a plain tensor or with no
    ambient mesh."""
    if get_ambient_mesh() is None or not is_dtensor(x):
        return x
    return _KeepPlacement.apply(x)


def split_heads(x: torch.Tensor, n_heads: int,
                head_dim: int) -> torch.Tensor:
    """(..., n_heads * head_dim) -> (..., n_heads, head_dim). A DTensor
    whose last dim is sharded over a mesh dim that ``n_heads`` does not
    divide is first replicated along it: DTensor refuses an uneven
    unflatten, where XLA pads (smollm-135m's 3 KV heads on 16 model
    ranks)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.dim() - 1
        mesh = x.device_mesh
        pl = [Replicate() if p.is_shard(last) and n_heads % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(tuple(x.shape[:-1]) + (n_heads, head_dim))


def local_rows(fn, *args, n_out: int = 1):
    """``fn(*args)`` where each output row depends on the same rows of the
    inputs only (a sequence scan). On DTensors each tensor argument comes
    to its rows over the data axes, the rest replicated, and ``fn`` runs on
    each rank's rows (``local_map``); its ``n_out`` outputs, each
    batch-leading, take the first tensor argument's placements, and the
    gradients need no reduction (every rank holding a row computes it
    whole). Other arguments (ints, None) pass as they are."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    with ambient_mesh(mesh):
        args = tuple(shard_hint(a, "dp") if is_dtensor(a) else a
                     for a in args)
    pl = list(next(a for a in args if is_dtensor(a)).placements)
    return local_map(
        fn, out_placements=pl if n_out == 1 else tuple([pl] * n_out),
        in_placements=tuple(a.placements if is_dtensor(a) else None
                            for a in args),
        device_mesh=mesh)(*args)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., n_heads, head_dim) -> (..., n_heads * head_dim). A DTensor's
    gradient comes back in the merged value's placements, so the
    backward's unflatten never meets a gradient sharded over heads that do
    not divide a mesh dim (``split_heads``' uneven case)."""
    y = o.reshape(tuple(o.shape[:-2]) + (o.shape[-2] * o.shape[-1],))
    if is_dtensor(y):
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def put_tokens(buf: torch.Tensor, lead: tuple, start: int,
               val: torch.Tensor) -> None:
    """``buf[lead + (slice(None), slice(start, start + n))] = val`` in
    place: ``buf`` is (*lead, B, S, ...), ``val`` (B, n, ...) tokens at
    the host positions [start, start + n).

    On a DTensor ``buf`` whose S dim is sharded (the sequence-parallel
    decode caches of ``launch.sharding.cache_spec_tree``) each rank writes
    the positions it holds into its own shard, as XLA's partitioned
    dynamic-update-slice does: ``val`` comes to ``buf``'s placements on the
    other dims (a token is replicated along S; a span that fills S is
    sharded as ``buf`` is), and the cache is never gathered."""
    n = val.shape[1]
    if not is_dtensor(buf):
        buf[lead + (slice(None), slice(start, start + n))] = val.to(buf.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = buf.device_mesh, buf.placements
    k = len(lead)
    s_dim = k + 1
    whole = start == 0 and n == buf.shape[s_dim]
    v_pl = []
    for p in pl:
        if not p.is_shard() or p.dim < k or (p.dim == s_dim and not whole):
            v_pl.append(Replicate())
        else:
            v_pl.append(Shard(p.dim - k))
    if not is_dtensor(val):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    val = val.redistribute(mesh, v_pl).to_local()
    local = buf.to_local()
    held = local_slices(buf.shape, mesh, pl)[s_dim]
    lo, hi = held.start, held.stop
    a, b = max(start, lo), min(start + n, hi)
    if a >= b:
        return  # no position of the span on this rank
    if not whole:
        val = val[:, a - start:b - start]
    local[lead + (slice(None), slice(a - lo, b - lo))] = val.to(local.dtype)

"""DTensor primitives that every layer of the package shares: the ambient
mesh, ``is_dtensor``, placements of a spec, the slices a rank holds, the
FSDP gather before use, and an einsum on local shards.

The kernels (``kernels.ops``), the quantization context, the models
(``models.common``'s hints) and the launcher (``launch.sharding``) import
them from here, so no lower layer reaches up into a higher one.
``torch.distributed.tensor`` is imported only once a DTensor exists
(importing it costs about a second); on a plain tensor each function is
what the plain code did.
"""
from __future__ import annotations

import contextlib
import sys
from typing import List

import torch

_AMBIENT_MESH: List = [None]


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make a ``DeviceMesh`` visible to the model-internal ``shard_hint``s
    (the reference's ``ambient_mesh``)."""
    _AMBIENT_MESH.append(mesh)
    try:
        yield
    finally:
        _AMBIENT_MESH.pop()


def get_ambient_mesh():
    return _AMBIENT_MESH[-1]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``, without importing the module when
    no DTensor can exist yet."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard``
    of the tensor dim whose entry names it, else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for dim, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        for name in names:
            where[name] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def local_slices(shape, mesh, pl) -> tuple:
    """The slice of each dim of a tensor of ``shape`` that this rank holds
    under placements ``pl`` (an even split, the mesh dims that shard one
    tensor dim taken in order, as ``placements`` writes them)."""
    coord = mesh.get_coordinate()
    out = []
    for d, n in enumerate(shape):
        at = 0
        for i, p in enumerate(pl):
            if p.is_shard(d):
                k = mesh.size(i)
                if n % k:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"divide over mesh dim {i} ({k})")
                n //= k
                at = at * k + coord[i]
        out.append(slice(at * n, (at + 1) * n))
    return tuple(out)


def unshard_dp(w: torch.Tensor, keep: tuple = ()) -> torch.Tensor:
    """A DTensor weight gathered over the data axes it is sharded on
    (FSDP's gather before use: GSPMD's choice for the reference's fsdp
    specs, whose gradient comes back as a reduce-scatter); its ``model``
    sharding stays, and so does any sharding of the dims ``keep`` (a
    stacked expert dim: expert parallelism, not FSDP). The identity on a
    plain tensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if n in ("pod", "data") and p.is_shard()
          and p.dim not in keep else p for n, p in zip(names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(
        w.device_mesh, pl)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` (explicit letters, two operands). On two
    DTensors whose placements agree letter by letter (per mesh dim: both
    replicated, both sharded on the same letter, or one sharded on a
    letter the other does not carry) the product runs on each rank's
    shards: a shared contracted letter gives a ``Partial`` result, a kept
    one a ``Shard``. An operand's gradient is then partial over each mesh
    dim that shards the output on a letter the operand lacks (an expert
    weight's over the token groups), else placed as the operand. DTensor's
    own einsum flattens the contracted letters, which a dim sharded over
    two mesh dims (the MoE's full-EP expert dim) does not survive. Other
    placements, and a partial result autograd records, go to
    ``torch.einsum``."""
    if not (is_dtensor(a) and is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    out_pl = []
    for pa, pb in zip(a.placements, b.placements):
        ca = la[pa.dim] if pa.is_shard() else None
        cb = lb[pb.dim] if pb.is_shard() else None
        if not (pa.is_shard() or pa.is_replicate()) or not (
                pb.is_shard() or pb.is_replicate()):
            return torch.einsum(eq, a, b)
        if ca is None and cb is None:
            out_pl.append(Replicate())
        elif ca == cb:
            out_pl.append(Shard(out.index(ca)) if ca in out else Partial())
        elif cb is None and ca in out and ca not in lb:
            out_pl.append(Shard(out.index(ca)))
        elif ca is None and cb in out and cb not in la:
            out_pl.append(Shard(out.index(cb)))
        else:
            return torch.einsum(eq, a, b)
    grads = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if grads and any(p.is_partial() for p in out_pl):
        return torch.einsum(eq, a, b)

    def grad_pl(t, letters):
        return [Partial() if o.is_shard() and out[o.dim] not in letters
                else p for o, p in zip(out_pl, t.placements)]

    def local(x, y):  # shards of strided views: einsum views them whole
        return torch.einsum(eq, x.contiguous(), y.contiguous())

    return local_map(local, out_placements=out_pl,
                     in_placements=(a.placements, b.placements),
                     in_grad_placements=(grad_pl(a, la), grad_pl(b, lb)),
                     device_mesh=a.device_mesh)(a, b)

"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

Functions only: importing this module touches no device and no process
group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, one process (rank) per mesh position:

    production  (16, 16)      data x model        256 ranks
                (2, 16, 16)   pod x data x model  512 ranks (``multi_pod``)
    debug       (2, 4)        data x model        8 ranks
                (2, 2, 2)     pod x data x model  8 ranks
    flat(n)     (n, 1)        data x model        n ranks

The pod axis composes with data for data parallelism (``dp_axes``). A mesh
is built over the process group that ``init_distributed`` starts from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):

    python -m torch.distributed.run --nproc-per-node 8 \\
        -m repro_torch.launch.quantize --arch smollm-135m --mesh debug ...

The backend: NCCL when every rank of a host has a card of its own; gloo on
the CPU, or when several ranks share one card (NCCL refuses two ranks on
one device, "Duplicate GPU detected", so gloo is the only way to run a mesh
of 8 on one card). The choice is printed; a failed NCCL start raises.

``DataParallel.of(mesh)`` is this rank's place on the data-parallel axes:
the process group over them and the collectives the data-parallel
reconstruction issues (``core.reconstruct``, ``allocate``). It uses
``all_reduce`` (SUM, MIN, MAX) and ``barrier`` only: gloo runs those on
CUDA tensors too (staged through the host), where it has no
``reduce_scatter``. Rows are assembled exactly by summing byte views, each
row owned by one rank and zero elsewhere (x + 0 = x, bit for bit).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

_LAYOUTS = {
    ("production", False): ((16, 16), ("data", "model")),
    ("production", True): ((2, 16, 16), ("pod", "data", "model")),
    ("debug", False): ((2, 4), ("data", "model")),
    ("debug", True): ((2, 2, 2), ("pod", "data", "model")),
}


def mesh_layout(kind: str, *, multi_pod: bool = False
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the ``debug`` or ``production`` mesh."""
    return _LAYOUTS[(kind, bool(multi_pod))]


def ranks_needed(kind: str, *, multi_pod: bool = False) -> int:
    return math.prod(mesh_layout(kind, multi_pod=multi_pod)[0])


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: Optional[str] = None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a process group of {need} ranks; "
            "start one first (launch.mesh.init_distributed under torchrun)")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs {need} ranks, the process group "
            f"has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    return _make_mesh(*mesh_layout("production", multi_pod=multi_pod),
                      device_type)


def make_debug_mesh(*, multi_pod: bool = False,
                    device_type: Optional[str] = None):
    """The CI-scale mesh: 8 ranks, (2, 4) or (2, 2, 2)."""
    return _make_mesh(*mesh_layout("debug", multi_pod=multi_pod), device_type)


def make_flat_mesh(n_devices: int, device_type: Optional[str] = None):
    """All ranks on the data axis, (n, 1)."""
    return _make_mesh((n_devices, 1), ("data", "model"), device_type)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names with no process group and no device
    (the reference's ``jax.sharding.AbstractMesh``): what the spec
    functions and the cell programs read.
    ``AbstractMesh(*mesh_layout("production"))`` is the 16 x 16 layout;
    ``AbstractMesh((1, 1), ("data", "model"))`` a world of one, where every
    placement is a whole tensor."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that act as data/FSDP parallel dims."""
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


# ------------------------------------------------------- process group
def init_distributed(device: torch.device) -> Optional[torch.device]:
    """Start the process group from ``torchrun``'s environment and pin this
    rank's card (``LOCAL_RANK % device_count``); returns the rank's device,
    or None (nothing started) when the environment names no world. Prints
    the backend and why it was chosen; a failed NCCL start raises."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kwargs = {}
    if device.type == "cpu":
        backend, why = "gloo", "the CPU"
    else:
        n_cards = torch.cuda.device_count()
        card = local_rank % n_cards
        torch.cuda.set_device(card)
        torch.cuda.init()  # a DeviceMesh must find the card already set
        device = torch.device("cuda", card)
        if local_world <= n_cards:
            backend, why = "nccl", "every rank has a card of its own"
            kwargs["device_id"] = device  # start now: a failure raises here
        else:
            backend = "gloo"
            why = (f"{local_world} ranks share {n_cards} card(s); NCCL "
                   "refuses two ranks on one device")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, **kwargs)
    print(f"distributed: rank {rank} of {world}, backend "
          f"{dist.get_backend()} ({why}), device {device}", flush=True)
    return device


def shutdown() -> None:
    """Destroy the default process group (and every group made from it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def is_writer() -> bool:
    """Whether this process writes the run's shared files: global rank 0,
    or a process outside any group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------- data parallel
class DataParallel:
    """This rank's place on ``mesh``'s data-parallel axes: ``size`` ranks
    along them, this one at ``rank``, ``group`` the process group through
    them. Ranks that differ only along ``model`` sit at the same ``rank``
    in groups of their own and compute the same values. One object per
    mesh (``of`` keeps it on the mesh), so it can key caches."""

    def __init__(self, mesh):
        import torch.distributed as dist
        axes = dp_axes(mesh)
        self.mesh = mesh
        self.size = axis_size(mesh, axes)
        if len(axes) == 1:
            self.group = mesh.get_group(axes[0])
            self.rank = mesh.get_local_rank(axes[0])
        else:  # (pod, data) flattened: one group per model index
            grid = mesh.mesh  # rank ids, (pod, data, model)
            groups = [grid[..., m].reshape(-1).tolist()
                      for m in range(grid.shape[-1])]
            self.group, _ = dist.new_subgroups_by_enumeration(groups)
            self.rank = (mesh.get_local_rank("pod") * axis_size(mesh, "data")
                         + mesh.get_local_rank("data"))
        self.backend = dist.get_backend(self.group)

    @classmethod
    def of(cls, mesh) -> Optional["DataParallel"]:
        if mesh is None:
            return None
        dp = getattr(mesh, "_repro_data_parallel", None)
        if dp is None:
            dp = cls(mesh)
            mesh._repro_data_parallel = dp
        return dp

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives (NCCL's
        can; gloo's run on the host)."""
        return self.backend == "nccl"

    def rows(self, n: int) -> Tuple[int, int]:
        """The rows [lo, hi) of ``n`` this rank keeps: its share when the
        ranks divide ``n``, else all of them (the reference's
        ``stream_spec`` falls back to replication)."""
        if n % self.size:
            return 0, n
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------- collectives
    def all_reduce(self, tensors: Sequence[torch.Tensor],
                   op: str = "sum") -> List[torch.Tensor]:
        """``tensors`` reduced over the group, one collective per dtype
        (the tensors flattened into one buffer); returns new tensors."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=red, group=self.group)
            at = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[at:at + n].view(tensors[i].shape)
                at += n
        return out

    def assemble(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum ``parts`` over the group through byte views: where exactly
        one rank holds a row and every other rank zeros, each rank gets
        that row bit for bit, whatever its dtype. One collective."""
        import torch.distributed as dist
        views = [p.contiguous().reshape(-1).view(torch.uint8) for p in parts]
        flat = torch.cat(views)
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for p, v in zip(parts, views):
            out.append(flat[at:at + v.numel()].clone().view(p.dtype)
                       .view(p.shape))
            at += v.numel()
        return out

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The whole stream of ``n`` rows from each rank's ``rows(n)``."""
        lo, hi = self.rows(n)
        if hi - lo == n:
            return local
        full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[lo:hi] = local
        return self.assemble([full])[0]

"""Checkpoints of the port: atomic save/load of tensor trees, rolling step
checkpoints and per-block PTQ state (the counterpart of
``repro/checkpoint/checkpoint.py``, in a format of its own: the reference
pickles a jax treedef, which the port cannot read without jax).

Format: a checkpoint is a directory holding

  tensors.pt   one ``torch.save`` of a flat ``{path: tensor}`` dict, read
               back with ``torch.load(..., weights_only=True)``; tensors are
               saved from the host, so bfloat16 round-trips bit for bit
  meta.json    the tree's structure (dicts with string keys, lists, QTensors
               with their static fields, JSON scalars, None) and the
               caller's metadata

Atomicity: a save writes a temporary directory beside the target, fsyncs
it, moves the previous checkpoint aside to ``<path>.old`` and renames the
new one into place (``os.replace``), then deletes ``.old``. A kill at any
point leaves a complete checkpoint readable: before the first rename the
old one is untouched; between the two renames ``exists``/``load_pytree``
read ``<path>.old``.

``PTQCheckpointer`` keeps the reconstruction engine's per-block state so a
killed run resumes at the first unfinished block; it records each finished
block's per-site plans and the bit-allocation digest, and a resume under
other rules or another allocation fails loudly ("PTQ resume mismatch").
``save_allocation``/``load_allocation`` keep the allocation itself beside
it (``<dir>/allocation.json``, the reference's JSON document). Under a
data-parallel mesh each rank holds its rows of the streams: ``save``
gathers them, global rank 0 writes the checkpoint of the whole streams and
every rank waits for it at a barrier; ``load`` slices each rank's rows
again, so a checkpoint does not depend on the world size. Reading a
JAX export is outside the port (it needs jax): load it with
``repro.checkpoint.load_pytree`` and carry it across with
``repro_torch.bridge``.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.sink import current_manifest

FORMAT_VERSION = 1
_TENSORS = "tensors.pt"
_META = "meta.json"
_OLD = ".old"
_QT_FIELDS = ("codes", "scale", "zero")


# ------------------------------------------------------------ tree codec
def _host(t: torch.Tensor) -> torch.Tensor:
    """A compact host copy (a CPU view would otherwise save its whole
    storage)."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.cpu()


def _encode(obj: Any, path: str, out: Dict[str, torch.Tensor]) -> Any:
    def put(key: str, t: torch.Tensor) -> Dict[str, str]:
        if key in out:
            raise ValueError(f"checkpoint path {key!r} occurs twice")
        out[key] = _host(t)
        return {"tensor": key}

    if isinstance(obj, torch.Tensor):
        return put(path, obj)
    if isinstance(obj, QTensor):
        return {"qtensor": {f: put(f"{path}/{f}", getattr(obj, f))["tensor"]
                            for f in _QT_FIELDS},
                "shape": list(obj.shape), "bits": obj.bits,
                "packed": obj.packed, "dtype": obj.dtype,
                "pack_axis": obj.pack_axis}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got "
                                f"{k!r} at {path or '/'}")
        return {"dict": {k: _encode(v, f"{path}/{k}", out)
                         for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"list": [_encode(v, f"{path}/{i}", out)
                         for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    raise TypeError(f"cannot checkpoint {type(obj).__name__} at "
                    f"{path or '/'}")


def _decode(node: Any, tensors: Dict[str, torch.Tensor]) -> Any:
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "qtensor" in node:
        return QTensor(**{f: tensors[k] for f, k in node["qtensor"].items()},
                       shape=tuple(node["shape"]), bits=node["bits"],
                       packed=node["packed"], dtype=node["dtype"],
                       pack_axis=node["pack_axis"])
    if "dict" in node:
        return {k: _decode(v, tensors) for k, v in node["dict"].items()}
    if "list" in node:
        return [_decode(v, tensors) for v in node["list"]]
    return node["value"]


# ------------------------------------------------------------- pytree io
def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Atomic save of a tree of tensors and QTensors (see the module
    docstring for the format and the commit protocol)."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    structure = _encode(tree, "", tensors)
    # temporary directories of saves that were killed before their rename
    for stale in glob.glob(os.path.join(parent, f".{name}.tmp-*")):
        shutil.rmtree(stale, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=parent)
    try:
        torch.save(tensors, os.path.join(tmp, _TENSORS))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump({"format": FORMAT_VERSION, "tree": structure,
                       "meta": meta or {}}, f)
        for fn in (_TENSORS, _META):
            _fsync(os.path.join(tmp, fn))
        _fsync(tmp)
        old = path + _OLD
        if os.path.isdir(path):
            if os.path.exists(old):  # left by a save killed after its rename
                shutil.rmtree(old)
            os.replace(path, old)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync(parent)
    shutil.rmtree(path + _OLD, ignore_errors=True)


def _readable(path: str) -> Optional[str]:
    """The directory holding the committed checkpoint at ``path``: ``path``
    itself, or ``path.old`` after a save killed between its renames."""
    for cand in (path, path + _OLD):
        if os.path.isfile(os.path.join(cand, _META)):
            return cand
    return None


def exists(path: str) -> bool:
    return _readable(os.path.abspath(path)) is not None


def load_pytree(path: str, device: DeviceLike = None) -> Tuple[Any, dict]:
    """(tree, meta) of the checkpoint at ``path``, its tensors on
    ``device`` (None means CUDA)."""
    where = _readable(os.path.abspath(path))
    if where is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    with open(os.path.join(where, _META)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format "
                         f"{manifest.get('format')!r}, this reader knows "
                         f"{FORMAT_VERSION}")
    tensors = torch.load(os.path.join(where, _TENSORS),
                         map_location=resolve_device(device),
                         weights_only=True)
    return _decode(manifest["tree"], tensors), manifest["meta"]


# ----------------------------------------------------- allocation artifacts
_ALLOCATION = "allocation.json"


def save_allocation(directory: str, report: dict) -> str:
    """Atomically persist a JSON-able allocation report next to the PTQ
    state (``<dir>/allocation.json``; the document the reference writes)
    so a resumed run can check that it quantizes under the same bit
    allocation (see ``repro_torch.allocate.report``). The JSON goes to an
    fsynced temporary file that ``os.replace`` moves into place, then the
    directory is fsynced: a kill leaves the old file or the new one."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _ALLOCATION)
    fd, tmp = tempfile.mkstemp(prefix=f".{_ALLOCATION}.tmp-", dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync(directory)
    return path


def load_allocation(directory: str) -> Optional[dict]:
    """The report ``save_allocation`` wrote in ``directory``; None if it
    holds none."""
    path = os.path.join(directory, _ALLOCATION)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ----------------------------------------------------------- train ckpts
class CheckpointManager:
    """Rolling step checkpoints: ``save(step, state)`` keeps the newest
    ``keep`` ``step_*`` directories; ``restore(step=None, device=None)``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = set()
        for d in os.listdir(self.dir):
            base = d[:-len(_OLD)] if d.endswith(_OLD) else d
            if (base.startswith("step_") and base[5:].isdigit()
                    and exists(os.path.join(self.dir, base))):
                out.add(int(base[5:]))
        return sorted(out)

    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> str:
        path = self._step_dir(step)
        save_pytree(path, state, dict(meta or {}, step=step))
        for old in self.all_steps()[:-self.keep]:
            for d in (self._step_dir(old), self._step_dir(old) + _OLD):
                shutil.rmtree(d, ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device: DeviceLike = None):
        """(state, meta) of ``step`` (default the latest), or (None, None)
        when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(self._step_dir(step), device=device)


# ------------------------------------------------------------- PTQ ckpts
def _alloc_tag(alloc: Optional[dict]) -> str:
    if not alloc:
        return "no allocation"
    return (f"allocation {alloc.get('name', '?')!r} "
            f"(digest {str(alloc.get('digest', '?'))[:12]})")


class PTQCheckpointer:
    """Per-block reconstruction state (used by ``core.reconstruct``)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.dir, "ptq_state")

    def save(self, next_block: int, finalized, astates, reports, x_fp, x_q,
             plans: Optional[list] = None,
             allocation: Optional[dict] = None, rows=None) -> None:
        """``plans``: per finished block, {site: SitePlan.summary()};
        ``allocation``: summary of the automatic bit allocation that emitted
        the recipe's rules (None for hand-written rules). ``rows``: under a
        mesh, this rank's rows of the streams (``core.reconstruct._Rows``);
        every rank calls ``save``, rank 0 writes."""
        if rows is not None and rows.dp is not None:
            from repro_torch.launch.mesh import barrier, is_writer
            x_fp, x_q = rows.gather(x_fp), rows.gather(x_q)
            if is_writer():
                self.save(next_block, finalized, astates, reports, x_fp, x_q,
                          plans, allocation)
            barrier()
            return
        tree = {"finalized": finalized, "astates": astates,
                "x_fp": x_fp, "x_q": x_q}
        meta = {"next_block": next_block,
                "reports": [r.to_json() for r in reports],
                "plans": plans or [],
                "allocation": allocation,
                "manifest": current_manifest().to_dict()}
        save_pytree(self.path, tree, meta)

    def meta(self) -> Optional[dict]:
        """The saved metadata alone (``next_block``, ``reports``, ``plans``,
        ``allocation``, ``manifest``), without loading a tensor; None
        without a checkpoint."""
        where = _readable(os.path.abspath(self.path))
        if where is None:
            return None
        with open(os.path.join(where, _META)) as f:
            return json.load(f)["meta"]

    def load(self, blocks, recipe, allocation: Optional[dict] = None,
             device: DeviceLike = None, rows=None):
        """None without a checkpoint, else (next_block, finalized, astates,
        reports, x_fp, x_q) on ``device``; with ``rows`` (see ``save``)
        the streams are this rank's rows. Raises ``ValueError("PTQ resume
        mismatch ...")`` when the allocation digest or a finished block's
        per-site plans differ from this run's."""
        if not exists(self.path):
            return None
        from repro_torch.core.reconstruct import BlockReport, site_plans
        tree, meta = load_pytree(self.path, device=device)
        saved_alloc = meta.get("allocation")
        if (allocation or saved_alloc) and (
                (allocation or {}).get("digest")
                != (saved_alloc or {}).get("digest")):
            raise ValueError(
                f"PTQ resume mismatch: checkpoint was written under "
                f"{_alloc_tag(saved_alloc)} but this run quantizes under "
                f"{_alloc_tag(allocation)}; re-run the allocator probe or "
                "restart with a fresh checkpoint dir")
        for i, saved in enumerate(meta.get("plans", [])):
            if i >= len(blocks):
                break
            now = {n: p.summary() for n, p in
                   site_plans(blocks[i], recipe).items()}
            if now != saved:
                raise ValueError(
                    f"PTQ resume mismatch: block {i} ({blocks[i].name}) was "
                    f"finalized under per-site plans {saved} (emitted by "
                    f"{_alloc_tag(saved_alloc)}) but the current recipe "
                    f"resolves to {now}; restart with matching rules "
                    "or a fresh checkpoint dir")
        reports = [BlockReport.from_json(r) for r in meta["reports"]]
        x_fp, x_q = tree["x_fp"], tree["x_q"]
        if rows is not None:
            x_fp, x_q = rows.take(x_fp), rows.take(x_q)
        return (meta["next_block"], tree["finalized"], tree["astates"],
                reports, x_fp, x_q)

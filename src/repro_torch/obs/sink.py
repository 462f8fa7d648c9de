"""JSONL event sink + RunManifest: run identity for every emitted record
(port of ``repro/obs/sink.py``).

Every telemetry event stream, PTQ checkpoint meta, export and serve stats
dict carries (a brief of) the same ``RunManifest``. The record shape and
``SCHEMA_VERSION`` are the reference's, so the reference's
``validate_events`` accepts the port's streams; the version is monotonic
(readers ignore unknown fields but refuse a newer schema).

Manifest fields:
  schema_version     monotonic int; bump on any record-shape change
  git_sha            short sha of HEAD (``unknown`` outside a checkout)
  torch_version      torch.__version__
  cuda_version       torch.version.cuda (None in a CPU build)
  device             the card's name, or ``cpu`` for a run on the CPU
  backend            the kernel backend flag, or the device type
  n_devices          torch.cuda.device_count()
  mesh               mesh tag or None (distribution is not ported yet)
  recipe_digest      sha1 over the QuantRecipe repr (None outside PTQ)
  allocation_digest  digest of the automatic bit allocation (None if none)

The sink itself is append-only JSONL, flushed per record so a crashed run
keeps everything emitted before the crash. ``validate_events`` checks such
a stream, ``check_bench`` that bench JSON records are manifest-stamped;
``python -m repro_torch.obs.sink --validate EVENTS_JSONL --check-bench
BENCH_JSON`` runs them as the reference's CLI does (exit 1 on an error).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
from typing import Any, Dict, List, Optional

import torch

SCHEMA_VERSION = 1

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


class JsonlSink:
    """Append-only JSONL file sink (one JSON object per line, per-record
    flush so partial runs stay readable)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a")

    def emit(self, record: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class ListSink:
    """In-memory sink (tests)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


def digest(obj: Any) -> str:
    """Stable short digest of an object's repr (recipes are frozen
    dataclasses, so repr is canonical)."""
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:12]


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO_ROOT,
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return os.environ.get("GIT_SHA", "unknown")


def _device_name(device: Any) -> str:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


@dataclasses.dataclass(frozen=True)
class RunManifest:
    schema_version: int
    git_sha: str
    torch_version: str
    cuda_version: Optional[str]
    device: str
    backend: str
    n_devices: int
    mesh: Optional[str] = None
    recipe_digest: Optional[str] = None
    allocation_digest: Optional[str] = None

    @classmethod
    def collect(cls, backend: Optional[str] = None, device: Any = None,
                mesh: Optional[str] = None, recipe: Any = None,
                allocation: Optional[dict] = None) -> "RunManifest":
        """``device``: the run's device; None describes what the process
        sees (card 0 when a card is visible, else ``cpu``)."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        alloc_digest = None
        if allocation:
            alloc_digest = str(allocation.get("digest") or digest(allocation))
        return cls(
            schema_version=SCHEMA_VERSION,
            git_sha=_git_sha(),
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            device=_device_name(device),
            backend=backend or torch.device(device).type,
            n_devices=torch.cuda.device_count(),
            mesh=mesh,
            recipe_digest=None if recipe is None else digest(recipe),
            allocation_digest=alloc_digest)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunManifest":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def brief(self) -> Dict[str, Any]:
        """The per-row stamp: enough to align a point with a commit."""
        return {"git_sha": self.git_sha,
                "schema_version": self.schema_version}

    def record(self) -> Dict[str, Any]:
        """The manifest as a sink record (the first line of every JSONL)."""
        return {"kind": "manifest", "schema": self.schema_version,
                **self.to_dict()}


_CURRENT: Optional[RunManifest] = None


def rank_file(path: str) -> str:
    """``path`` with this process's rank before its extension when it is
    one rank of several (a started ``torch.distributed`` group of more
    than one), so that ranks never write one file; else ``path``."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{dist.get_rank()}{ext}"


def current_manifest() -> RunManifest:
    """Process-cached default manifest (git sha, versions, devices)."""
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = RunManifest.collect()
    return _CURRENT


def validate_events(path: str) -> List[str]:
    """Schema-check a telemetry JSONL: every line parses, carries ``kind``
    and a ``schema`` no newer than this reader, and at least one manifest
    record with a git sha is present. Returns the errors (empty = valid)."""
    errors: List[str] = []
    n, manifests = 0, 0
    try:
        fh = open(path)
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    with fh:
        for i, line in enumerate(fh, 1):
            if not line.strip():
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{i}: invalid JSON ({e})")
                continue
            if not isinstance(rec, dict) or "kind" not in rec:
                errors.append(f"{path}:{i}: record has no 'kind'")
                continue
            schema = rec.get("schema")
            if not isinstance(schema, int):
                errors.append(f"{path}:{i}: record has no int 'schema'")
            elif schema > SCHEMA_VERSION:
                errors.append(f"{path}:{i}: schema {schema} is newer than "
                              f"this reader ({SCHEMA_VERSION})")
            if rec.get("kind") == "manifest":
                manifests += 1
                if not rec.get("git_sha"):
                    errors.append(f"{path}:{i}: manifest has no git_sha")
    if n == 0:
        errors.append(f"{path}: no records")
    if manifests == 0:
        errors.append(f"{path}: no manifest record — the run has no "
                      "identity; emit RunManifest first")
    return errors


def check_bench(path: str) -> List[str]:
    """Assert that every bench JSON record is manifest-stamped (a git sha
    and an int schema version): the contract that makes bench records
    comparable across commits. Returns the errors (empty = valid)."""
    errors: List[str] = []
    try:
        with open(path) as fh:
            records = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    if not isinstance(records, list) or not records:
        return [f"{path}: expected a non-empty list of records"]
    for i, rec in enumerate(records):
        m = rec.get("manifest") if isinstance(rec, dict) else None
        if not isinstance(m, dict):
            errors.append(f"{path}[{i}] ({rec.get('name', '?')}): "
                          "no manifest stamp")
            continue
        if not m.get("git_sha"):
            errors.append(f"{path}[{i}]: manifest has no git_sha")
        if not isinstance(m.get("schema_version"), int):
            errors.append(f"{path}[{i}]: manifest has no schema_version")
    return errors


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m repro_torch.obs.sink --validate EVENTS_JSONL
    --check-bench BENCH_JSON``: prints ``OK`` lines or ``error:`` lines,
    exits 1 on any error (the reference's CLI)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="validate telemetry JSONL / bench JSON manifests")
    ap.add_argument("--validate", metavar="EVENTS_JSONL", default=None,
                    help="schema-check a telemetry events file")
    ap.add_argument("--check-bench", metavar="BENCH_JSON", default=None,
                    help="assert every bench record is manifest-stamped")
    args = ap.parse_args(argv)
    if not args.validate and not args.check_bench:
        ap.error("pass --validate and/or --check-bench")
    errors: List[str] = []
    if args.validate:
        errors += validate_events(args.validate)
        if not errors:
            with open(args.validate) as fh:
                n = sum(1 for line in fh if line.strip())
            print(f"{args.validate}: {n} records, schema <= "
                  f"{SCHEMA_VERSION}, manifest-stamped: OK")
    if args.check_bench:
        errs = check_bench(args.check_bench)
        errors += errs
        if not errs:
            print(f"{args.check_bench}: all records manifest-stamped: OK")
    for e in errors:
        print(f"error: {e}")
    if errors:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

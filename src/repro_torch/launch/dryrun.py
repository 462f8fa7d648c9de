"""Dry run over the production meshes: trace every (arch x shape x mesh)
cell as a DTensor program on a fake process group, no card needed (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch <id|all>
        --shape <id|all> [--mesh single|multi|both] [--weights int8]
        [--mode dp|tp|fsdp] [--kv bf16|int8] [--microbatch N] [--tag T]
        [--out results.json] [--append]

One process plays rank 0 of a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg``, imported here and
nowhere else in the package): 256 ranks for the 16 x 16 mesh, 512 for
2 x 16 x 16, destroyed and started again between the two. For each cell
it builds the production ``DeviceMesh``, the cell program
(``launch.steps.build_cell``), turns the program's stand-ins into DTensors
on their placements (``launch.sharding.distribute``) under
``FakeTensorMode``, so nothing is allocated, and traces ``prog.fn`` with
``make_fx``. The graph is rank 0's program: aten ops on its local shards
and the collectives DTensor inserts. The meshes are CUDA meshes where
PyTorch has CUDA (``mesh_device``), so DTensor picks the collectives it
picks on the card; the QTensor matmuls trace their plain versions
(``backend="torch"``): a ctypes-bound kernel is opaque to the tracer, and
the plain version has the same local shapes, so the same collectives. A
decode cell takes its position as the Python int ``shape.seq_len // 2``
(the decode steps take a host position by design); its collectives do not
depend on it. Plain tensors
that the model builds inside the program are taken as replicated
(``implicit_replication``, entered by the program itself:
``launch.steps._on_mesh``).

Each cell's record: ``trace_s`` (the trace's seconds, the counterpart of
the reference's ``compile_s``), ``memory`` (``analysis.memcheck
.graph_memory`` of the graph: the reference's ``memory_analysis()``
fields), ``analysis`` (``roofline.analysis.analyze_traced`` on the H100's
row: the analytic compute and memory terms plus the collective term from
the graph's bytes), ``collectives`` (op counts by kind), ``nodes`` and
``mesh_device``: the collective kinds and bytes depend on it (a CPU mesh
has no all-to-all), so a record says which it was. Cell
ids, the ``skipped``/``error`` records and the exit code (1 if any cell
errs) are the reference's; an error in one cell is recorded and the run
goes on. ``python -m repro_torch.roofline.report <out>`` renders them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import traceback
from typing import Callable, List, Optional

from torch.testing._internal.distributed import fake_pg

from repro_torch.analysis.memcheck import graph_memory
from repro_torch.configs import (ARCH_IDS, SHAPE_IDS, cell_applicable,
                                 get_config, get_shape, get_smoke_config)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     mesh_layout)
from repro_torch.launch.sharding import (distribute, from_local_tree,
                                         to_local_tree)
from repro_torch.launch.steps import build_cell
from repro_torch.obs.telemetry import Stopwatch
from repro_torch.roofline.analysis import analyze_traced, peaks
from repro_torch.roofline.collectives import collective_counts

DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def mesh_device() -> str:
    """The meshes' device type: ``cuda`` where PyTorch has CUDA (fake
    tensors on ``cuda``: no card memory is written), so DTensor issues the
    collectives it issues on the card; else ``cpu``, where DTensor turns
    each all-to-all into an all-gather of the same input (gloo has no
    all-to-all) and its bytes are counted as such. (Fake CUDA tensors need
    a PyTorch built with CUDA: without it autograd aborts the process.)"""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """A ``"fake"`` process group of ``n_ranks`` with this process as
    ``rank``: collectives are recorded by the tracer and move nothing.
    Destroyed on exit, so no other code sees it."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry "
                           "run starts its own fake one")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def decode_pos(shape: ShapeSpec) -> int:
    """The host position a decode cell is traced at."""
    return shape.seq_len // 2


def trace_local(fn: Callable, args: tuple):
    """``fn(*args)`` on DTensor arguments traced as rank 0's program: the
    graph takes the local shards, rebuilds the DTensors inside and returns
    the local shards of the results' DTensors, so every collective DTensor
    issues, inside its ops' dispatch too, is a node of it. (``make_fx`` on
    the DTensors themselves records DTensor-level ops and only the
    redistributions the program asks for by name.)"""
    from torch.fx.experimental.proxy_tensor import make_fx
    locals_: List = []
    tmpl = to_local_tree(args, locals_)

    def program(*shards):
        outs: List = []
        to_local_tree(fn(*from_local_tree(tmpl, iter(shards))), outs)
        return outs

    return make_fx(program, tracing_mode="fake")(*locals_)


def trace_cell(cfg, shape: ShapeSpec, mesh, *, weights: str = "int8",
               mode: Optional[str] = None, microbatch: int = 1,
               kv: str = "bf16", pos: Optional[int] = None):
    """(graph, trace seconds) of one cell on ``mesh`` (a ``DeviceMesh``
    over a running process group, fake or real)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    prog = build_cell(cfg, shape, mesh, weights=weights, mode=mode,
                      microbatch=microbatch, kv=kv, backend="torch")
    with FakeTensorMode():
        args = distribute(mesh, prog.args, prog.in_shardings)
    if shape.kind == "decode":
        args = args[:3] + (decode_pos(shape) if pos is None else pos,)
    sw = Stopwatch()
    gm = trace_local(prog.fn, args)
    return gm, sw.elapsed_s()


def cell_record(cfg, shape: ShapeSpec, mesh, cell_id: str, *,
                weights: str = "int8", mode: Optional[str] = None,
                microbatch: int = 1, kv: str = "bf16") -> dict:
    """The ``ok`` record of one traced cell (module docstring)."""
    gm, secs = trace_cell(cfg, shape, mesh, weights=weights, mode=mode,
                          microbatch=microbatch, kv=kv)
    return {
        "cell": cell_id,
        "status": "ok",
        "trace_s": round(secs, 1),
        "mesh_device": mesh.device_type,
        "nodes": len(gm.graph.nodes),
        "memory": graph_memory(gm),
        "collectives": collective_counts(gm),
        "analysis": analyze_traced(gm, cfg, shape, mesh, weights=weights,
                                   mode=mode, kv=kv, card=peaks(DEFAULT_CARD)),
    }


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_id(arch: str, shape_name: str, multi_pod: bool, weights: str,
            tag: str = "") -> str:
    return f"{arch}|{shape_name}|{mesh_name(multi_pod)}|{weights}" + (
        f"|{tag}" if tag else "")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             weights: str = "int8", verbose: bool = True,
             mode: Optional[str] = None, microbatch: int = 1,
             kv: str = "bf16", tag: str = "") -> dict:
    """One production cell's record; the fake group of the mesh's ranks
    must be running (``fake_world``)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cell_applicable(cfg, shape)
    cid = cell_id(arch, shape_name, multi_pod, weights, tag)
    if not ok:
        return {"cell": cid, "status": "skipped", "reason": why}
    return _recorded(cid, verbose, lambda: cell_record(
        cfg, shape, make_production_mesh(multi_pod=multi_pod,
                                         device_type=mesh_device()),
        cid, weights=weights, mode=mode, microbatch=microbatch, kv=kv))


def run_debug_cell(arch: str, batch: int, seq: int, *,
                   verbose: bool = True) -> dict:
    """The record of ``arch``'s smoke config as a bf16 train cell of
    ``batch`` x ``seq`` (``train_4k`` cut to that size) on the (2, 4) debug
    mesh of ``mesh_device()``; the fake group of its 8 ranks must be
    running. Its id is ``<arch>|debug:<batch>x<seq>``; an error is recorded
    as ``run_cell`` records it."""
    cid = f"{arch}|debug:{batch}x{seq}"
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                global_batch=batch)
    return _recorded(cid, verbose, lambda: cell_record(
        get_smoke_config(arch), shape,
        make_debug_mesh(device_type=mesh_device()), cid, weights="bf16"))


def _recorded(cid: str, verbose: bool, record: Callable[[], dict]) -> dict:
    """``record()``, or the ``error`` record of what it raised."""
    sw = Stopwatch()
    try:
        rec = record()
        if verbose:
            a, m = rec["analysis"], rec["memory"]
            print(f"[OK ] {cid}  trace={rec['trace_s']}s  "
                  f"peak/dev={m['peak_bytes_per_device'] / 2**30:.2f}GiB  "
                  f"compute={a['compute_s']:.3e}s memory={a['memory_s']:.3e}s "
                  f"collective={a['collective_s']:.3e}s -> {a['bottleneck']}",
                  flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 - record and continue
        if verbose:
            print(f"[ERR] {cid}: {e}", flush=True)
            traceback.print_exc()
        return {"cell": cid, "status": "error", "error": str(e),
                "trace_s": round(sw.elapsed_s(), 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--weights", default="int8",
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--mode", default=None, choices=[None, "dp", "tp", "fsdp"],
                    help="override the per-arch parallelism mode")
    ap.add_argument("--kv", default="bf16", choices=["bf16", "int8"],
                    help="KV-cache precision for serve cells")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tag", default="", help="suffix for the cell id")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = SHAPE_IDS if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {r["cell"] for r in results if r.get("status") == "ok"}

    for mp in meshes:
        todo = []
        for a in archs:
            for s in shapes:
                cid = cell_id(a, s, mp, args.weights, args.tag)
                if cid in done:
                    print(f"[SKIP cached] {cid}", flush=True)
                else:
                    todo.append((a, s))
        if not todo:
            continue
        with fake_world(math.prod(mesh_layout("production",
                                              multi_pod=mp)[0])):
            for arch, shape in todo:
                results.append(run_cell(
                    arch, shape, multi_pod=mp, weights=args.weights,
                    mode=args.mode, microbatch=args.microbatch, kv=args.kv,
                    tag=args.tag))
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped (per assignment), "
          f"{n_err} errors -> {args.out}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())

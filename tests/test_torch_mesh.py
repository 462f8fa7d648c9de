"""Port parity for the mesh and sharding specs: ``repro_torch.launch.mesh``
and ``repro_torch.launch.sharding`` against ``repro.launch.mesh`` and
``repro.launch.sharding``, and the data-parallel collectives over spawned
gloo ranks on the CPU.

The spec functions are pure shape logic: both packages get the same shape
trees (the reference's ``jax.eval_shape`` of each full config's params, a
``train_4k`` batch and a ``decode_32k`` cache; the port's leaves carry the
same shapes) and stand-in meshes of the five layouts, and every spec must be
equal (the port's tuples against ``tuple(PartitionSpec)``).

The collectives run in 8 spawned processes (one spawn for the module, one
thread each): the debug meshes (2, 4) and (2, 2, 2) over gloo, their
data-parallel groups, and rows assembled from byte sums, which must be the
rows bit for bit (bfloat16 -0.0 and NaN payloads included).

``spawn_ranks`` is the harness the other ``test_torch_*`` files of
distributed runs import: ``world`` processes of ``python -c`` with
torchrun's environment, each writing its results with ``torch.save``.
"""
import math
import os
import socket
import subprocess
import sys
import types

import pytest
import torch

from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
SRC = os.path.join(ROOT, "src")

LAYOUTS = {"production": ((16, 16), ("data", "model")),
           "production-multipod": ((2, 16, 16), ("pod", "data", "model")),
           "debug": ((2, 4), ("data", "model")),
           "debug-multipod": ((2, 2, 2), ("pod", "data", "model")),
           "single": ((1, 1), ("data", "model"))}


# ---------------------------------------------------------------- harness
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(world: int, threads: int = 1) -> dict:
    """torchrun's variables for a world of ``world`` ranks on this host (add
    ``RANK`` and ``LOCAL_RANK``), the repo's paths, ``threads`` threads."""
    env = dict(os.environ)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS=str(threads), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, env.get("PYTHONPATH", "")]))
    return env


def spawn_ranks(world: int, module: str, fn: str, out_dir, timeout=300,
                threads: int = 1):
    """Run ``module.fn(out_dir)`` in ``world`` processes as ranks of one
    world; returns each rank's ``torch.load(out_dir/rank<r>.pt)``. A rank
    that fails or outlives ``timeout`` fails the test with every log."""
    out_dir = str(out_dir)
    env = rank_env(world, threads)
    code = f"import {module} as m; m.{fn}({out_dir!r})"
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=logs[-1],
            stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = "\n".join(
            f"--- rank {r} ---\n" + open(os.path.join(
                out_dir, f"rank{r}.log")).read()[-3000:] for r in bad)
        pytest.fail(f"ranks {bad} failed:\n{text}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def start_rank():
    """In a spawned rank: the process group from the environment (gloo on
    the CPU)."""
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    return tmesh.init_distributed(torch.device("cpu"))


def save_rank(out_dir, result) -> None:
    import torch.distributed as dist
    torch.save(result, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    tmesh.shutdown()


# ------------------------------------------------------------ mesh layouts
def _port_mesh(layout):
    shape, names = LAYOUTS[layout]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _ref_mesh(layout):
    shape, names = LAYOUTS[layout]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                 shape)))


def test_layouts_equal_the_reference_meshes():
    """The reference's make_* functions build these shapes and names
    (``repro/launch/mesh.py``); the port's layouts and rank counts."""
    import inspect

    from repro.launch import mesh as jmesh
    src = inspect.getsource(jmesh)
    for kind, pod in (("production", False), ("production", True),
                      ("debug", False), ("debug", True)):
        shape, names = tmesh.mesh_layout(kind, multi_pod=pod)
        assert (shape, names) == LAYOUTS[kind + ("-multipod" if pod else "")]
        assert str(shape) in src
        assert "(" + ", ".join(f'"{n}"' for n in names) + ")" in src
        assert tmesh.ranks_needed(kind, multi_pod=pod) == math.prod(shape)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dp_axes_axis_size_and_stream_spec_match_reference(layout):
    from repro.launch import mesh as jmesh
    from repro.launch import sharding as jshd
    m, jm = _port_mesh(layout), _ref_mesh(layout)
    assert tmesh.dp_axes(m) == jmesh.dp_axes(jm)
    for axes in ("data", "model", ("data", "model"), tmesh.dp_axes(m)):
        assert tmesh.axis_size(m, axes) == jmesh.axis_size(jm, axes)
    for n in (1, 5, 8, 48, 64, 256, 1000, 4096):
        assert tshd.stream_spec(n, m) == tuple(jshd.stream_spec(n, jm)), n


# ----------------------------------------------------------- spec trees
_TREES = {}


def _reference_trees(arch):
    """(params, batch, cache) shape trees of the full ``arch`` from the
    reference, built once per arch."""
    if arch not in _TREES:
        from repro.configs import get_config, get_shape
        from repro.launch import specs as jspecs
        from repro.models import build_model
        cfg = get_config(arch)
        model = build_model(cfg)
        _TREES[arch] = (cfg, jspecs.param_shapes(model, cfg),
                        jspecs.batch_shapes(cfg, get_shape("train_4k")),
                        jspecs.cache_shapes(model, cfg,
                                            get_shape("decode_32k")))
    return _TREES[arch]


def _to_port(tree):
    """A jax shape tree as the port's nested dicts/lists of shaped leaves."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_port(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tuple(tree.shape), device="meta")


def _flat_ref(tree):
    import jax
    from jax.sharding import PartitionSpec
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _flat_port(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat_port(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, list) and not tshd._is_spec(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, f"{path}[{i}]"))
        return out
    return {path: tree}


ARCHS = ("qwen2.5-14b", "smollm-135m", "granite-3-2b", "olmo-1b",
         "recurrentgemma-2b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
         "mamba2-130m", "whisper-medium", "phi-3-vision-4.2b")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, layout):
    """param/batch/cache/opt spec trees of every full config on every
    layout, spec for spec, and ``named`` placements one per mesh dim."""
    from repro.launch import sharding as jshd
    cfg, params, batch, cache = _reference_trees(arch)
    m, jm = _port_mesh(layout), _ref_mesh(layout)
    pspec = tshd.param_spec_tree(_to_port(params), cfg, m)
    jpspec = jshd.param_spec_tree(params, cfg, jm)
    assert _flat_port(pspec) == _flat_ref(jpspec)
    for mode in ("dp", "tp", "fsdp"):
        assert _flat_port(tshd.param_spec_tree(_to_port(params), cfg, m,
                                               mode)) == \
            _flat_ref(jshd.param_spec_tree(params, cfg, jm, mode)), mode
    assert _flat_port(tshd.batch_spec_tree(_to_port(batch), cfg, m)) == \
        _flat_ref(jshd.batch_spec_tree(batch, cfg, jm))
    assert _flat_port(tshd.cache_spec_tree(_to_port(cache), cfg, m)) == \
        _flat_ref(jshd.cache_spec_tree(cache, cfg, jm))
    assert _flat_port(tshd.opt_spec_tree(None, pspec)) == \
        _flat_ref(jshd.opt_spec_tree(None, jpspec))
    if arch == "smollm-135m":
        from torch.distributed.tensor import Replicate, Shard
        named = tshd.named(m, pspec)
        for spec, pl in zip(_flat_port(pspec).values(),
                            _flat_port(named).values()):
            assert len(pl) == len(m.shape)
            for name, p in zip(m.mesh_dim_names, pl):
                dims = [d for d, e in enumerate(spec)
                        if e == name or (isinstance(e, tuple) and name in e)]
                assert p == (Shard(dims[0]) if dims else Replicate())


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _port_mesh("debug-multipod")
    assert tshd.placements(tshd.P(("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert tshd.placements(tshd.P(None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert tshd.replicated(m) == (Replicate(),) * 3
    assert tshd.stream_sharding(m, 8) == (Shard(0), Shard(0), Replicate())
    assert tshd.stream_sharding(m, 6) == (Replicate(),) * 3
    assert tshd.P(("data",)) == ("data",)


def test_no_world_starts_nothing(monkeypatch):
    """Without torchrun's variables nothing starts, and a mesh refuses to
    be built without a process group of its size."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed(torch.device("cpu")) is None
    assert tmesh.is_writer()
    tmesh.barrier()  # no group: nothing to wait for
    with pytest.raises(RuntimeError, match="start one first"):
        tmesh.make_debug_mesh(device_type="cpu")


# -------------------------------------------------- collectives, 8 ranks
def ranks_worker(out_dir):
    """Each rank: both debug meshes, their data-parallel places, exact row
    assembly, the reductions."""
    import torch.distributed as dist
    start_rank()
    r = dist.get_rank()
    res = {}
    for tag, pod in (("debug", False), ("debug-multipod", True)):
        m = tmesh.make_debug_mesh(multi_pod=pod, device_type="cpu")
        dp = tmesh.DataParallel.of(m)
        assert tmesh.DataParallel.of(m) is dp
        n = 12
        lo, hi = dp.rows(n)
        mine = torch.arange(lo * 3, hi * 3, dtype=torch.bfloat16).reshape(
            hi - lo, 3)
        mine[0, 0] = -0.0
        mine[-1, -1] = float("nan")
        bits = torch.zeros((hi - lo, 2), dtype=torch.int32)
        bits[:, 0] = torch.arange(lo, hi) + 0x7fc00000  # NaN payloads
        full = dp.gather_rows(mine, n)
        fbits = dp.gather_rows(bits.view(torch.float32), n).view(torch.int32)
        s, mn, mx = (dp.all_reduce([torch.tensor([float(dp.rank), 1.0])],
                                   op)[0].tolist()
                     for op in ("sum", "min", "max"))
        res[tag] = dict(coord=m.get_coordinate(), size=dp.size,
                        rank=dp.rank, backend=dp.backend, rows=(lo, hi),
                        full=full.view(torch.int16).clone(), bits=fbits,
                        uneven=dp.rows(7), sum=s, min=mn, max=mx)
    res["writer"] = tmesh.is_writer()
    save_rank(out_dir, res)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return spawn_ranks(8, "test_torch_mesh", "ranks_worker",
                       tmp_path_factory.mktemp("mesh8"))


@pytest.mark.parametrize("tag,size", [("debug", 2), ("debug-multipod", 4)])
def test_data_parallel_places_on_the_debug_meshes(eight, tag, size):
    """dp = the data axes' size ((2, 4): 2; (2, 2, 2): pod x data = 4); a
    rank's dp index is its coordinate along them (model-axis neighbours
    share it); uneven row counts replicate."""
    for r, res in enumerate(eight):
        got = res[tag]
        coord = got["coord"]
        want = coord[0] if size == 2 else coord[0] * 2 + coord[1]
        assert got["size"] == size and got["rank"] == want
        assert got["backend"] == "gloo"
        assert got["rows"] == (want * 12 // size, (want + 1) * 12 // size)
        assert got["uneven"] == (0, 7)
        assert got["sum"] == [sum(range(size)), float(size)]
        assert got["min"] == [0.0, 1.0] and got["max"] == [size - 1.0, 1.0]
    assert [res["writer"] for res in eight] == [True] + [False] * 7


@pytest.mark.parametrize("tag", ["debug", "debug-multipod"])
def test_rows_assemble_bit_for_bit(eight, tag):
    want = torch.arange(36, dtype=torch.bfloat16).reshape(12, 3)
    bits = torch.zeros((12, 2), dtype=torch.int32)
    bits[:, 0] = torch.arange(12) + 0x7fc00000
    for res in eight:
        size = res[tag]["size"]
        w = want.clone()
        for d in range(size):
            lo, hi = d * 12 // size, (d + 1) * 12 // size
            w[lo, 0] = -0.0
            w[hi - 1, -1] = float("nan")
        assert torch.equal(res[tag]["full"], w.view(torch.int16))
        assert torch.equal(res[tag]["bits"], bits)

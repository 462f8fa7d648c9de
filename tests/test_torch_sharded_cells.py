"""The cell programs as DTensor programs on real ranks: gloo CPU ranks
(world 4, mesh (2, 2) of data x model, the kernels' plain versions) run
the ``reduced()`` smollm-135m, olmo-1b and llama4-scout-17b-a16e cells,
and deepseek-v3-671b's train cell at 8 x 41 (``UNEVEN``: its mtp layer's
token groups straddle the two data ranks, so the MoE gathers its input
over them), each held against the same cell at world 1
(``launch.mesh.AbstractMesh``, plain tensors), with the same arguments
(drawn from one seed on every rank; ``launch.sharding.distribute`` keeps
each rank's slice).

Train (``train_cell``, one step, weights bf16): loss and gradient norm
within 1e-5 relative of world 1, every parameter as
``test_torch_train._check_params`` holds a step (within 3 x lr, at most
0.5% of a leaf beyond 1e-6). Decode (``serve_cell``, int8 weights, one
step at the host position seq_len // 2, whose cache write lands on the
second model rank's sequence shard): the next tokens equal world 1's,
every cache entry within 1e-5 plus 1e-5 of the leaf's largest magnitude.
On every rank the collectives that ``CommDebugMode`` counts in the eager
run equal, kind by kind, what the dry run's trace of the same cell on the
same mesh holds (``launch.dryrun.trace_cell``, ``roofline.collectives``).
``qtensor_matmul`` on codes split on N or on K, as either rank of a fake
group of 2, equals the plain version on that rank's halves.

The ``requires_cuda`` case skips here: on a card, ``qtensor_matmul`` of
DTensor weights over an NCCL group of one rank launches K2 on the local
shard (counted) and equals its plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_shape, get_smoke_config
from repro_torch.launch import sharding, specs, steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.optim.adam import adam_init, tree_leaves
from test_torch_mesh import save_rank, spawn_ranks, start_rank

ARCHS = ("smollm-135m", "olmo-1b", "llama4-scout-17b-a16e")
TRAIN = dataclasses.replace(get_shape("train_4k"), seq_len=32, global_batch=4)
DECODE = dataclasses.replace(get_shape("decode_32k"), seq_len=64,
                             global_batch=4)
# deepseek-v3's mtp layer: 8 x 40 tokens in 5 groups of 64, 2.5 a data rank
# (test_torch_dryrun.py: test_uneven_moe_groups_trace)
UNEVEN = dataclasses.replace(get_shape("train_4k"), seq_len=41,
                             global_batch=8)
CELLS = tuple((a, s, w) for a in ARCHS for s, w in ((TRAIN, "bf16"),
                                                     (DECODE, "int8"))) + (
    ("deepseek-v3-671b", UNEVEN, "bf16"),)
TRAIN_ARCHS = ARCHS + ("deepseek-v3-671b",)
MESH = ((2, 2), ("data", "model"))
ONE = ((1, 1), ("data", "model"))
POS = DECODE.seq_len // 2


def cell_args(cfg, shape, weights: str, seed: int = 0):
    """The cell's arguments as plain CPU tensors, the same on every rank:
    the model's init (and its Adam state), int8 QTensors of drawn codes,
    a drawn cache and tokens."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg)
    params = model.init(gen, device="cpu")
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = steps.TRAIN_OPT[sharding.ARCH_MODE.get(cfg.name, "tp")]
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        return ({"params": params, "opt": adam_init(params, opt), "step": 0},
                batch)
    prog = steps.build_cell(cfg, shape, AbstractMesh(*ONE), weights=weights)
    qparams = specs.materialize(prog.args[0], gen, "cpu", fill=params)
    cache = specs.materialize(prog.args[2], gen, "cpu")
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                             .astype(np.int32))
    return qparams, token, cache, POS


def run_cell(cfg, shape, args, mesh, weights: str):
    """``build_cell``'s program on ``mesh`` (None: world 1) over ``args``;
    returns (results made whole, eager collective counts by kind)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.roofline.collectives import counts_by_kind
    if mesh is None:
        prog = steps.build_cell(cfg, shape, AbstractMesh(*ONE),
                                weights=weights)
        return prog.fn(*_copy(args)), {}
    prog = steps.build_cell(cfg, shape, mesh, weights=weights)
    n = len(prog.in_shardings)
    dargs = sharding.distribute(mesh, args[:n], prog.in_shardings) + \
        tuple(args[n:])
    with CommDebugMode() as comm:
        out = prog.fn(*dargs)
    return sharding.gather(out), counts_by_kind(comm.get_comm_counts())


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, codes=tree.codes.clone(),
                                   scale=tree.scale.clone(),
                                   zero=tree.zero.clone())
    return tree


def sharded_worker(out_dir):
    """One gloo rank: for every arch and kind, the traced counts on a
    fresh (2, 2) mesh, then the eager DTensor run on another; rank 0 also
    runs world 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.roofline.collectives import collective_counts
    start_rank()
    out = {}
    for arch, shape, weights in CELLS:
        cfg = get_smoke_config(arch)
        mesh = init_device_mesh("cpu", *MESH[:1], mesh_dim_names=MESH[1])
        gm, _ = dryrun.trace_cell(cfg, shape, mesh, weights=weights,
                                  pos=POS)
        args = cell_args(cfg, shape, weights)
        mesh = init_device_mesh("cpu", *MESH[:1], mesh_dim_names=MESH[1])
        res, counts = run_cell(cfg, shape, args, mesh, weights)
        rec = {"traced": collective_counts(gm), "eager": counts}
        if dist.get_rank() == 0:
            rec["sharded"] = res
            rec["one"] = run_cell(cfg, shape, args, None, weights)[0]
        out[(arch, shape.kind)] = rec
    save_rank(out_dir, out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(4, "test_torch_sharded_cells", "sharded_worker",
                       tmp_path_factory.mktemp("sharded_cells"), timeout=900)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_matches_world_one(ranks, arch):
    rec = ranks[0][(arch, "train")]
    (state, m), (state1, m1) = rec["sharded"], rec["one"]
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(m1["gnorm"]),
                               rtol=1e-5)
    lr = steps.TRAIN_OPT[sharding.ARCH_MODE.get(arch + "-smoke", "tp")].lr
    for t, t1 in zip(tree_leaves(state["params"]),
                     tree_leaves(state1["params"]), strict=True):
        d = np.abs(_np(t).astype(np.float64) - _np(t1))
        assert d.max() <= 3 * lr, d.max()
        assert (d > 1e-6).sum() <= max(1, d.size // 200)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_world_one(ranks, arch):
    rec = ranks[0][(arch, "decode")]
    (tok, cache), (tok1, cache1) = rec["sharded"], rec["one"]
    assert torch.equal(tok, tok1)
    for t, t1 in zip(tree_leaves(cache), tree_leaves(cache1), strict=True):
        a, b = _np(t), _np(t1)
        tol = 1e-5 + 1e-5 * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


@pytest.mark.parametrize("arch,kind", [(a, s.kind) for a, s, _ in CELLS])
def test_eager_collectives_equal_traced(ranks, arch, kind):
    for r, out in enumerate(ranks):
        rec = out[(arch, kind)]
        assert rec["eager"] == rec["traced"], (r, rec)


@pytest.mark.requires_cuda
def test_qtensor_matmul_launches_the_kernel_on_local_shards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's dry-run phase "
                    "runs the 2-rank decode cell on the card")
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        K, N = 576, 1536
        qt = QTensor(codes=torch.randint(0, 256, (K, N), generator=gen,
                                         device="cuda", dtype=torch.uint8),
                     scale=torch.full((1, N), 0.01, device="cuda"),
                     zero=torch.full((1, N), 127.0, device="cuda"),
                     shape=(K, N), bits=8, packed=False)
        x = torch.randn(4, K, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        spec = QTensor(codes=(None, "model"), scale=(None, None),
                       zero=(None, "model"), shape=(K, N), bits=8,
                       packed=False)
        dq = sharding.distribute(mesh, qt, spec)
        dx = sharding.distribute(mesh, x, (None, None))
        ops.reset_launch_counts()
        y = ops.qtensor_matmul(dx, dq).full_tensor()
        assert ops.launch_counts()["dequant_matmul_w8"] == 1
        want = ops.qtensor_matmul(x, qt, backend="torch")
        torch.testing.assert_close(y.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("split", ["N", "K"])
def test_qtensor_matmul_on_each_half(rank, split):
    """``qtensor_matmul`` on codes split over a (1, 2) mesh, this process
    as ``rank`` of a fake group of 2: the scale and zero are whole and cut
    to the rank's columns (``_held``), x is cut to its K half; the local
    result is placed ``Shard(-1)`` (N) or ``Partial`` (K) and equals the
    plain version on the rank's halves."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    gen = torch.Generator().manual_seed(0)
    M, K, N = 4, 64, 48
    x = torch.randn(M, K, generator=gen)
    codes = torch.randint(0, 256, (K, N), generator=gen, dtype=torch.uint8)
    scale = torch.rand(1, N, generator=gen) * 0.02 + 0.001
    zero = torch.round(torch.rand(1, N, generator=gen) * 255)
    dim = 1 if split == "N" else 0
    n = codes.shape[dim] // 2
    half = slice(rank * n, (rank + 1) * n)
    local = (codes[:, half] if dim else codes[half]).contiguous()
    with dryrun.fake_world(2, rank=rank):
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        dcodes = DTensor.from_local(local, mesh, [Replicate(), Shard(dim)],
                                    run_check=False, shape=codes.shape,
                                    stride=codes.stride())
        got = ops.qtensor_matmul(
            x, QTensor(dcodes, scale, zero, (K, N), 8, False))
        assert tuple(got.placements) == (
            Replicate(), Shard(1) if dim else Partial())
        got = got.to_local()
    if dim:
        want = ops.qtensor_matmul(x, QTensor(local, scale[:, half],
                                             zero[:, half], (K, n), 8, False))
    else:
        want = ops.qtensor_matmul(x[:, half].contiguous(), QTensor(
            local, scale, zero, (n, N), 8, False))
    assert torch.equal(got, want)

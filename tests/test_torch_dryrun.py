"""The dry run (``launch.dryrun``) on the debug meshes, against the
reference's ``lower().compile()`` of the same cells.

Each cell program is traced on a ``"fake"`` process group of 8 ranks
(started and destroyed by ``dryrun.fake_world`` around each test) with a
fresh ``DeviceMesh``: the ``reduced()`` configs at seq 64 x batch 8, as the
reference's ``tests/test_dryrun_small.py`` runs them. This file holds the
(2, 4) mesh and the measurements; ``test_torch_dryrun_multipod.py`` holds
the (2, 2, 2) half of the matrix.

- **Matrix.** Every record has flops, a memory peak and a collective
  breakdown, with a bottleneck among the three terms.
- **Argument bytes.** smollm's train and decode cells: ``argument_bytes``
  per device equals the reference's ``memory_analysis()
  .argument_size_in_bytes`` (compiled in a subprocess on 8 virtual CPU
  devices, as its own test does), but for the int32 scalars the port keeps
  as Python ints: the train state's ``step`` and Adam ``count`` (8 bytes),
  the decode position (4 bytes).
- **All-reduce bytes.** The dp train cells (smollm-135m and mamba2-130m,
  ``mode="dp"``, the parameters replicated and the batch split over
  ``data``): the port reduces each parameter's float32 gradient once, and
  its all-reduce bytes are those gradients' bytes. The reference's
  (its compiled HLO, read by its ``collective_bytes_trip_corrected`` rule
  with each while body's collectives times the ``known_trip_count`` XLA
  records, ``ref_collective_bytes``) hold the same reductions plus what
  GSPMD places inside the cross entropy's chunk loop: the output head's
  gradient is reduced once per chunk, not once, and a tied head once more
  as the embedding's gradient. With those named bytes added the port's
  total is within 1% of the reference's; the rest is the reference's
  scalar reductions of the loss and the token count (8 bytes). The
  reference's own parser is printed beside: on this XLA it finds no
  computation whose header lists a tuple parameter (its ``_COMP_START``
  allows no nested parentheses), so it misses every collective of a
  ``while`` body (33024 bytes for smollm: the embedding's and the final
  norm's gradients alone; ROADMAP Queue 3). The tp and fsdp cells print the
  reference's breakdown beside the port's, with no bound: DTensor and GSPMD
  partition the same program differently (where DTensor gathers an
  activation GSPMD may keep a partial sum, and the other way round), so
  only the data-parallel gradient reduction has one right answer.
- **Depth.** Going from 2 to 4 layers adds exactly twice one layer's
  collective bytes: the traced graph unrolls the layer loop, which stands
  in for the reference's trip-count correction.
- **Position.** A decode cell's collectives are the same at two positions
  in different sequence shards of the cache.
- **MoE groups across uneven data ranks.** deepseek-v3 at 8 x 41: the mtp
  layer's groups straddle the two data ranks; the cell traces, the MoE
  gathers the mtp input as GSPMD does (as many all-gathers of it as the
  reference's HLO), its dp gradient reductions are held to the
  reference's HLO with named bytes, and a plain run's groups, output and
  aux loss are unchanged bit for bit.
- **MoE placements.** The MoE hints give the expert buffers the expert
  weights' placement on E: EP over ``model`` on (2, 4), where E = 4 does
  not divide data x model, full EP over (data, model) on (2, 2, 2).
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import pytest

from repro_torch.configs import get_shape, get_smoke_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import mesh_layout
from repro_torch.optim.adam import tree_leaves
from repro_torch.roofline.collectives import collective_bytes, collective_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-135m", "deepseek-v3-671b", "mamba2-130m",
         "recurrentgemma-2b", "whisper-medium", "phi-3-vision-4.2b")
TRAIN = dataclasses.replace(get_shape("train_4k"), seq_len=64, global_batch=8)
DECODE = dataclasses.replace(get_shape("decode_32k"), seq_len=64,
                             global_batch=8)
KINDS = {"train": (TRAIN, "bf16"), "decode": (DECODE, "int8")}


def debug_mesh(multi_pod: bool):
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = mesh_layout("debug", multi_pod=multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture
def world():
    with dryrun.fake_world(8):
        yield


def record(arch, kind, multi_pod=False, mode=None, cfg=None):
    shape, weights = KINDS[kind]
    return dryrun.cell_record(cfg or get_smoke_config(arch), shape,
                              debug_mesh(multi_pod), f"{arch}|{kind}",
                              weights=weights, mode=mode)


def check_record(rec):
    a, m = rec["analysis"], rec["memory"]
    assert rec["status"] == "ok"
    assert a["flops_per_device"] > 0 and m["peak_bytes_per_device"] > 0
    assert set(a["collective_breakdown"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert a["collective_bytes_per_device"] == sum(
        a["collective_breakdown"].values()) > 0
    assert a["bottleneck"] in ("compute", "memory", "collective")
    assert a["step_time_bound_s"] == max(a["compute_s"], a["memory_s"],
                                         a["collective_s"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_matrix_single_pod(world, arch, kind):
    check_record(record(arch, kind))


# ------------------------------------------------------------ reference
_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from repro.configs import get_smoke_config, get_shape
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import build_cell
from repro.roofline.hlo_parse import collective_bytes_trip_corrected
train = dataclasses.replace(get_shape("train_4k"), seq_len=64, global_batch=8)
dec = dataclasses.replace(get_shape("decode_32k"), seq_len=64, global_batch=8)
uneven = dataclasses.replace(get_shape("train_4k"), seq_len=41,
                             global_batch=8)
mesh = make_debug_mesh()
out = {}
for key, arch, shp, w, mode in (
        ("deepseek-v3-671b|train|dp", "deepseek-v3-671b", uneven, "bf16",
         "dp"),
        ("smollm-135m|train", "smollm-135m", train, "bf16", None),
        ("smollm-135m|decode", "smollm-135m", dec, "int8", None),
        ("smollm-135m|train|dp", "smollm-135m", train, "bf16", "dp"),
        ("mamba2-130m|train|dp", "mamba2-130m", train, "bf16", "dp"),
        ("llama4-scout-17b-a16e|train|fsdp", "llama4-scout-17b-a16e", train,
         "bf16", "fsdp")):
    prog = build_cell(get_smoke_config(arch), shp, mesh, weights=w, mode=mode)
    with mesh:
        c = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                    out_shardings=prog.out_shardings).lower(*prog.args).compile()
    out[key] = {"arg": c.memory_analysis().argument_size_in_bytes,
                "hlo": c.as_text(),
                "ref_parser": collective_bytes_trip_corrected(c.as_text())}
print(json.dumps(out))
"""


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4,
          "u32": 4, "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4,
          "f64": 8}


def ref_collective_bytes(txt):
    """Per-kind collective bytes of compiled HLO text by the reference's
    ``collective_bytes_trip_corrected`` rule (the result shapes' bytes of
    each collective, ``-done`` halves skipped), each computation's times
    the product of the ``known_trip_count``s of the whiles that call it."""
    comps, cur, entry = {}, None, None
    for line in txt.splitlines():
        if (not line.startswith(" ") and "->" in line
                and line.rstrip().endswith("{")):
            cur = re.match(r"(ENTRY\s+)?%?([\w.\-]+)", line)
            entry = cur.group(2) if cur.group(1) else entry
            cur = cur.group(2)
            comps[cur] = []
        elif line.strip() == "}":
            cur = None
        elif cur is not None:
            comps[cur].append(line.strip())
    edges = {n: [] for n in comps}
    for n, lines in comps.items():
        for line in lines:
            body = re.search(r"\bwhile\(.*?body=%?([\w.\-]+)", line)
            trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
            for callee in re.findall(
                    r"(?:calls|to_apply|condition|body)=%?([\w.\-]+)", line):
                k = int(trips.group(1)) if (body and trips and
                                            callee == body.group(1)) else 1
                if callee in comps:
                    edges[n].append((callee, k))
    mult = {}

    def walk(n, f):
        mult[n] = mult.get(n, 0) + f
        for c, k in edges[n]:
            walk(c, f * k)

    walk(entry, 1)
    out = {k: 0 for k in _KINDS}
    for n, lines in comps.items():
        for line in lines:
            if "-done" in line or "=" not in line:
                continue
            for kind in _KINDS:
                if re.search(rf"\b{kind}(-start)?\(", line):
                    lhs = line.split("=", 1)[1].split(kind)[0]
                    out[kind] += mult.get(n, 0) * sum(
                        _BYTES[d] * math.prod(int(x) for x in dims.split(",")
                                              if x)
                        for d, dims in _SHAPE.findall(lhs))
                    break
    return out


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for rec in out.values():
        hlo = rec.pop("hlo")
        rec["coll"] = ref_collective_bytes(hlo)
        rec["gathers"] = re.findall(
            r"= (\w+\[[\d,]*\])\{[^}]*\} all-gather(?:-start)?\(", hlo)
    return out


@pytest.mark.parametrize("kind,scalars", (("train", 8), ("decode", 4)))
def test_argument_bytes_match_reference(world, reference, kind, scalars):
    rec = record("smollm-135m", kind)
    ref = reference[f"smollm-135m|{kind}"]["arg"]
    assert rec["memory"]["argument_bytes"] + scalars == ref


@pytest.mark.parametrize("arch", ("smollm-135m", "mamba2-130m"))
def test_dp_all_reduce_bytes_match_reference(world, reference, arch):
    cfg = get_smoke_config(arch)
    rec = record(arch, "train", mode="dp")
    port = rec["analysis"]["collective_breakdown"]["all-reduce"]
    ref = reference[f"{arch}|train|dp"]
    print(f"{arch} dp train all-reduce bytes: port {port}, reference "
          f"{ref['coll']['all-reduce']} (its own parser: "
          f"{ref['ref_parser']['all-reduce']})")
    grads = 4 * sum(math.prod(t.shape) for t in tree_leaves(
        steps.build_cell(cfg, TRAIN, debug_mesh(False),
                         mode="dp").args[0]["params"]))
    assert port == grads
    head = 4 * cfg.d_model * cfg.vocab
    chunks = math.ceil(TRAIN.seq_len / min(cfg.xent_chunk, TRAIN.seq_len))
    in_loop = head * (chunks - 1 + bool(cfg.tie_embeddings))
    assert abs(port + in_loop - ref["coll"]["all-reduce"]) <= \
        0.01 * ref["coll"]["all-reduce"]


@pytest.mark.parametrize("arch,mode", (("smollm-135m", None),
                                       ("llama4-scout-17b-a16e", "fsdp")))
def test_tp_fsdp_breakdown_beside_reference(world, reference, arch, mode):
    """No bound (module docstring): both breakdowns printed side by
    side, each with collective bytes."""
    rec = record(arch, "train", mode=mode)
    port = rec["analysis"]["collective_breakdown"]
    ref = reference[f"{arch}|train" + (f"|{mode}" if mode else "")]["coll"]
    print(f"{arch} train ({mode or 'tp'}) bytes per device:")
    for k in port:
        print(f"  {k:20s} port {port[k]:>12d}  reference {int(ref[k]):>12d}")
    assert sum(port.values()) > 0 and sum(ref.values()) > 0


# ------------------------------------------------- MoE groups across ranks
UNEVEN = dataclasses.replace(get_shape("train_4k"), seq_len=41,
                             global_batch=8)


def _gathers(gm, shape):
    from repro_torch.roofline.collectives import kind_of
    return sum(kind_of(n) == "all-gather" and
               tuple(n.meta["val"].shape) == shape for n in gm.graph.nodes)


def test_uneven_moe_groups_trace(world):
    """deepseek-v3's smoke config at 8 x 41 on the (2, 4) mesh: the mtp
    layer routes 8 x 40 = 320 tokens in 5 groups of ``moe_group`` = 64,
    and each of the 2 data ranks holds 160 tokens, 2.5 groups (the
    production cell's 65,520 tokens a rank are 511.875 groups). The main
    MoE layer's 8 x 41 = 328 tokens are 8 groups of 41, 4 a rank. DTensor
    refuses the view of rows as groups in the mtp layer; the MoE gathers
    its input there, so the trace holds two all-gathers of the whole
    (8, 40, 64) mtp input (the input, and its gradient's way back), and
    none of the main layer's (8, 41, 64)."""
    gm, _ = dryrun.trace_cell(get_smoke_config("deepseek-v3-671b"), UNEVEN,
                              debug_mesh(False), weights="bf16")
    assert _gathers(gm, (8, 40, 64)) == 2
    assert _gathers(gm, (8, 41, 64)) == 0
    rec = dryrun.cell_record(get_smoke_config("deepseek-v3-671b"), UNEVEN,
                             debug_mesh(False), "deepseek-v3-671b|uneven",
                             weights="bf16")
    check_record(rec)


def test_uneven_moe_dp_all_reduce_bytes_match_reference(world, reference):
    """The uneven cell in dp mode. Its all-reduces whose result has a
    parameter's shape are the gradient reductions: every parameter's
    float32 gradient once, but the mtp layer's router and experts, whose
    gradients are whole on every data rank (every rank routes every group
    of the gathered mtp input; GSPMD gathers it too: the reference's HLO
    holds as many all-gathers of the (8, 40, 64) mtp input as the port's
    trace). The others are activations' partial sums over ``model`` (the
    rows (4, 41, 64) and (4, 40, 64): DTensor shards the heads and the
    experts over ``model``) and scalar reductions. Against the reference's
    HLO (read by the rule of ``test_dp_all_reduce_bytes_match_reference``),
    named bytes: the reference reduces the output head's gradient once per
    chunk of each of the two cross entropies' loops (main and mtp, 2 + 2
    chunks of 32; the port once), and the embedding's gradient twice (the
    token lookup and the mtp's next-token lookup, reduced apart). With
    those the port is within 1% of the reference; the rest is the scalar
    reductions."""
    from repro_torch.roofline.collectives import kind_of
    cfg = get_smoke_config("deepseek-v3-671b")
    gm, _ = dryrun.trace_cell(cfg, UNEVEN, debug_mesh(False),
                              weights="bf16", mode="dp")
    params = steps.build_cell(cfg, UNEVEN, debug_mesh(False),
                              mode="dp").args[0]["params"]
    shapes = {tuple(t.shape) for t in tree_leaves(params)}
    grads = rest = 0
    for n in gm.graph.nodes:
        if kind_of(n) == "all-reduce":
            v = n.meta["val"]
            b = v.numel() * v.element_size()
            if tuple(v.shape) in shapes:
                grads += b
            else:
                rest += b
                assert v.dim() == 1 or tuple(v.shape) in {
                    (4, 41, 64), (4, 40, 64)}, tuple(v.shape)

    def size(tree):
        return 4 * sum(math.prod(t.shape) for t in tree_leaves(tree))

    moe = params["mtp"]["layer"]["mlp"]
    assert grads == size(params) - size(moe["experts"]) - size(moe["router"])
    head = 4 * cfg.d_model * cfg.vocab
    chunks = sum(math.ceil(s / min(cfg.xent_chunk, s))
                 for s in (UNEVEN.seq_len, UNEVEN.seq_len - 1))
    named = head * (chunks - 1) + size(params["embed"])
    ref = reference["deepseek-v3-671b|train|dp"]
    port = collective_bytes(gm)
    print("deepseek-v3 uneven dp train bytes per device (port, reference):")
    for k in port:
        print(f"  {k:20s} {port[k]:>12d} {int(ref['coll'][k]):>12d}")
    print(f"  gradient all-reduce {grads}, activations and scalars {rest}, "
          f"named {named}")
    assert port["all-reduce"] == grads + rest
    assert abs(grads + named - ref["coll"]["all-reduce"]) <= \
        0.01 * ref["coll"]["all-reduce"]
    assert _gathers(gm, (8, 40, 64)) == ref["gathers"].count("f32[8,40,64]")


def test_plain_moe_groups_unchanged():
    """On plain tensors ``moe_ffn`` routes the groups ``x.reshape(T // N,
    N, D)`` (the gather is for DTensors only), and its output and aux loss
    are bit for bit the composition of ``route``, the dispatch, the
    experts and the combine on those groups: the uneven cell's mtp tokens
    (8 x 40) and the main layer's (8 x 41)."""
    import torch

    from repro_torch.core.context import QuantCtx
    from repro_torch.models import common, moe
    cfg = get_smoke_config("deepseek-v3-671b")
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(gen, cfg, torch.float32, "cpu")
    seen = []
    route = moe.route
    moe.route = lambda p_, xt, c: seen.append(xt) or route(p_, xt, c)
    try:
        for S in (UNEVEN.seq_len - 1, UNEVEN.seq_len):
            x = torch.randn(8, S, cfg.d_model, generator=gen)
            ctx = QuantCtx(mode="fp")
            y, aux = moe.moe_ffn(p, x, cfg, ctx, "m")
            N = moe._pick_group(8 * S, cfg.moe_group)
            assert not moe._straddled(x, N)
            xt = x.reshape(8 * S // N, N, cfg.d_model)
            assert torch.equal(seen[-1], xt)
            probs, _, dispatch, combine = route(p, xt, cfg)
            ye = common.mlp(p["experts"], moe._dispatch(dispatch, xt), ctx,
                            "m.experts", cfg.act, batch_dims=1)
            want = moe._combine(combine, ye).reshape(x.shape) + common.mlp(
                p["shared"], x, ctx, "m.shared", cfg.act)
            aux_want = cfg.n_experts * torch.sum(
                torch.mean(probs, dim=(0, 1))
                * torch.mean(dispatch.sum(-1), dim=(0, 1)))
            assert torch.equal(y, want) and torch.equal(aux, aux_want)
    finally:
        moe.route = route


# ---------------------------------------------------------------- depth
@pytest.mark.parametrize("kind", KINDS)
def test_depth_adds_whole_layers(world, kind):
    """bytes(4 layers) - bytes(2) = 2 x (bytes(3) - bytes(2)), by kind."""
    base = get_smoke_config("smollm-135m")
    shape, weights = KINDS[kind]
    by = {}
    for n in (2, 3, 4):
        gm, _ = dryrun.trace_cell(dataclasses.replace(base, n_layers=n),
                                     shape, debug_mesh(False),
                                     weights=weights)
        by[n] = collective_bytes(gm)
    one = {k: by[3][k] - by[2][k] for k in by[2]}
    assert sum(one.values()) > 0
    assert {k: by[4][k] - by[2][k] for k in by[2]} == {
        k: 2 * v for k, v in one.items()}


# ------------------------------------------------------------- position
def test_decode_collectives_do_not_depend_on_position(world):
    """Positions 5 and 40 lie in the first and third of the cache's four
    sequence shards (64 positions over ``model`` = 4)."""
    cfg = get_smoke_config("smollm-135m")
    graphs = [dryrun.trace_cell(cfg, DECODE, debug_mesh(False),
                                weights="int8", pos=p)[0] for p in (5, 40)]
    assert collective_counts(graphs[0]) == collective_counts(graphs[1])
    assert collective_bytes(graphs[0]) == collective_bytes(graphs[1])


# -------------------------------------------------------- MoE placements
def moe_hint_placements(arch, multi_pod):
    """The placements of the MoE's expert buffers (``xe``, ``ye``) and
    masks in one traced decode step (int8 experts: K5 on the local
    shards), and the expert weights' (their E dim's mesh axes)."""
    from repro_torch.launch import sharding
    from repro_torch.models import common, moe
    seen = []
    hint = common.shard_hint

    def spy(x, *axes):
        y = hint(x, *axes)
        if (common.is_dtensor(y) and y.dim() == 4 and sys._getframe(1)
                .f_code.co_filename == moe.__file__):
            seen.append(tuple(y.placements))
        return y

    mesh = debug_mesh(multi_pod)
    cfg = get_smoke_config(arch)
    moe.common.shard_hint = spy
    try:
        dryrun.trace_cell(cfg, DECODE, mesh, weights="int8")
    finally:
        moe.common.shard_hint = hint
    spec = steps.build_cell(cfg, DECODE, mesh).in_shardings[0]
    w = spec["layers"][-1]["mlp"]["experts"]["w_up"].codes
    return seen, sharding.placements(w, mesh)


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", ("llama4-scout-17b-a16e", "deepseek-v3-671b"))
def test_moe_expert_buffers_take_expert_placement(arch, multi_pod):
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_world(8):
        seen, w_pl = moe_hint_placements(arch, multi_pod)
    assert seen
    # w (E, d_in, d_out): E is dim 0; the buffers (G, E, C, D) / the masks
    # (G, N, E, C) hold E at dim 1 / 2, the groups at dim 0 unless full EP
    full = multi_pod  # E = 4 divides data x model = 4 on (2, 2, 2) only
    for pl in seen:
        for p, wp in zip(pl, w_pl):
            if wp == Shard(0):
                assert p in (Shard(1), Shard(2)), (pl, w_pl)
            elif full:
                assert p == Replicate(), (pl, w_pl)
    expect = ("data", "model") if full else ("model",)
    _, axis_names = mesh_layout("debug", multi_pod=multi_pod)
    got = tuple(n for n, p in zip(axis_names, w_pl) if p == Shard(0))
    assert got == expect

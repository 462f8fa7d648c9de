"""Port parity for the PTQ launcher: ``repro_torch.launch.quantize`` against
the reference's ``repro.launch.quantize.main`` at the smollm-135m smoke
config (2 layers, width 64, float32) on the CPU.

Each reference configuration runs once (module fixture); the port's
launcher gets the reference's ``model.init(jax.random.key(0))`` weights and
its ``CalibrationSet`` tokens (8 x 16) through ``run``'s seam, so both
quantize the same inputs. Tolerances:

- ``--iters 0`` (W4 body, W8 layer 0, A8): the export depends on the
  weights only, so every QTensor's codes, scale, zero and static fields and
  the saved metadata (arch, method, bits, canonical rules) are bit-exact.
  The activation states come from observed ranges of activations that
  passed through an RMSNorm and matmuls, whose float32 sums XLA and torch
  order differently (layer 0's ``wq`` step already differs in its last
  bit), so they are held to relative 1e-5, as ``test_torch_serve.py`` does.
- ``--iters 2``, weight-only W4: 8 calibration sequences and the
  launcher's ``batch_size=min(16, calib)`` make every step full-batch, and
  without activation quantization QDrop draws nothing, so both runs see the
  same inputs; the reports are held to the full-batch weight-only
  trajectory tolerance of ``test_torch_recon.py`` (relative 1e-5).
- ``--serve``: the greedy tokens of the port's scheduler run equal the
  reference scheduler's on the ``--iters 0`` export.
"""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import CalibrationSet as JCalibrationSet
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import quantize as jquantize
from repro.models import build_model as jbuild_model
from repro.serve import scheduler as jscheduler
from repro_torch import bridge
from repro_torch.checkpoint import PTQCheckpointer, load_pytree
from repro_torch.core.qtensor import QTensor
from repro_torch.launch import quantize

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "smollm-135m", "--smoke", "--calib", "8", "--seq", "16"]
RUNS = {
    "export": SMOKE + ["--w-bits", "4", "--a-bits", "8", "--rule",
                       "layers.0.*:w_bits=8", "--iters", "0", "--serve",
                       "--serve-requests", "5", "--serve-max-new", "6"],
    "train": SMOKE + ["--w-bits", "4", "--iters", "2"],
}


def _reference(argv, out):
    """The reference launcher under ``argv``; returns (tree, meta, reports,
    served tokens) — the reports and tokens captured from the functions it
    calls."""
    got = {"served": {}}
    real_qb, real_run = jquantize.quantize_blocks, jscheduler.Scheduler.run

    def quantize_blocks(*a, **k):
        res = real_qb(*a, **k)
        got["reports"] = res[2]
        return res

    def run(self, requests):
        outs = real_run(self, requests)
        got["served"] = {rid: list(v) for rid, v in outs.items()}
        return outs

    saved_argv = sys.argv
    jquantize.quantize_blocks, jscheduler.Scheduler.run = quantize_blocks, run
    sys.argv = ["repro.launch.quantize"] + argv + ["--out", out]
    try:
        jquantize.main()
    finally:
        sys.argv = saved_argv
        jquantize.quantize_blocks, jscheduler.Scheduler.run = real_qb, real_run
    tree, meta = jload_pytree(out)
    return tree, meta, got["reports"], got["served"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    jcfg = jget_smoke_config("smollm-135m")
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    calib = np.asarray(JCalibrationSet.build(
        JSyntheticTokens(vocab=jcfg.vocab, seq_len=16, seed=0), 8).tokens)
    out = {}
    for tag, argv in RUNS.items():
        jtree, jmeta, jreports, jserved = _reference(argv, str(d / f"j_{tag}"))
        args = quantize.build_parser().parse_args(
            argv + ["--out", str(d / f"t_{tag}"), "--device", "cpu"])
        res = quantize.run(args, params=bridge.params(jparams, "cpu"),
                           calib_tokens=torch.from_numpy(calib.copy()))
        tree, meta = load_pytree(str(d / f"t_{tag}"), device="cpu")
        out[tag] = dict(jtree=jtree, jmeta=jmeta, jreports=jreports,
                        jserved=jserved, tree=tree, meta=meta, res=res)
    return out


def _qtensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}{k}.")
    elif hasattr(tree, "pack_axis"):
        yield prefix[:-1], tree


def _layers(params):
    return bridge.params(params, "cpu")["layers"] if isinstance(
        params["layers"], dict) else params["layers"]


def test_export_only_run_is_bit_exact(runs):
    r = runs["export"]
    jlayers, layers = _layers(r["jtree"]["params"]), r["tree"]["params"]["layers"]
    assert len(layers) == len(jlayers) == 2
    routes = set()
    for jl, tl in zip(jlayers, layers):
        jq, tq = dict(_qtensors(jl)), dict(_qtensors(tl))
        assert sorted(jq) == sorted(tq) and len(tq) == 7
        for name, qt in tq.items():
            j = jq[name]
            assert isinstance(qt, QTensor)
            assert (qt.shape, qt.bits, qt.packed, qt.dtype, qt.pack_axis) == (
                tuple(j.shape), j.bits, j.packed, j.dtype, j.pack_axis), name
            for fld in ("codes", "scale", "zero"):
                np.testing.assert_array_equal(
                    bridge.to_numpy(getattr(qt, fld)),
                    np.asarray(getattr(j, fld)), err_msg=f"{name}.{fld}")
            routes.add((qt.bits, qt.packed))
    assert routes == {(8, False), (4, True)}
    jast, ast = r["jtree"]["astates"], r["tree"]["astates"]
    assert sorted(ast) == sorted(jast) and len(ast) == 14
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(bridge.to_numpy(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)
    assert sorted(r["meta"]) == sorted(r["jmeta"])
    for k in ("arch", "method", "w_bits", "a_bits", "rules"):
        assert r["meta"][k] == r["jmeta"][k], k
    assert r["meta"]["rules"] == ["layers.0.*:w_bits=8"]
    assert r["meta"]["manifest"]["device"] == "cpu"


def test_two_step_weight_only_reports_match(runs):
    r = runs["train"]
    reps, jreps = r["res"].reports, r["jreports"]
    assert len(reps) == len(jreps) == 2
    for rep, jrep in zip(reps, jreps):
        assert rep.name == jrep.name and rep.iters == jrep.iters == 2
        np.testing.assert_allclose(rep.err_before, jrep.err_before, rtol=1e-5)
        np.testing.assert_allclose(rep.err_after, jrep.err_after, rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)
    assert r["res"].recipe.batch_size == 8 and r["res"].recipe.a_bits is None
    assert r["res"].resumed_units == 0


def test_serve_tokens_equal_the_reference_scheduler(runs):
    r = runs["export"]
    served = r["res"].serve
    assert served["outputs"] == r["jserved"]
    assert sorted(served["outputs"]) == list(range(5))
    assert all(len(v) == 6 for v in served["outputs"].values())
    st = served["stats"]
    assert st["requests"]["admitted"] == st["requests"]["finished"] == 5
    assert sum(h["count"] for h in st["prefill_us"].values()) == \
        sum(st["prefill_calls"].values())


@pytest.mark.parametrize("flags,item", [
    (["--analyze"], "item 15"), (["--analyze-mem"], "item 15"),
])
def test_unported_flags_exit_naming_their_roadmap_item(flags, item, capsys):
    """``--analyze``/``--analyze-mem`` exited naming ROADMAP item 15 until
    the traced-graph layers were ported; they now run quantlint after the
    launcher run (memcheck too for the latter) and exit non-zero on an
    error, which on the CPU is QL304's need of the card alone."""
    with pytest.raises(SystemExit) as e:
        quantize.main(SMOKE + ["--iters", "0", "--device", "cpu"] + flags)
    assert e.value.code == "quantlint: error findings (see above)"
    assert item not in e.value.code
    errors = {line.split()[1] for line in capsys.readouterr().out.splitlines()
              if line.startswith("ERROR")}
    assert errors == {"QL304/needs-card"}


# ------------------------------------------------------------- --mesh
MESH_RUNS = {  # tag: flags; both with the debug mesh's 8 ranks
    "export": SMOKE + ["--w-bits", "4", "--a-bits", "8", "--rule",
                       "layers.0.*:w_bits=8", "--iters", "0", "--device",
                       "cpu", "--serve-smoke"],
    "train": SMOKE + ["--w-bits", "4", "--rule", "layers.0.*:w_bits=8",
                      "--iters", "3", "--device", "cpu"],
}


def _torchrun(n, argv, tmp, timeout=300):
    """``python -m torch.distributed.run --nproc-per-node n -m
    repro_torch.launch.quantize argv`` on the CPU; (exit code, output)."""
    from test_torch_mesh import free_port, rank_env
    env = rank_env(1)
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    log = tmp / f"torchrun-{n}.log"
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
             str(n), "--master-addr", "localhost", "--master-port",
             str(free_port()), "-m", "repro_torch.launch.quantize"] + argv,
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            timeout=timeout)
    return proc.returncode, log.read_text()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Each of MESH_RUNS with the debug mesh (2 x 4) in 8 torchrun ranks,
    and in one process on the same calibration set (the data-parallel
    ranks' shards, as ``CalibrationSet.build_sharded`` assembles them in
    one process)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import CalibrationSet, SyntheticTokens
    cal, weight = CalibrationSet.build_sharded(SyntheticTokens(
        vocab=get_smoke_config("smollm-135m").vocab, seq_len=16, seed=0), 8, 2)
    assert torch.equal(weight, torch.ones(8))
    out = {}
    for tag, argv in MESH_RUNS.items():
        d = tmp_path_factory.mktemp(f"mesh_{tag}")
        extra = (["--telemetry", str(d / "tel"), "--resume-dir",
                  str(d / "resume")] if tag == "export" else [])
        rc_, log = _torchrun(8, argv + ["--mesh", "debug", "--out",
                                        str(d / "mesh")] + extra, d)
        assert rc_ == 0, log[-4000:]
        tree, _ = load_pytree(str(d / "mesh"), device="cpu")
        args = quantize.build_parser().parse_args(argv + ["--out",
                                                          str(d / "one")])
        out[tag] = dict(d=d, log=log, tree=tree, one=quantize.run(
            args, calib_tokens=cal.tokens))
    return out


def _code_diff(a, b, packed):
    """(largest level difference, share of bytes that differ)."""
    a, b = a.numpy().astype(int), b.numpy().astype(int)
    pairs = ([(a & 15, b & 15), (a >> 4, b >> 4)] if packed else [(a, b)])
    return max(int(np.abs(x - y).max()) for x, y in pairs), (a != b).mean()


def _mesh_qtensors(run):
    for tl, ol in zip(run["tree"]["params"]["layers"],
                      run["one"].qparams["layers"]):
        tq, oq = dict(_qtensors(tl)), dict(_qtensors(ol))
        assert sorted(tq) == sorted(oq) and len(tq) == 7
        for name, qt in tq.items():
            yield name, qt, oq[name]


def test_mesh_debug_export_in_eight_ranks_is_one_process_export(mesh_runs):
    """``--iters 0``, W4A8: the activation ranges are reduced with MIN and
    MAX (exact), so the export and the activation states are the one
    process's bit for bit."""
    run = mesh_runs["export"]
    for name, qt, one in _mesh_qtensors(run):
        for fld in ("codes", "scale", "zero"):
            assert torch.equal(getattr(qt, fld), getattr(one, fld)), name
    ast, oast = run["tree"]["astates"], run["one"].astates
    assert sorted(ast) == sorted(oast) and len(ast) == 14
    for site in oast:
        for k in oast[site]:
            assert torch.equal(ast[site][k], oast[site][k]), site


def test_mesh_debug_training_in_eight_ranks_matches_one_process(mesh_runs):
    """Weight-only W4 (W8 layer 0), 3 steps: the gradients are the one
    process's up to float summation order, and Adam's first steps turn a
    near-zero gradient's sign into a whole step of lr (3e-3: W8 layer 0's
    error grows from 1e-4 to 0.18 in 3 steps on either side). Measured on
    the CPU: at most 3.7% of a site's code bytes differ, block errors
    within 0.5%. Held to 5% of the bytes and 2%."""
    run = mesh_runs["train"]
    for name, qt, one in _mesh_qtensors(run):
        assert torch.equal(qt.zero, one.zero), name  # the observer's grid
        assert _code_diff(qt.codes, one.codes, qt.packed)[1] <= 0.05, name
    errs = [tuple(float(v) for v in m) for m in re.findall(
        r"\] layers\.\d err (\S+) -> (\S+)", run["log"])]
    one = [(r.err_before, r.err_after) for r in run["one"].reports]
    np.testing.assert_allclose(errs[0][0], one[0][0], rtol=1e-3)
    np.testing.assert_allclose(errs, one, rtol=2e-2)


def test_mesh_debug_run_prints_its_choices_and_writes_per_rank(mesh_runs):
    """The backend and why, the calibration's shards; rank 0 alone
    reports, exports and serves; each rank's telemetry file carries its
    rank."""
    log, d = mesh_runs["export"]["log"], mesh_runs["export"]["d"]
    for r in range(8):
        assert f"distributed: rank {r} of 8, backend gloo (the CPU)" in log
    assert log.count("calibration: 8 samples assembled from 2 per-rank "
                     "shards (dp axes ('data',), weight mass 8/8)") == 1
    assert log.count("quantized 2 blocks") == 1
    assert log.count("serve-smoke[auto]") == 1
    assert log.count("[2/2] layers.1") == 1
    assert sorted(os.listdir(d / "tel")) == [
        f"events.rank{r}.jsonl" for r in range(8)]
    assert os.path.isdir(d / "resume" / "ptq_state")


def test_mesh_needs_its_world_size():
    with pytest.raises(SystemExit) as e:
        quantize.main(SMOKE + ["--iters", "0", "--device", "cpu", "--mesh",
                               "debug"])
    msg = e.value.code
    assert "8 ranks" in msg and "world size of 1" in msg
    assert "torch.distributed.run --nproc-per-node 8" in msg
    with pytest.raises(SystemExit, match="--multi-pod shapes the --mesh"):
        quantize.main(SMOKE + ["--iters", "0", "--device", "cpu",
                               "--multi-pod"])


def test_mesh_calib_must_divide_over_the_data_ranks(tmp_path):
    rc_, log = _torchrun(8, SMOKE[:-4] + ["--calib", "7", "--seq", "16",
                                          "--iters", "0", "--device", "cpu",
                                          "--mesh", "debug"], tmp_path)
    assert rc_ != 0
    assert "--calib 7 does not divide over the mesh's 2 data-parallel" in log


@pytest.mark.parametrize("chunk", [1, 2])
def test_scan_chunk_sets_the_chunks_and_changes_no_result(tmp_path, capsys,
                                                          chunk):
    """``--scan-chunk N`` (it used to refuse all but 100) is the number of
    steps between host syncs: 3 steps per block give ceil(3 / N)
    ``recon.chunk`` spans per block, and every result equals the default
    run's. The launcher prints the reference's ``compiles:`` line: on the
    CPU nothing is captured, and the two W4 layers share one engine."""
    argv = SMOKE + ["--w-bits", "4", "--a-bits", "8", "--iters", "3",
                    "--device", "cpu"]
    plain = quantize.main(argv + ["--out", str(tmp_path / "plain")])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("recon:")]
    assert len(line) == 1 and line[0].endswith(
        "compiles: step=0 teacher=0 student=0 recon_err=0 schedule=0 "
        "probe=0 (total 0); engines 1 built, 1 reused"), line
    tel = tmp_path / "tel"
    res = quantize.main(argv + ["--out", str(tmp_path / "chunked"),
                                "--scan-chunk", str(chunk),
                                "--telemetry", str(tel)])
    spans = [json.loads(ln) for ln in open(tel / "events.jsonl")]
    chunks = [e for e in spans if e.get("kind") == "span"
              and e.get("name") == "recon.chunk"]
    assert len(chunks) == 2 * -(-3 // chunk)
    for a, b in zip(res.reports, plain.reports):
        assert (a.err_before, a.err_after) == (b.err_before, b.err_after)
        np.testing.assert_array_equal(a.loss_curve, b.loss_curve)
        assert a.engine == b.engine == "eager"


def test_scan_chunk_below_one_is_refused():
    with pytest.raises(SystemExit) as e:
        quantize.main(SMOKE + ["--iters", "0", "--device", "cpu",
                               "--scan-chunk", "0"])
    assert e.value.code == 2  # argparse's usage error


def test_profile_writes_a_trace(tmp_path):
    """``--profile`` (it used to exit naming ROADMAP item 12) writes a Chrome
    trace under ``--telemetry DIR``/profile that holds the recon chunks and
    the serve steps, and changes nothing the run computes."""
    argv = SMOKE + ["--w-bits", "4", "--iters", "2", "--device", "cpu",
                    "--serve", "--serve-requests", "3", "--serve-max-new", "4"]
    plain = quantize.main(argv + ["--out", str(tmp_path / "plain")])
    tel = tmp_path / "tel"
    prof = quantize.main(argv + ["--out", str(tmp_path / "prof"), "--profile",
                                 "--telemetry", str(tel)])
    files = sorted((tel / "profile").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("recon.chunk") == 2  # one per block of the smoke model
    assert names.count("serve.decode_step") == prof.serve["stats"][
        "decode_steps"] > 0
    assert names.count("serve.prefill") == sum(
        prof.serve["stats"]["prefill_calls"].values())
    assert prof.serve["outputs"] == plain.serve["outputs"]
    for a, b in zip(prof.reports, plain.reports):
        assert (a.err_before, a.err_after) == (b.err_before, b.err_after)
        np.testing.assert_array_equal(a.loss_curve, b.loss_curve)
    ta = load_pytree(str(tmp_path / "prof"), device="cpu")[0]
    tb = load_pytree(str(tmp_path / "plain"), device="cpu")[0]
    for la, lb in zip(ta["params"]["layers"], tb["params"]["layers"]):
        for (na, qa), (nb, qb) in zip(_qtensors(la), _qtensors(lb)):
            assert na == nb and torch.equal(qa.codes, qb.codes)


def test_cli_choices_come_from_registry():
    import inspect
    src = inspect.getsource(quantize)
    assert "method_api.available_methods()" in src
    assert '"rtn", "adaround"' not in src


def test_llama4_smoke_export_only(tmp_path):
    res = quantize.main(["--arch", "llama4-scout-17b-a16e", "--smoke",
                         "--w-bits", "4", "--iters", "0", "--calib", "4",
                         "--seq", "8", "--device", "cpu",
                         "--out", str(tmp_path / "q")])
    tree, meta = load_pytree(str(tmp_path / "q"), device="cpu")
    assert meta["arch"] == "llama4-scout-17b-a16e-smoke"
    experts = tree["params"]["layers"][0]["mlp"]["experts"]
    assert isinstance(experts["w_up"], QTensor) and experts["w_up"].bits == 4
    assert experts["w_up"].shape[0] == res.cfg.n_experts
    assert len(res.reports) == res.cfg.n_layers


def test_resume_dir_after_an_interruption_equals_a_run_without_one(tmp_path):
    """The launcher with ``--resume-dir``: stopped right after block 0's
    checkpoint, then run again; the export equals an uninterrupted run's."""
    argv = SMOKE + ["--w-bits", "4", "--a-bits", "8", "--iters", "3",
                    "--calib", "6", "--device", "cpu"]
    quantize.main(argv + ["--out", str(tmp_path / "a")])

    class Stop(Exception):
        pass

    real_save = PTQCheckpointer.save

    def save(self, next_block, *a, **k):
        real_save(self, next_block, *a, **k)
        raise Stop

    ckpt = str(tmp_path / "ckpt")
    PTQCheckpointer.save = save
    try:
        with pytest.raises(Stop):
            quantize.main(argv + ["--resume-dir", ckpt,
                                  "--out", str(tmp_path / "b")])
    finally:
        PTQCheckpointer.save = real_save
    assert PTQCheckpointer(ckpt).meta()["next_block"] == 1
    res = quantize.main(argv + ["--resume-dir", ckpt,
                                "--out", str(tmp_path / "b")])
    assert res.resumed_units == 1
    a, _ = load_pytree(str(tmp_path / "a"), device="cpu")
    b, _ = load_pytree(str(tmp_path / "b"), device="cpu")
    for la, lb in zip(a["params"]["layers"], b["params"]["layers"]):
        for (name, qa), (_, qb) in zip(_qtensors(la), _qtensors(lb)):
            for fld in ("codes", "scale", "zero"):
                assert torch.equal(getattr(qa, fld), getattr(qb, fld)), name
    for site in a["astates"]:
        for k in ("step", "beta"):
            assert torch.equal(a["astates"][site][k], b["astates"][site][k])


def test_module_entry_point_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.quantize`` as a user runs it, W4
    weight-only, two steps, then serving; the process imports no jax."""
    cmd = [sys.executable, "-c",
           "import runpy, sys; sys.argv[0] = 'quantize'; "
           "runpy.run_module('repro_torch.launch.quantize', "
           "run_name='__main__'); "
           "assert 'jax' not in sys.modules and 'repro' not in sys.modules",
           "--arch", "smollm-135m", "--smoke", "--w-bits", "4", "--iters",
           "2", "--calib", "8", "--seq", "16", "--device", "cpu", "--serve",
           "--out", str(tmp_path / "q")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "quantized 2 blocks" in p.stdout
    assert "serve[auto] kv=int8: 8 requests x 16 tokens" in p.stdout
    tree, meta = load_pytree(str(tmp_path / "q"), device="cpu")
    assert meta["w_bits"] == 4 and meta["a_bits"] is None

"""The port's checkpoints: the save/load format, atomic commits under a
SIGKILL, rolling step checkpoints, and per-block PTQ resume.

The resume is held to the reference's promise ("a preempted run resumes at
the first unfinished block with identical RNG"), not to what the reference
does (it pushes the saved streams through the finished blocks again and
draws block 0's key for the first resumed block; ROADMAP Queue 3): a
``quantize_blocks`` run stopped after the checkpoint of block k and resumed
gives the codes, scales, zeros, activation states, reports and final
streams of a run without a break, bit for bit, block-wise and layer-wise,
with A8 activations under QDrop and minibatches drawn from the run's
generators.
"""
import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, PTQCheckpointer, exists,
                                    load_pytree, save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.core import reconstruct as rc
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's raw bits, so NaN payloads and -0.0 compare too."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
            t.element_size()])
    return t


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), where
    elif isinstance(a, QTensor):
        assert isinstance(b, QTensor), where
        for f in ("shape", "bits", "packed", "dtype", "pack_axis"):
            assert getattr(a, f) == getattr(b, f), f"{where}.{f}"
        for f in ("codes", "scale", "zero"):
            _assert_same(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.int32, torch.uint8,
                                   torch.int8, torch.bool])
def test_round_trip_is_bit_exact(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        t = torch.randn((5, 7), generator=g).to(dtype)
        t[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    elif dtype == torch.bool:
        t = torch.rand((5, 7), generator=g) > 0.5
    else:
        t = torch.randint(0, 100, (5, 7), generator=g).to(dtype)
    qt = QTensor(codes=torch.randint(0, 256, (3, 6), generator=g,
                                     dtype=torch.uint8),
                 scale=torch.rand((1, 6), generator=g),
                 zero=torch.full((1, 6), 8.0), shape=(6, 6), bits=4,
                 packed=True, dtype="bfloat16", pack_axis=0)
    tree = {"w": t, "layers": [{"q": qt, "b": t[1:3]}, None],
            "n": 3, "x": 2.5, "s": "name", "flag": True}
    save_pytree(str(tmp_path / "c"), tree, {"step": 7, "note": "x"})
    got, meta = load_pytree(str(tmp_path / "c"), device="cpu")
    assert meta == {"step": 7, "note": "x"}
    _assert_same(tree, got)


def test_views_are_saved_compactly_and_bad_trees_refused(tmp_path):
    big = torch.zeros((1024, 1024))
    save_pytree(str(tmp_path / "v"), {"row": big[3]})
    assert os.path.getsize(tmp_path / "v" / "tensors.pt") < 64 * 1024
    with pytest.raises(TypeError, match="keys must be str"):
        save_pytree(str(tmp_path / "k"), {1: big[0]})
    with pytest.raises(TypeError, match="cannot checkpoint ndarray"):
        save_pytree(str(tmp_path / "n"), {"a": np.zeros(3)})
    assert not exists(str(tmp_path / "k")) and not exists(str(tmp_path / "n"))
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "missing"), device="cpu")


_KILLED_SAVE = """
import os, signal, sys
import torch
from repro_torch.checkpoint import checkpoint as ck
path, when = sys.argv[1], int(sys.argv[2])
ck.save_pytree(path, {"v": torch.tensor([1.0])}, {"version": 1})
real, calls = os.replace, []
def replace(src, dst):
    calls.append(src)
    if len(calls) == when:
        os.kill(os.getpid(), signal.SIGKILL)
    real(src, dst)
os.replace = replace
ck.save_pytree(path, {"v": torch.tensor([2.0])}, {"version": 2})
"""


@pytest.mark.parametrize("when", [1, 2], ids=["before_the_first_rename",
                                              "between_the_renames"])
def test_a_kill_mid_save_leaves_the_previous_checkpoint(tmp_path, when):
    """SIGKILL after the new checkpoint is written to its temporary
    directory, before the old one is moved aside (1) or after it is moved
    aside and before the new one is renamed into place (2)."""
    path = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", _KILLED_SAVE, path, str(when)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert exists(path)
    tree, meta = load_pytree(path, device="cpu")
    assert meta == {"version": 1} and float(tree["v"]) == 1.0
    save_pytree(path, {"v": torch.tensor([3.0])}, {"version": 3})
    tree, meta = load_pytree(path, device="cpu")
    assert meta == {"version": 3} and float(tree["v"]) == 3.0
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore() == (None, None)
    for step in range(1, 6):
        mgr.save(step, {"params": {"w": torch.full((2,), float(step))}})
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    state, meta = mgr.restore(device="cpu")
    assert meta["step"] == 5 and torch.equal(state["params"]["w"],
                                             torch.full((2,), 5.0))
    state, meta = mgr.restore(step=4, device="cpu")
    assert meta["step"] == 4


# ------------------------------------------------------------ PTQ resume
RECIPE = dict(method="flexround", w_bits=4, a_bits=8,
              w_granularity="per_channel", setting="qdrop", iters=3,
              batch_size=4, rules=("layers.0.*:w_bits=8,lr=1e-5",))


def _chain(n_layers=3):
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    calib = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 16)))
    return model.quant_blocks(params, calib)


class _Stop(Exception):
    pass


def _interrupted(blocks, recipe, x0, ckpt_dir, stop, monkeypatch):
    """Run with checkpoints, raising right after block ``stop``'s."""
    real = PTQCheckpointer.save

    def save(self, next_block, *a, **k):
        real(self, next_block, *a, **k)
        if next_block == stop:
            raise _Stop

    with monkeypatch.context() as m:
        m.setattr(PTQCheckpointer, "save", save)
        with pytest.raises(_Stop):
            rc.quantize_blocks(blocks, recipe, x0, checkpoint_dir=ckpt_dir)
    assert PTQCheckpointer(ckpt_dir).meta()["next_block"] == stop


@pytest.mark.parametrize("stop", [1, 2, 3])
@pytest.mark.parametrize("recon", ["block", "layer"])
def test_resumed_run_equals_a_run_without_a_break(tmp_path, monkeypatch,
                                                  recon, stop):
    """Stopped after block ``stop`` of 3 (3: the run had finished) and
    resumed: finalized blocks, activation states, reports and the final
    streams equal those of a run without a break, bit for bit."""
    x0, blocks, _ = _chain()
    recipe = QuantRecipe(recon=recon, **RECIPE)
    ref_dir, dir_ = str(tmp_path / "ref"), str(tmp_path / "resumed")
    fin_a, ast_a, rep_a = rc.quantize_blocks(blocks, recipe, x0,
                                             checkpoint_dir=ref_dir)
    if stop < len(blocks):
        _interrupted(blocks, recipe, x0, dir_, stop, monkeypatch)
    else:
        rc.quantize_blocks(blocks, recipe, x0, checkpoint_dir=dir_)
    lines = []
    fin_b, ast_b, rep_b = rc.quantize_blocks(blocks, recipe, x0,
                                             checkpoint_dir=dir_,
                                             progress=lines.append)
    assert len(lines) == len(blocks) - stop
    _assert_same(fin_a, fin_b, "finalized")
    _assert_same(ast_a, ast_b, "astates")
    assert len(rep_a) == len(rep_b) == (len(blocks) if recon == "block"
                                        else 7 * len(blocks))
    for a, b in zip(rep_a, rep_b):
        assert (a.name, a.iters, a.err_before, a.err_after) == (
            b.name, b.iters, b.err_before, b.err_after)
        np.testing.assert_array_equal(a.loss_curve, b.loss_curve)
        np.testing.assert_array_equal(a.mse_curve, b.mse_curve)
    end_a, _ = load_pytree(PTQCheckpointer(ref_dir).path, device="cpu")
    end_b, _ = load_pytree(PTQCheckpointer(dir_).path, device="cpu")
    _assert_same(end_a["x_q"], end_b["x_q"], "x_q")
    _assert_same(end_a["x_fp"], end_b["x_fp"], "x_fp")


def test_resume_under_changed_rules_or_allocation_fails(tmp_path):
    x0, blocks, _ = _chain(2)
    recipe = QuantRecipe(**dict(RECIPE, iters=1))
    d = str(tmp_path)
    alloc = {"name": "auto-4.5", "digest": "0123456789abcdef"}
    rc.quantize_blocks(blocks, recipe, x0, checkpoint_dir=d,
                       allocation=alloc)
    changed = recipe.with_rules("layers.1.*:w_bits=8")
    with pytest.raises(ValueError, match="PTQ resume mismatch: block 1"):
        rc.quantize_blocks(blocks, changed, x0, checkpoint_dir=d,
                           allocation=alloc)
    for other in (None, dict(alloc, digest="fedcba9876543210")):
        with pytest.raises(ValueError, match="PTQ resume mismatch: "
                           "checkpoint was written under allocation"):
            rc.quantize_blocks(blocks, recipe, x0, checkpoint_dir=d,
                               allocation=other)
    fin, _, reps = rc.quantize_blocks(blocks, recipe, x0, checkpoint_dir=d,
                                      allocation=alloc)
    assert len(fin) == len(reps) == 2

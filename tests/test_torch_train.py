"""Port parity: training (``launch/steps.py``, ``launch/train.py``,
``configs/shapes.py``, the ``ARCH_MODE``/``SERVE_MODE`` tables and
``cfg.remat``) against the reference.

``make_train_step`` runs 3 steps on the smoke config (float32) of one
architecture per family: dense smollm-135m, moe llama4-scout-17b-a16e, MLA
deepseek-v3-671b (with its mtp head), vlm phi-3-vision-4.2b, encdec
whisper-medium, ssm mamba2-130m and hybrid recurrentgemma-2b, each with the
optimizer of its ``ARCH_MODE`` (``fsdp``: bfloat16 moments). The reference's
``make_train_step`` runs under ``jax.jit`` without donation: its launcher
donates the state, which its ``adam_init`` cannot give (one zeros buffer
for both moments; ``test_reference_launcher_fails_on_donation``). Both get
the reference's init and the same numpy batches. Tolerances:

- the loss and the global gradient norm of each step: relative 1e-5
  (float32 reduction order);
- the parameters after 3 steps: every element within 1e-6 of the
  reference's, except at most 0.5% of a leaf's elements (one in a leaf of
  fewer than 200), and none more than 3 lr (9e-4) apart. Adam's first
  steps move each element by about lr whatever its gradient's size; where
  a gradient is as small as eps (1e-8) its normalised update
  m / (sqrt(v) + eps) follows the float32 rounding of that gradient (on
  this CPU: at most 3 of 2,048 elements of a leaf, up to 4e-5 apart);
- ``microbatch=2`` against ``microbatch=1`` and against the reference's
  ``microbatch=2``: the same tolerances;
- ``cfg.remat`` on against off: the loss and every gradient bit for bit,
  with fewer bytes saved for the backward;
- the training launcher on the CPU: a run stopped after its step-2
  checkpoint and resumed ends with the state of a run without a break, bit
  for bit, on every architecture.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import cell_applicable as jcell_applicable
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro.optim.adam import adam_init as jadam_init
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_applicable,
                                 get_config, get_smoke_config)
from repro_torch.core.context import QuantCtx
from repro_torch.launch import sharding, steps, train
from repro_torch.models.model import build_model
from repro_torch.optim.adam import adam_init, tree_leaves

torch.set_num_threads(2)

CPU = "cpu"
FAMILIES = {"dense": "smollm-135m", "moe": "llama4-scout-17b-a16e",
            "mla": "deepseek-v3-671b", "vlm": "phi-3-vision-4.2b",
            "encdec": "whisper-medium", "ssm": "mamba2-130m",
            "hybrid": "recurrentgemma-2b"}
B, S = 4, 32
LR = 3e-4


def _np(t):
    return bridge.to_numpy(t)


def _batches(cfg, n, seed=0, B=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
                np.float32)
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.normal(
                0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _reference_run(arch, batches, microbatch=1):
    """The reference's ``make_train_step`` under ``jax.jit`` without
    donation: (params, [(loss, gnorm, metric keys)]) after the batches."""
    jcfg = jget_smoke_config(arch)
    jmodel = jbuild_model(jcfg)
    opt = jsteps.TRAIN_OPT[jsharding.ARCH_MODE[arch]]
    jparams = jmodel.init(jax.random.key(0))
    state = {"params": jparams, "opt": jadam_init(jparams, opt),
             "step": jnp.int32(0)}
    step = jax.jit(jsteps.make_train_step(jmodel, jcfg, opt, microbatch))
    hist = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["gnorm"]), sorted(m)))
    assert int(state["step"]) == len(batches)
    return jparams, state["params"], hist


def _port_run(arch, jparams, batches, microbatch=1):
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    opt = steps.TRAIN_OPT[sharding.ARCH_MODE[arch]]
    params = bridge.params(jparams, CPU)
    state = {"params": params, "opt": adam_init(params, opt), "step": 0}
    step = steps.make_train_step(model, cfg, opt, microbatch)
    hist = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["gnorm"]), sorted(m)))
    assert state["step"] == len(batches) and state["opt"]["count"] == 3
    return state["params"], hist


def _check_params(params, jparams):
    leaves, jleaves = tree_leaves(params), tree_leaves(
        bridge.params(jparams, CPU))
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        d = np.abs(_np(t).astype(np.float64) - _np(j))
        assert d.max() <= 3 * LR, d.max()
        assert (d > 1e-6).sum() <= max(1, d.size // 200), (
            (d > 1e-6).sum(), d.size, d.max())


def _check_hist(hist, jhist):
    for (l, g, keys), (jl, jg, jkeys) in zip(hist, jhist, strict=True):
        assert keys == jkeys
        np.testing.assert_allclose(l, jl, rtol=1e-5)
        np.testing.assert_allclose(g, jg, rtol=1e-5)


@pytest.fixture(scope="module")
def runs():
    """One reference run per family, shared by the tests below."""
    out = {}
    for fam, arch in FAMILIES.items():
        batches = _batches(get_smoke_config(arch), 3)
        out[fam] = (arch, batches) + _reference_run(arch, batches)
    return out


# --------------------------------------------------------------- tables
def test_shapes_and_modes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            assert cell_applicable(get_config(arch), shape) == \
                jcell_applicable(jget_config(arch), JSHAPES[shape.name])
    assert cell_applicable(get_config("recurrentgemma-2b"),
                           SHAPES["long_500k"]) == (True, "")
    assert sharding.ARCH_MODE == jsharding.ARCH_MODE
    assert sharding.SERVE_MODE == jsharding.SERVE_MODE
    assert set(sharding.ARCH_MODE) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert sharding.serve_mode(arch) == jsharding.serve_mode(arch)
    assert {k: dataclasses.asdict(v) for k, v in steps.TRAIN_OPT.items()} == {
        k: dataclasses.asdict(v) for k, v in jsteps.TRAIN_OPT.items()}


# ------------------------------------------------------------- the step
@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_steps_match_reference(runs, family):
    arch, batches, jparams0, jparams, jhist = runs[family]
    params, hist = _port_run(arch, jparams0, batches)
    _check_hist(hist, jhist)
    _check_params(params, jparams)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_microbatch_two_matches_one_and_the_reference(runs, family):
    """Two microbatches of 2: float32 gradient accumulation, divided by 2;
    the loss is their mean (the reference reports no other metric then)."""
    arch, batches, jparams0, jparams, jhist = runs[family]
    params2, hist2 = _port_run(arch, jparams0, batches, microbatch=2)
    _, jparams2, jhist2 = _reference_run(arch, batches, microbatch=2)
    _check_hist(hist2, jhist2)
    _check_params(params2, jparams2)
    assert [h[2] for h in hist2] == [["gnorm", "loss"]] * 3
    for (l2, g2, _), (l1, g1, _) in zip(hist2, jhist):
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        np.testing.assert_allclose(g2, g1, rtol=1e-5)
    _check_params(params2, jparams)


def _grads(cfg, batch, remat):
    """(loss, gradients in leaf order, bytes saved for the backward)."""
    cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(params, batch, QuantCtx(mode="fp"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads, saved[0]


@pytest.mark.parametrize("family", ["dense", "encdec", "ssm", "hybrid"])
def test_remat_changes_memory_not_values(family):
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): the loss and every gradient equal the
    run without it bit for bit, and less is saved for the backward."""
    cfg = get_smoke_config(FAMILIES[family])
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    l0, g0, saved0 = _grads(cfg, batch, False)
    l1, g1, saved1 = _grads(cfg, batch, True)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    assert saved1 < saved0


# --------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_launcher_resumes_bit_for_bit(tmp_path, arch):
    """``--smoke --steps 4 --ckpt-every 2 --device cpu``: without a break,
    and stopped right after its step-2 checkpoint, then run again (it
    resumes from step 2): the final states are equal bit for bit."""
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--ckpt-every", "2",
            "--device", "cpu"]
    a = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    class Stop(Exception):
        pass

    real_save = CheckpointManager.save

    def save(self, step, state, meta=None):
        path = real_save(self, step, state, meta)
        raise Stop(step)

    CheckpointManager.save = save
    try:
        with pytest.raises(Stop):
            train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    finally:
        CheckpointManager.save = real_save
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2]
    b = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert a["step"] == b["step"] == 4
    assert a["opt"]["count"] == b["opt"]["count"] == 4
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2, 4]


def test_reference_launcher_fails_on_donation(tmp_path):
    """The reference's launcher jits its step with the state donated, and
    its ``adam_init`` builds both moments of a leaf from one zeros array:
    the first step raises. (The step itself is sound: the tests above run
    it without donation.)"""
    saved = sys.argv
    sys.argv = ["repro.launch.train", "--arch", "smollm-135m", "--smoke",
                "--steps", "1", "--ckpt-dir", str(tmp_path)]
    try:
        with pytest.raises(Exception, match="donate the same buffer twice"):
            jtrain.main()
    finally:
        sys.argv = saved

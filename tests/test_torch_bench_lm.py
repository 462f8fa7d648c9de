"""Port parity: the bench LM (``repro_torch.launch.bench_lm``) against the
reference's ``benchmarks/common.py`` on the CPU.

The two packages draw their token streams differently (threefry against
the port's Philox-seeded generator, one closed form), so every test feeds
the port the reference's own weights (``bridge.params``) and batches:

- ``BENCH_CFG``, ``SEQ``, ``TRAIN_STEPS`` and ``BATCH`` equal the
  reference's, field for field;
- ``eval_ppl`` of the reference's LM after 5 of its Adam steps, on the
  reference's seed-99 evaluation batches: equal to ``common.eval_ppl`` to
  relative 1e-5 (float32 reduction order);
- ``train``: 5 Adam steps (lr 3e-3, clip 1.0) from the reference's initial
  weights on the reference's first 5 training batches: each step's loss
  within relative 1e-5 of the reference's, and the parameters held as
  ``test_torch_train.py`` holds them, scaled to this lr (10x its 3e-4):
  every element within lr / 300 (1e-5) but at most 0.5% of a leaf's, none
  more than 3 lr apart. Adam's update of a gradient as small as its eps
  follows the float32 rounding of that gradient (measured: up to 6
  elements of a leaf beyond 1e-5, 1.5e-4 at most);
- ``ptq`` at ``iters=0``, weight-only W4 per-channel: the export depends on
  the weights only, so every QTensor's codes are bit for bit
  ``common.ptq``'s (the reference's calibration tokens passed in);
- the cache: a second ``get_trained_lm`` loads the first one's tensors.

Run as a script, the file makes the carried quality run that ``PERF.md``
cites (minutes on the CPU): the reference's trained bench LM (300 steps,
trained here into ``build/bench_cache/reference``), carried into the port,
through the port's ``examples/torch_ptq_pipeline.py`` recipe (FlexRound
W4A8, QDrop, W8 first layer, 200 iterations) and RTN, with the
reference's calibration tokens and evaluation batches:

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/test_torch_bench_lm.py
"""
import dataclasses
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the reference's benchmarks package
    sys.path.insert(0, ROOT)

from benchmarks import common  # noqa: E402
from repro.core import QuantRecipe as JQuantRecipe  # noqa: E402
from repro.data import CalibrationSet as JCalibrationSet  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import QuantRecipe  # noqa: E402
from repro_torch.core.qtensor import QTensor  # noqa: E402
from repro_torch.launch import bench_lm  # noqa: E402
from repro_torch.optim.adam import tree_leaves  # noqa: E402

torch.set_num_threads(2)

CPU = "cpu"
STEPS = 5
LR = bench_lm.OPT.lr


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _ref_batches(seed, steps):
    src = JSyntheticTokens(vocab=common.BENCH_CFG.vocab, seq_len=common.SEQ,
                           seed=seed)
    return [_torch_batch(src.batch(i, common.BATCH)) for i in steps]


def _ref_calib(n):
    src = JSyntheticTokens(vocab=common.BENCH_CFG.vocab, seq_len=common.SEQ,
                           seed=0)
    return torch.from_numpy(np.array(
        JCalibrationSet.build(src, n).tokens)).long()


@pytest.fixture(scope="module")
def reference():
    """The reference's bench LM: its initial weights, and its weights and
    losses after ``STEPS`` Adam steps of ``common.get_trained_lm``'s jitted
    step on its first training batches (no cache written)."""
    from repro.core.context import QuantCtx as JQuantCtx
    from repro.optim.adam import AdamConfig, adam_init, adam_update
    model = common.build_model(common.BENCH_CFG)
    init = model.init(jax.random.key(0))
    cfg = AdamConfig(lr=3e-3, grad_clip=1.0)

    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(lambda p: model.loss(
            p, batch, JQuantCtx(mode="fp"))[0])(params)
        params, opt, _ = adam_update(grads, opt, params, cfg)
        return params, opt, loss

    src = JSyntheticTokens(vocab=common.BENCH_CFG.vocab, seq_len=common.SEQ,
                           seed=0)
    params, opt, losses = init, adam_init(init, cfg), []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, src.batch(i, common.BATCH))
        losses.append(float(loss))
    return model, init, params, losses


def test_config_matches_reference():
    assert dataclasses.asdict(bench_lm.BENCH_CFG) == dataclasses.asdict(
        common.BENCH_CFG)
    assert (bench_lm.SEQ, bench_lm.TRAIN_STEPS, bench_lm.BATCH) == (
        common.SEQ, common.TRAIN_STEPS, common.BATCH)


def test_eval_ppl_matches_reference(reference):
    jmodel, _, jparams, _ = reference
    model = bench_lm.build_model(bench_lm.BENCH_CFG)
    n = 2
    want = common.eval_ppl(jmodel, jparams, n_batches=n)
    got = bench_lm.eval_ppl(model, bridge.params(jparams, CPU),
                            batches=_ref_batches(99, range(50_000,
                                                           50_000 + n)))
    assert abs(got - want) <= 1e-5 * want, (got, want)


def test_five_adam_steps_match_reference(reference):
    _, jinit, jparams, jlosses = reference
    model = bench_lm.build_model(bench_lm.BENCH_CFG)
    params, losses = bench_lm.train(model, bridge.params(jinit, CPU),
                                    _ref_batches(0, range(STEPS)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for t, j in zip(tree_leaves(params),
                    tree_leaves(bridge.params(jparams, CPU))):
        d = (t.double() - j.double()).abs()
        assert float(d.max()) <= 3 * LR, float(d.max())
        assert int((d > LR / 300).sum()) <= max(1, d.numel() // 200), (
            int((d > LR / 300).sum()), d.numel(), float(d.max()))


def _qtensors(tree):
    if isinstance(tree, QTensor):
        return [tree]
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _qtensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [q for v in tree for q in _qtensors(v)]
    return []


def test_ptq_export_codes_match_reference(reference):
    jmodel, _, jparams, _ = reference
    model = bench_lm.build_model(bench_lm.BENCH_CFG)
    kw = dict(method="flexround", w_bits=4, a_bits=None,
              w_granularity="per_channel", iters=0, batch_size=16)
    n = 16
    jq, _, _ = common.ptq(jmodel, jparams, JQuantRecipe(**kw), n_calib=n,
                          as_qtensor=True)
    q, _, _ = bench_lm.ptq(model, bridge.params(jparams, CPU),
                           QuantRecipe(**kw), n, as_qtensor=True,
                           calib=_ref_calib(n))
    got, want = _qtensors(q), _qtensors(bridge.params(jq, CPU))
    assert len(got) == len(want) == 4 * 7
    for a, b in zip(got, want):
        assert (a.bits, a.packed, a.shape) == (b.bits, b.packed, b.shape)
        assert torch.equal(a.codes, b.codes)


def test_cache_round_trip(tmp_path):
    model, params = bench_lm.get_trained_lm(2, device=CPU,
                                            cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["bench_lm_2"]
    _, again = bench_lm.get_trained_lm(2, device=CPU,
                                       cache_dir=str(tmp_path))
    leaves, back = tree_leaves(params), tree_leaves(again)
    assert len(leaves) == len(back)
    assert all(torch.equal(a, b) for a, b in zip(leaves, back))
    assert math.isfinite(bench_lm.eval_ppl(model, again, 1))


# ------------------------------------------------------ the carried run
def carried_quality(iters: int = 200):
    """fp, FlexRound and RTN perplexity of the reference's trained bench LM
    in the reference and in the port (the port's recipe of
    ``examples/torch_ptq_pipeline.py``), on the reference's batches."""
    from repro_torch.core import quantize_blocks
    common.CACHE = os.path.join(ROOT, "build", "bench_cache", "reference")
    jmodel, jparams = common.get_trained_lm()
    model = bench_lm.build_model(bench_lm.BENCH_CFG)
    params = bridge.params(jparams, CPU)
    batches = _ref_batches(99, range(50_000, 50_008))
    calib = _ref_calib(64)
    out = {"reference fp": common.eval_ppl(jmodel, jparams),
           "port fp": bench_lm.eval_ppl(model, params, batches=batches)}
    recipe = QuantRecipe(method="flexround", setting="qdrop", w_bits=4,
                         w_granularity="per_channel", a_bits=8, iters=iters,
                         lr=3e-3, batch_size=16,
                         rules=("layers.0.*:w_bits=8",))
    x0, blocks, assemble = model.quant_blocks(params, calib)
    fin, ast, _ = quantize_blocks(blocks, recipe, x0)
    out["port flexround"] = bench_lm.eval_ppl(
        model, assemble(fin), astates=ast, recipe=recipe, batches=batches)
    rtn = QuantRecipe(method="rtn", setting="qdrop", w_bits=4,
                      w_granularity="per_channel", a_bits=8, iters=1,
                      batch_size=16)
    rq, ra, _ = bench_lm.ptq(model, params, rtn, calib=calib)
    out["port rtn"] = bench_lm.eval_ppl(model, rq, astates=ra, recipe=rtn,
                                        batches=batches)
    return out


if __name__ == "__main__":
    for k, v in carried_quality().items():
        print(f"{k:16s} {v:.3f}")

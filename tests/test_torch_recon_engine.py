"""The port's reconstruction engine (``repro_torch.core.reconstruct``): the
engine cache and its counters, the step body over static buffers, and what
that body reads from the device in place of the host (Adam's bias
corrections, AdaRound's β, QDrop's streams).

The cache tests mirror ``tests/test_recon_engine.py`` of the reference at
smoke sizes (blocks of two linears, width 24 and 40, float32). One
difference in the counts: the reference fetches its compiled teacher from
the engine too, so a chain of L blocks makes 2L - 1 hits; the port runs
the teacher eagerly and looks an engine up once per block, L - 1 hits.
Results through a shared engine, through a fresh one and through the
branching host code the body replaced are held bit for bit, with one
stated exception: AdaRound's regularizer after its warm-up, where the
exponent β is a device tensor and ``pow`` with a tensor exponent rounds
some elements one float32 unit apart from ``pow`` with a Python float
(which takes ``x * x`` at β = 2): relative 1e-6 on the value and on each
gradient element, a few units of float32 (2^-23 = 1.2e-7).

The ``requires_cuda`` cases skip here and hold, on a card, the replayed
graph against the same body run call by call (``graphs=False``), bit for
bit, and the captures against the distinct engine keys.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import adaround, qdrop
from repro_torch.core import reconstruct as rc
from repro_torch.core.context import QuantCtx
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.obs import compile_events
from repro_torch.optim import adam

torch.set_num_threads(2)

D, H, N = 24, 40, 32
QDROP = dict(method="flexround", w_bits=4, w_symmetric=False,
             w_granularity="per_channel", a_bits=8, setting="qdrop",
             drop_prob=0.5, iters=8, lr=3e-3, batch_size=8)


def make_block(seed, name, token=None, device="cpu"):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.standard_normal((D, H)) * D**-0.5,
              "w2": rng.standard_normal((H, D)) * H**-0.5}
    params = {k: torch.tensor(v, dtype=torch.float32, device=device)
              for k, v in params.items()}

    def apply(p, x, ctx, _n=name):
        z = F.gelu(ctx.linear(f"{_n}.w1", x, p["w1"]), approximate="tanh")
        return ctx.linear(f"{_n}.w2", z, p["w2"]) + x

    sites = {f"{name}.w1": rc.Site(("w1",)), f"{name}.w2": rc.Site(("w2",))}
    return rc.BlockHandle(name, params, apply, sites, apply_key=token)


def make_chain(n, token, device="cpu"):
    return [make_block(10 + i, f"layers.{i}", token, device)
            for i in range(n)]


def stream(seed=4, n=N, device="cpu"):
    x = np.random.default_rng(seed).standard_normal((n, D))
    return torch.tensor(x, dtype=torch.float32, device=device)


@pytest.fixture
def fresh():
    rc.clear_engine_cache()
    rc.reset_engine_stats()
    yield
    rc.clear_engine_cache()
    rc.reset_engine_stats()


def _flat(tree, prefix=""):
    """{path: tensor} over dicts, lists, QTensors and tensors."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}{i}.").items()}
    if hasattr(tree, "codes"):
        return {f"{prefix}{f}": getattr(tree, f).cpu()
                for f in ("codes", "scale", "zero")}
    return {prefix[:-1]: tree.detach().cpu()}


def assert_same_trees(x, y):
    fx, fy = _flat(x), _flat(y)
    assert sorted(fx) == sorted(fy)
    for k in fx:
        assert fx[k].dtype == fy[k].dtype and torch.equal(
            fx[k].reshape(-1).view(torch.uint8),
            fy[k].reshape(-1).view(torch.uint8)), k


def assert_same_reports(ra, rb):
    assert len(ra) == len(rb)
    for p, q in zip(ra, rb):
        assert (p.name, p.err_before, p.err_after) == (
            q.name, q.err_before, q.err_after)
        np.testing.assert_array_equal(p.loss_curve, q.loss_curve)
        np.testing.assert_array_equal(p.mse_curve, q.mse_curve)


def assert_same_run(a, b):
    """Two quantize_blocks results equal bit for bit: the exported codes,
    scales and zeros, the activation states, and every report's errors and
    curves."""
    assert_same_trees(a[0], b[0])
    assert_same_trees(a[1], b[1])
    assert_same_reports(a[2], b[2])


# ------------------------------------------------------------ engine cache
def test_one_engine_across_same_shape_blocks(fresh):
    """Four blocks sharing an ``apply_key`` build one engine and reuse it
    three times; on the CPU nothing is captured, and the teacher, student,
    recon_error and schedule counters stay 0 (they run eagerly)."""
    blocks = make_chain(4, token=(object(),))
    rc.quantize_blocks(blocks, QuantRecipe(**QDROP), stream())
    st = rc.engine_stats()
    assert st.engine_builds == 1
    assert st.engine_hits == len(blocks) - 1
    assert st.step_compiles == 0 and st.compile_count == 0, st


def test_engine_builds_flat_as_the_chain_grows(fresh):
    recipe = QuantRecipe(**dict(QDROP, iters=3))
    builds = {}
    for n in (2, 6):
        rc.clear_engine_cache()
        rc.reset_engine_stats()
        rc.quantize_blocks(make_chain(n, token=(object(),)), recipe, stream())
        st = rc.engine_stats()
        builds[n] = st.engine_builds
        assert st.engine_hits == n - 1
    assert builds[2] == builds[6] == 1, builds


@pytest.mark.parametrize("token,builds", [(None, 3), ("shared", 1)])
def test_apply_key_decides_what_shares(fresh, token, builds):
    """Without an ``apply_key`` each block's apply is its own engine; with
    one, the blocks share it. A different plan (W8 layer 0) needs an
    engine of its own."""
    rc.quantize_blocks(make_chain(3, token), QuantRecipe(**dict(QDROP, iters=2)),
                       stream())
    assert rc.engine_stats().engine_builds == builds
    rc.reset_engine_stats()
    mixed = QuantRecipe(**dict(QDROP, iters=2, rules=("layers.0.*:w_bits=8",)))
    rc.quantize_blocks(make_chain(3, "shared"), mixed, stream())
    assert rc.engine_stats().engine_builds == 2


def test_quant_blocks_stamps_one_token_per_call():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    _, a, _ = model.quant_blocks(params, tokens)
    _, b, _ = model.quant_blocks(params, tokens)
    assert len({blk.apply_key for blk in a}) == 1
    assert a[0].apply_key[1] == model.kind
    assert a[0].apply_key != b[0].apply_key


def test_quantize_blocks_leaves_no_engine_behind(fresh):
    """Engines built inside a quantize_blocks call do not outlive it; a
    direct reconstruct_block keeps its engine in the bounded LRU."""
    recipe = QuantRecipe(**dict(QDROP, iters=2))
    rc.quantize_blocks(make_chain(2, token=(object(),)), recipe, stream())
    assert len(rc._ENGINE_CACHE) == 0
    block = make_block(3, "layers.9")
    x = stream()
    y = block.apply(block.params, x, QuantCtx(mode="fp"))
    rc.reconstruct_block(block, recipe, x, y, 2)
    assert len(rc._ENGINE_CACHE) == 1


def test_engine_scope_evicts_what_it_built_and_keeps_the_rest(fresh):
    recipe = QuantRecipe(method="rtn", w_bits=8, a_bits=None, iters=1,
                         batch_size=4)
    x = stream(n=8)
    outer = make_block(0, "layers.0")
    y = outer.apply(outer.params, x, QuantCtx(mode="fp"))
    rc.reconstruct_block(outer, recipe, x, y, 2)
    before = list(rc._ENGINE_CACHE)
    with rc.engine_scope():
        inner = make_block(5, "layers.1", token=(object(),))
        rc.reconstruct_block(inner, recipe, x, y, 2)
        assert len(rc._ENGINE_CACHE) == 2
    assert list(rc._ENGINE_CACHE) == before


# ---------------------------------------------------- shared == fresh engine
CHAINS = {
    "flexround-qdrop": dict(QDROP),
    "adaround-brecq": dict(method="adaround", w_bits=4, a_bits=None,
                           setting="brecq", iters=10, batch_size=8),
    "adaquant-weighted": dict(method="adaquant", w_bits=4, a_bits=8,
                              iters=6, batch_size=8),
    "layer-wise": dict(QDROP, recon="layer", iters=5),
}


@pytest.mark.parametrize("tag", list(CHAINS))
def test_shared_engine_equals_a_fresh_engine_per_block(fresh, tag):
    """A chain through one shared engine equals the same chain with the
    cache cleared after every block (a fresh engine each time), bit for
    bit: load() leaves nothing of the previous block behind."""
    recipe = QuantRecipe(**CHAINS[tag])
    sw = (torch.from_numpy(np.random.default_rng(1).random(N).astype(
        np.float32)) if tag == "adaquant-weighted" else None)
    token = (object(),)
    shared = rc.quantize_blocks(make_chain(3, token), recipe, stream(), key=7,
                                sample_weight=sw)
    shared_builds = rc.engine_stats().engine_builds
    rc.reset_engine_stats()
    fresh_run = rc.quantize_blocks(
        make_chain(3, token), recipe, stream(), key=7, sample_weight=sw,
        progress=lambda _: rc.clear_engine_cache())
    sites = 2 if recipe.recon == "layer" else 1
    assert shared_builds == sites
    assert rc.engine_stats().engine_builds == 3 * sites
    assert_same_run(shared, fresh_run)


def test_chunk_changes_nothing_but_the_syncs(fresh):
    recipe = QuantRecipe(**QDROP)
    runs = [rc.quantize_blocks(make_chain(2, (object(),)), recipe, stream(),
                               chunk=c) for c in (1, 3, 100)]
    assert_same_run(runs[0], runs[1])
    assert_same_run(runs[0], runs[2])
    with pytest.raises(ValueError, match="chunk"):
        rc.quantize_blocks(make_chain(1, None), recipe, stream(), chunk=0)


def test_graphs_true_on_the_cpu_raises(fresh):
    with pytest.raises(ValueError, match="CUDA"):
        rc.quantize_blocks(make_chain(1, None), QuantRecipe(**QDROP),
                           stream(), graphs=True)
    assert rc.engine_stats().engine_builds == 0


def test_zero_iterations_build_no_engine(fresh):
    _, _, reps = rc.quantize_blocks(make_chain(2, (object(),)),
                                    QuantRecipe(**dict(QDROP, iters=0)),
                                    stream())
    assert rc.engine_stats().engine_builds == 0
    assert all(r.loss_curve.shape == (0,) and r.err_before == r.err_after
               for r in reps)


# ------------------------------------------------------- device-side tables
@pytest.mark.parametrize("cfg", [adam.AdamConfig(),
                                 adam.AdamConfig(b1=0.8, b2=0.95)])
def test_adam_tables_equal_the_host_corrections(cfg):
    steps = 500
    c1, c2 = adam.bias_correction_tables(cfg, steps, "cpu")
    assert c1.dtype == c2.dtype == torch.float32 and c1.shape == (steps,)
    want = np.asarray([adam._bias_corrections(cfg, t + 1)
                       for t in range(steps)], np.float32)
    np.testing.assert_array_equal(c1.numpy(), want[:, 0])
    np.testing.assert_array_equal(c2.numpy(), want[:, 1])


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_in_place_adam_equals_the_functional_form(moments):
    """adam_update_ with the tables' device scalars writes exactly what
    adam_update returns, step after step (per-leaf lr, weight decay and
    clipping included)."""
    cfg = adam.AdamConfig(lr=1e-2, weight_decay=0.01, grad_clip=1.0,
                          moment_dtype=moments)
    gen = torch.Generator().manual_seed(0)
    params = {"a": {"s2": torch.randn(5, 300, generator=gen)},
              "b": {"s1": torch.randn(1, 7, generator=gen),
                    "zero": torch.zeros(1, 7)}}
    lr = {"a": {"s2": 1.0}, "b": {"s1": 0.5, "zero": 0.5}}
    state = adam.adam_init(params, cfg)
    inplace = {k: {n: t.clone() for n, t in v.items()}
               for k, v in params.items()}
    mu = adam.adam_init(inplace, cfg)["mu"]
    c1, c2 = adam.bias_correction_tables(cfg, 6, "cpu")
    for t in range(6):
        grads = {k: {n: torch.randn(x.shape, generator=gen)
                     for n, x in v.items()} for k, v in params.items()}
        params, state, _ = adam.adam_update(grads, state, params, cfg,
                                            lr_scale=lr)
        adam.adam_update_(grads, mu, inplace, cfg, c1[t], c2[t], lr_scale=lr)
        for k in params:
            for n in params[k]:
                assert torch.equal(params[k][n], inplace[k][n]), (t, k, n)
    assert_same_trees(mu, state["mu"])


def test_adam_init_gives_each_moment_its_own_buffer():
    mu = adam.adam_init({"s": torch.ones(3)}, adam.AdamConfig())["mu"]
    assert mu["s"]["m"].data_ptr() != mu["s"]["v"].data_ptr()


RECIPE_ADA = QuantRecipe(method="adaround", iters=40, ada_warmup=0.2)


def test_adaround_tables_equal_beta():
    beta, warm = adaround.beta_tables(RECIPE_ADA, "cpu")
    assert beta.dtype == torch.float32 and warm.dtype == torch.bool
    for t in range(RECIPE_ADA.iters):
        b, w = adaround._beta(t, RECIPE_ADA)
        assert float(beta[t]) == b and bool(warm[t]) == w, t
    assert int(warm.sum()) == 8  # steps 0-7: the first 20% of 40
    assert adaround.beta_tables(RECIPE_ADA, "cpu")[0] is beta  # cached


def _branching_reg(state, step, recipe):
    """The host code the tables replaced: β from _beta(step) as a Python
    float, and zero with no graph in the warm-up."""
    beta, warmup = adaround._beta(step, recipe)
    if warmup:
        return torch.zeros((), dtype=torch.float32)
    h = adaround.rectified_sigmoid(state["v"])
    return recipe.ada_lambda * torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)


@pytest.mark.parametrize("step", [0, 6, 7, 8, 9, 20, 39])
def test_where_regularizer_equals_the_branching_one(step):
    """Across the warm-up boundary (steps 7 -> 8): in the warm-up both are
    0 with a zero gradient, bit for bit; after it, value and gradient
    within the module docstring's tolerance."""
    w = torch.randn(64, 96, generator=torch.Generator().manual_seed(3))
    qcfg = RECIPE_ADA.weight_qconfig()
    state = adaround.init(w, qcfg)
    res = []
    for fn in (lambda st: adaround.loss_extra(st, qcfg, torch.tensor([step]),
                                              RECIPE_ADA),
               lambda st: _branching_reg(st, step, RECIPE_ADA)):
        v = state["v"].clone().requires_grad_(True)
        reg = fn(dict(state, v=v))
        g = (torch.autograd.grad(reg, v)[0] if reg.requires_grad
             else torch.zeros_like(v))
        res.append((reg.detach(), g))
    (r1, g1), (r0, g0) = res
    assert r1.shape == r0.shape == ()
    if adaround._beta(step, RECIPE_ADA)[1]:
        assert float(r1) == float(r0) == 0.0
        assert torch.equal(g1, torch.zeros_like(g1)) and torch.equal(g0, g1)
    else:
        assert float(r1) > 0
        torch.testing.assert_close(r1, r0, rtol=1e-6, atol=0)
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------- QDrop
def _stream_masks(seed, names, shapes, iters, drop_prob):
    """Per step, each site's mask as fresh ``SiteStreams`` draw it."""
    streams = qdrop.SiteStreams(seed, "cpu")
    return [{n: (torch.rand(shapes[n], generator=streams(n)) < drop_prob)
             .numpy() for n in names} for _ in range(iters)]


def test_engine_streams_draw_what_fresh_site_streams_draw(fresh):
    """Two blocks through one engine (the second re-seeds its generators):
    each run equals the run fed, as a Schedule, the masks that fresh
    SiteStreams draw from the block's seed, step after step."""
    recipe = QuantRecipe(**QDROP)
    token = (object(),)
    for seed, block in zip((11, 12), make_chain(2, token)):
        x = stream(seed)
        y = block.apply(block.params, x, QuantCtx(mode="fp"))
        got = rc.reconstruct_block(block, recipe, x, y, seed)
        gen = torch.Generator().manual_seed(seed)
        idx = rc._batch_schedule(gen, recipe.iters, N, recipe.batch_size)
        names = sorted(block.sites)
        shapes = {names[0]: (recipe.batch_size, D),
                  names[1]: (recipe.batch_size, H)}
        masks = _stream_masks(seed, names, shapes, recipe.iters,
                              recipe.drop_prob)
        want = rc.reconstruct_block(
            block, recipe, x, y, seed,
            schedule=rc.Schedule(idx=idx.numpy(), masks=masks))
        assert_same_trees(got[:2], want[:2])  # rounding and LSQ states
        assert_same_reports([got[2]], [want[2]])
    assert rc.engine_stats().engine_builds == 1  # the mask runs hit it too


# ----------------------------------------------------------------- on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the graphed "
                    "reconstruction against graphs=False on the card")
    return "cuda"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tag", ["flexround-qdrop", "adaround-brecq"])
def test_graphed_step_equals_the_eager_step_on_a_card(fresh, tag):
    dev = _card()
    recipe = QuantRecipe(**CHAINS[tag])
    runs = {}
    for graphs in (False, None):
        compile_events.reset()
        rc.reset_engine_stats()
        runs[graphs] = rc.quantize_blocks(
            make_chain(3, (object(),), dev), recipe, stream(device=dev),
            key=7, graphs=graphs)
        st = rc.engine_stats()
        assert st.engine_builds == 1
        assert st.step_compiles == compile_events.captures() == (
            0 if graphs is False else 1)
        assert all(r.engine == ("eager" if graphs is False else "graph")
                   for r in runs[graphs][2])
    assert_same_run(runs[False], runs[None])


@pytest.mark.requires_cuda
def test_step_captures_equal_the_engine_keys_on_a_card(fresh):
    """A W8 layer 0 and a W4 body: two captures, flat from 2 to 6 blocks."""
    dev = _card()
    recipe = QuantRecipe(**dict(QDROP, iters=4,
                                rules=("layers.0.*:w_bits=8",)))
    for n in (2, 6):
        rc.reset_engine_stats()
        rc.quantize_blocks(make_chain(n, (object(),), dev), recipe,
                           stream(device=dev))
        st = rc.engine_stats()
        assert st.step_compiles == st.engine_builds == 2, (n, st)
        assert st.engine_hits == n - 2

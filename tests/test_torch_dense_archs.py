"""Port parity for the rest of the dense decoder and the vlm family:
granite-3-2b (muP multipliers, tied head), qwen2.5-14b (QKV biases, rope
theta 1e6), olmo-1b (non-parametric LayerNorm, MHA, no norm keys in the
tree) and phi-3-vision-4.2b (the vlm family: patch embeddings in front of
the tokens), each at the reference's ``reduced()`` config.

The reference initialises the weights (``jax.random.key(0)``); the norm
scales and QKV biases, which it initialises to zeros, get N(0, 0.1^2) noise
drawn with numpy, so that they change what both packages compute. The port
gets every array through the bridge. Tolerances:

- configs and reduced configs: field for field equal;
- forward hidden states and logits (float32): rtol=atol=1e-5 (reduction
  order);
- ``model.loss``: relative 1e-5; every gradient leaf against ``jax.grad``:
  max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7;
- phi-3's prefill with patch embeddings: hidden state rtol=atol=1e-5, the
  int8 KV codes within one step (a float32 value on a rounding boundary),
  their scales rtol=atol=1e-5;
- export at ``iters=0`` (W4 body, W8 layer 0, A8): codes, scale and zero of
  every QTensor bit-exact (they depend on the weights only), activation
  states relative 1e-5;
- greedy serving tokens of the two engines on the reference's export:
  identical;
- the launcher at ``--arch olmo-1b --smoke --device cpu``: the export-only
  run (A8, ``--serve``) exports the reference launcher's QTensors bit for
  bit and serves its tokens; the 2-step weight-only run's per-block
  reports agree to relative 1e-5 (full-batch, as ``test_torch_launch.py``).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.core.context import QuantCtx as JQuantCtx
from repro.core.quant_config import QuantRecipe as JQuantRecipe
from repro.core.reconstruct import quantize_blocks as jquantize_blocks
from repro.data import CalibrationSet as JCalibrationSet
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import quantize as jquantize
from repro.models import build_model as jbuild_model
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import scheduler as jscheduler
from repro_torch import bridge
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config, get_smoke_config, reduced
from repro_torch.core.context import QuantCtx
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quant_config import QuantRecipe
from repro_torch.core.reconstruct import quantize_blocks
from repro_torch.launch import quantize
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineConfig, ServeEngine

torch.set_num_threads(2)

CPU = "cpu"
ARCHS = ("granite-3-2b", "qwen2.5-14b", "olmo-1b", "phi-3-vision-4.2b")
RULES = ("layers.0.*:w_bits=8",)
RECIPE_KW = dict(method="flexround", w_bits=4, a_bits=8,
                 w_granularity="per_channel", iters=0, batch_size=4)
ENGINE_KW = dict(slots=3, max_len=32, prefill_group=2, kv_quant=True)
F32 = dict(rtol=1e-5, atol=1e-5)
NOISY = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")


def _np(t):
    return bridge.to_numpy(t)


def _perturb(jparams, seed):
    """N(0, 0.1^2) on the leaves the reference initialises to constants."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        keys = {getattr(k, "key", None) for k in path}
        if keys & set(NOISY):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, jparams)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = _perturb(jmodel.init(jax.random.key(0)), seed=7)
    params = bridge.params(jparams, CPU)
    calib = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    x0, blocks, assemble = jmodel.quant_blocks(jparams, jnp.asarray(calib))
    jrecipe = JQuantRecipe(rules=RULES, **RECIPE_KW)
    jfin, jast, _ = jquantize_blocks(blocks, jrecipe, x0)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, params=params, calib=calib, jrecipe=jrecipe,
                recipe=QuantRecipe(rules=RULES, **RECIPE_KW), jfin=jfin,
                jast=jast, jq=assemble(jfin))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _keys(tree):
    """The key structure of a parameter tree, layers as one layer's."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _keys(tree[0])
    return None


def _pairs(a, b, path=""):
    """(path, port leaf, reference leaf) over two trees of the same keys."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(jreduced(jcfg))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        jget_smoke_config(arch))


def test_param_tree_keys_and_shapes(lm):
    """The port's own init draws the reference's tree: the same keys (olmo
    has no ln1, ln2 or final_norm; qwen has bq/bk/bv) and shapes."""
    params = lm["model"].init(torch.Generator().manual_seed(0), device=CPU)
    jtree = jax.tree.map(lambda a: None, lm["jparams"])
    assert _keys(params) == _keys(jtree) == _keys(lm["params"])
    jshapes = jax.tree.map(lambda a: a.shape[1:], lm["jparams"]["layers"])
    for path, t, shp in _pairs(params["layers"][0], jshapes):
        assert tuple(t.shape) == tuple(shp), path
    cfg = lm["cfg"]
    assert ("ln1" in params["layers"][0]) == (cfg.norm != "layernorm_nonparam")
    assert ("bq" in params["layers"][0]["attn"]) == cfg.attn_bias


def test_forward_matches_reference(lm):
    toks = _tokens(lm["cfg"], (3, 12), seed=1)
    jx, _, _ = lm["jmodel"].backbone(lm["jparams"], jnp.asarray(toks),
                                     JQuantCtx(mode="fp"))
    x, _, _ = lm["model"].backbone(lm["params"], torch.from_numpy(toks),
                                   QuantCtx(mode="fp"))
    np.testing.assert_allclose(_np(x), np.asarray(jx), **F32)
    jlogits = (jx @ lm["jmodel"].lm_head(lm["jparams"])) * lm["cfg"].logit_mult
    np.testing.assert_allclose(_np(lm["model"].logits(lm["params"], x)),
                               np.asarray(jlogits), **F32)


def _loss_and_grads(lm, batch):
    """(reference loss, its gradient tree) and the port's, same inputs."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jctx = JQuantCtx(mode="fp")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: lm["jmodel"].loss(p, jbatch, jctx), has_aux=True)(
            lm["jparams"])
    params = bridge.params(lm["jparams"], CPU)
    leaves = [t for _, t, _ in _pairs(params, params)]
    for t in leaves:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, m = lm["model"].loss(params, tbatch, QuantCtx(mode="fp"))
    loss.backward()
    assert sorted(m) == sorted(jm)
    return jl, bridge.params(jg, CPU), loss, params


def _check_loss(jl, jg, loss, params):
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for path, t, g_ref in _pairs(params, jg):
        g, want = _np(t.grad), _np(g_ref)
        bound = 1e-5 * np.abs(want).max() + 1e-7
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(),
                                                 bound)


def test_loss_and_gradients_match_jax_grad(lm):
    """S = 40 is no multiple of the reduced xent_chunk (32): the padded
    remainder chunk runs; a random 0/1 mask."""
    cfg = lm["cfg"]
    rng = np.random.default_rng(2)
    batch = {"tokens": _tokens(cfg, (2, 40), seed=3),
             "labels": _tokens(cfg, (2, 40), seed=4),
             "mask": (rng.random((2, 40)) < 0.8).astype(np.float32)}
    jl, jg, loss, params = _loss_and_grads(lm, batch)
    _check_loss(jl, jg, loss, params)


@pytest.mark.parametrize("lm", ["phi-3-vision-4.2b"], indirect=True)
def test_vlm_loss_and_prefill_with_patch_embeds(lm):
    """phi-3-vision: ``n_patches`` embeddings in front of the tokens, the
    labels left-padded and the prefix masked in the loss; prefill fills the
    cache over prefix and tokens."""
    cfg = lm["cfg"]
    assert cfg.family == "vlm" and cfg.n_patches == 8
    rng = np.random.default_rng(5)
    pe = rng.normal(0, 1, (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    batch = {"tokens": _tokens(cfg, (2, 30), seed=6),
             "labels": _tokens(cfg, (2, 30), seed=7), "patch_embeds": pe}
    jl, jg, loss, params = _loss_and_grads(lm, batch)
    _check_loss(jl, jg, loss, params)
    batch["mask"] = (rng.random((2, 30)) < 0.7).astype(np.float32)
    _check_loss(*_loss_and_grads(lm, batch))

    toks = _tokens(cfg, (2, 12), seed=8)
    S = cfg.n_patches + 12
    jcache = lm["jmodel"].init_cache(2, S + 4, kv_quant=True)
    jlast, jcache = lm["jmodel"].prefill(lm["jparams"], jnp.asarray(toks),
                                         jcache, JQuantCtx(mode="fp"),
                                         extra_embeds=jnp.asarray(pe))
    cache = lm["model"].init_cache(2, S + 4, kv_quant=True, device=CPU)
    last, cache = lm["model"].prefill(lm["params"], torch.from_numpy(toks),
                                      cache, QuantCtx(mode="fp"),
                                      extra_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **F32)
    for nm in cache:
        got, want = _np(cache[nm]), np.asarray(jcache[nm], np.float32)
        if nm in ("k", "v"):
            assert np.abs(got - want).max() <= 1, nm
            assert not got[:, :, S:].any()
        else:
            np.testing.assert_allclose(got, want, **F32)


def _qtensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}{k}.")
    elif hasattr(tree, "pack_axis"):
        yield prefix[:-1], tree


def _same_qtensors(layers, jlayers, n_sites):
    routes = set()
    for tl, jl in zip(layers, jlayers, strict=True):
        q, jq = dict(_qtensors(tl)), dict(_qtensors(jl))
        assert sorted(q) == sorted(jq) and len(q) == n_sites
        for name, qt in q.items():
            j = jq[name]
            assert isinstance(qt, QTensor)
            assert (qt.shape, qt.bits, qt.packed, qt.dtype, qt.pack_axis) == (
                tuple(j.shape), j.bits, j.packed, j.dtype, j.pack_axis), name
            for fld in ("codes", "scale", "zero"):
                np.testing.assert_array_equal(
                    _np(getattr(qt, fld)), np.asarray(getattr(j, fld)),
                    err_msg=f"{name}.{fld}")
            routes.add((qt.bits, qt.packed))
    assert routes == {(8, False), (4, True)}


def _same_astates(ast, jast):
    assert sorted(ast) == sorted(jast)
    for site in ast:
        for k in ("step", "beta"):
            np.testing.assert_allclose(_np(ast[site][k]),
                                       np.asarray(jast[site][k]),
                                       rtol=1e-5, atol=1e-7, err_msg=site)


def test_export_is_bit_exact(lm):
    x0, blocks, assemble = lm["model"].quant_blocks(
        lm["params"], torch.from_numpy(lm["calib"]))
    fin, ast, reps = quantize_blocks(blocks, lm["recipe"], x0)
    _same_qtensors(fin, lm["jfin"], 7)
    _same_astates(ast, lm["jast"])
    q = assemble(fin)
    assert _keys(q) == _keys(bridge.params(lm["jq"], CPU))
    assert all(r.iters == 0 and np.isfinite(r.err_after) for r in reps)


def _serve(engine, requests):
    backlog, out = list(requests), {}
    while backlog or engine.active:
        n = min(engine.cfg.prefill_group, len(engine.free_slots()), len(backlog))
        if n:
            for rid, tok in engine.admit(backlog[:n]):
                out.setdefault(rid, []).append(tok)
            backlog = backlog[n:]
        if engine.active:
            for rid, tok in engine.step():
                out[rid].append(tok)
    engine.drain_finished()
    return out


def test_engines_emit_identical_greedy_tokens(lm):
    cfg = lm["cfg"]
    rng = np.random.default_rng(1)
    lens = [5, 9, 12, 7, 3, 20]  # buckets 8, 16 and 32; slot reuse
    requests = [(i, rng.integers(0, cfg.vocab, n).astype(np.int32), 6)
                for i, n in enumerate(lens)]
    jctx = JQuantCtx(mode="deploy", recipe=lm["jrecipe"], astates=lm["jast"],
                     backend="xla")
    jeng = JServeEngine(lm["jmodel"], lm["jq"], jctx, JEngineConfig(**ENGINE_KW))
    ctx = QuantCtx(mode="deploy", recipe=lm["recipe"],
                   astates=bridge.astates(lm["jast"], CPU))
    eng = ServeEngine(lm["model"], bridge.params(lm["jq"], CPU), ctx,
                      EngineConfig(**ENGINE_KW), device=CPU)
    want = _serve(jeng, requests)
    got = _serve(eng, requests)
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert eng.hbm_per_slot_bytes() == jeng.hbm_per_slot_bytes()


# ------------------------------------------------------------ the launcher
OLMO = ["--arch", "olmo-1b", "--smoke", "--calib", "8", "--seq", "16"]
LAUNCHES = {
    "export": OLMO + ["--w-bits", "4", "--a-bits", "8", "--rule",
                      "layers.0.*:w_bits=8", "--iters", "0", "--serve",
                      "--serve-requests", "5", "--serve-max-new", "6"],
    "train": OLMO + ["--w-bits", "4", "--iters", "2"],
}


def _reference_launch(argv, out):
    """The reference launcher under ``argv``: (tree, meta, reports, served
    tokens), the reports and tokens captured from the functions it calls."""
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
def olmo_launches(tmp_path_factory):
    d = tmp_path_factory.mktemp("olmo_launch")
    jcfg = jget_smoke_config("olmo-1b")
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    calib = np.asarray(JCalibrationSet.build(
        JSyntheticTokens(vocab=jcfg.vocab, seq_len=16, seed=0), 8).tokens)
    out = {}
    for tag, argv in LAUNCHES.items():
        jtree, jmeta, jreports, jserved = _reference_launch(
            argv, str(d / f"j_{tag}"))
        args = quantize.build_parser().parse_args(
            argv + ["--out", str(d / f"t_{tag}"), "--device", "cpu"])
        res = quantize.run(args, params=bridge.params(jparams, CPU),
                           calib_tokens=torch.from_numpy(calib.copy()))
        tree, meta = load_pytree(str(d / f"t_{tag}"), device=CPU)
        out[tag] = dict(jtree=jtree, jmeta=jmeta, jreports=jreports,
                        jserved=jserved, tree=tree, meta=meta, res=res)
    return out


def test_olmo_launcher_export_and_serve_match_the_reference(olmo_launches):
    r = olmo_launches["export"]
    jparams = bridge.params(r["jtree"]["params"], CPU)
    params = r["tree"]["params"]
    assert _keys(params) == _keys(jparams)
    assert "final_norm" not in params and "ln1" not in params["layers"][0]
    _same_qtensors(params["layers"], jparams["layers"], 7)
    _same_astates(r["tree"]["astates"], r["jtree"]["astates"])
    for k in ("arch", "method", "w_bits", "a_bits", "rules"):
        assert r["meta"][k] == r["jmeta"][k], k
    assert r["meta"]["arch"] == "olmo-1b-smoke"
    for rep, jrep in zip(r["res"].reports, r["jreports"], strict=True):
        assert rep.name == jrep.name
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-4)
    assert r["res"].serve["outputs"] == r["jserved"]
    assert sorted(r["jserved"]) == list(range(5))


def test_olmo_launcher_two_step_reports_match(olmo_launches):
    r = olmo_launches["train"]
    reps, jreps = r["res"].reports, r["jreports"]
    assert len(reps) == len(jreps) == 2
    for rep, jrep in zip(reps, jreps):
        assert rep.name == jrep.name and rep.iters == jrep.iters == 2
        for k in ("err_before", "err_after"):
            np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                       rtol=1e-5)
        np.testing.assert_allclose(rep.loss_curve, np.asarray(jrep.loss_curve),
                                   rtol=1e-5)


@pytest.mark.parametrize("change,item", [(dict(family="hybrid"), "item 9")])
def test_unported_pieces_raise_naming_their_roadmap_item(change, item):
    """The last piece that raised here, the hybrid family (ROADMAP Queue 1
    ``item``), is ported: ``build_model`` gives it ``GriffinLM``, nothing
    names the item any longer, and ``TransformerLM`` refuses the family
    as the other models refuse families not theirs."""
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), **change)
    model = build_model(cfg)
    assert type(model).__name__ == "GriffinLM" and model.cfg is cfg
    with pytest.raises(ValueError, match="takes the dense, moe and vlm") as ei:
        TransformerLM(cfg)
    assert item not in str(ei.value)


@pytest.mark.parametrize("family,cls", [("ssm", "MambaLM"),
                                        ("encdec", "EncDecLM"),
                                        ("hybrid", "GriffinLM")])
def test_ported_families_build_their_models(family, cls):
    """The ssm, encdec and hybrid families, which raised here before they
    were ported, build their own models; each refuses a config of another
    family."""
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), family=family)
    model = build_model(cfg)
    assert type(model).__name__ == cls and model.cfg is cfg
    with pytest.raises(ValueError, match=f"takes the {family} family"):
        type(model)(get_smoke_config("smollm-135m"))


MLA_DIMS = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16, head_dim=24)


@pytest.mark.parametrize("change", [MLA_DIMS, dict(first_dense=1),
                                    dict(mtp=True)],
                         ids=["use_mla", "first_dense", "mtp"])
def test_deepseek_pieces_on_a_dense_config_match_the_reference(change):
    """deepseek's three pieces, each alone on smollm's smoke config (they
    raised before deepseek-v3 was ported): MLA attention, ``first_dense``
    (ignored by a dense model, as in the reference) and the mtp head. The
    loss and its metrics (``mtp_ce`` with the head) equal the reference's
    on the same weights, relative 1e-5."""
    jcfg = dataclasses.replace(jget_smoke_config("smollm-135m"), **change)
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), **change)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = bridge.params(jparams, CPU)
    assert _keys(model.init(torch.Generator().manual_seed(0), device=CPU)
                 ) == _keys(params)
    assert "dense_layers" not in params
    batch = {"tokens": _tokens(cfg, (2, 20), seed=1),
             "labels": _tokens(cfg, (2, 20), seed=2)}
    jl, jm = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                         JQuantCtx(mode="fp"))
    loss, m = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                         QuantCtx(mode="fp"))
    assert sorted(m) == sorted(jm)
    assert ("mtp_ce" in m) == bool(change.get("mtp"))
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)

"""Port parity: the cell programs (``launch/steps.py``: ``CellProgram``,
``train_cell``, ``make_prefill_step``, ``make_serve_step``, ``serve_cell``,
``build_cell``) against the reference's.

Programs: every applicable (arch x shape) of the ten full-size configs,
weights bf16, int8 and int4, on the production 16 x 16 layout, and on
2 x 16 x 16 for smollm-135m and llama4-scout. The reference builds on a
``jax.sharding.AbstractMesh`` (no devices), the port on
``launch.mesh.AbstractMesh``. Equal: the name, ``donate_argnums``, the
argument trees (as ``test_torch_specs`` compares them: stacked reference
layers unstacked, every leaf on ``meta``) and the in/out specs
(``NamedSharding.spec`` as tuples; a QTensor leaf has one spec for each of
its codes, scale and zero). The train state's ``step`` and Adam ``count``
stay Python ints in the port, as ``make_train_step`` keeps them; they are
compared as int32 scalars.

Steps: on the ``reduced()`` configs (float32) of smollm, llama4-scout,
mamba2, whisper, phi-3-vision and recurrentgemma, the port's prefill step
then two decode steps on the CPU against the reference's steps under
``jax.jit``, with the same weights (the reference's init, and its QTensors
of uniform random codes, carried by ``repro_torch.bridge``), tokens and
frames or patch embeddings. The next tokens are equal. Caches agree to
float32 reduction order: every float entry within 1e-5 of the reference's
plus 1e-5 of its largest magnitude; int8 KV codes (each a rounding of a
float the two packages compute in another order) differ by at most 1, in
at most 0.5% of a leaf. One ``train_cell`` step equals the reference's
``make_train_step`` as ``test_torch_train`` holds three (loss and gradient
norm relative 1e-5; parameters as its ``_check_params``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.core.qtensor import QTensor as JQTensor
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.optim.adam import adam_init as jadam_init
from repro_torch import bridge
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, cell_applicable,
                                 get_config, get_smoke_config)
from repro_torch.core.qtensor import QTensor
from repro_torch.launch import sharding, specs, steps
from repro_torch.launch.mesh import AbstractMesh, mesh_layout
from repro_torch.models.model import build_model
from repro_torch.optim.adam import adam_init
from test_torch_specs import flat_port, flat_reference
from test_torch_train import _check_params

torch.set_num_threads(2)

_STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")


# ------------------------------------------------------------ spec trees
def flat_ref_specs(spec, like, path="", lead=0, out=None):
    """{path: spec tuple} of a reference sharding tree, its stacked layers
    unstacked along ``like`` (the port's argument tree: a list where the
    reference stacks); the dropped leading entries must be None."""
    out = {} if out is None else out
    if isinstance(spec, JQTensor):
        for f in ("codes", "scale", "zero"):
            flat_ref_specs(getattr(spec, f), None, f"{path}.{f}", lead, out)
    elif isinstance(spec, dict):
        for k, v in spec.items():
            sub = like[k] if isinstance(like, dict) else None
            if k in _STACKED and isinstance(v, dict) and isinstance(sub, list):
                for i, layer in enumerate(sub):
                    flat_ref_specs(v, layer, f"{path}.{k}.{i}", lead + 1, out)
            else:
                flat_ref_specs(v, sub, f"{path}.{k}", lead, out)
    elif isinstance(spec, (list, tuple)):
        for i, v in enumerate(spec):
            sub = like[i] if isinstance(like, (list, tuple)) else None
            flat_ref_specs(v, sub, f"{path}.{i}", lead, out)
    elif spec is None:
        out[path] = None
    else:
        t = tuple(spec.spec)
        assert t[:lead] == (None,) * lead, (path, t)
        out[path] = t[lead:]
    return out


def flat_port_specs(spec, path="", out=None):
    out = {} if out is None else out
    if isinstance(spec, QTensor):
        for f in ("codes", "scale", "zero"):
            flat_port_specs(getattr(spec, f), f"{path}.{f}", out)
    elif isinstance(spec, dict):
        for k, v in spec.items():
            flat_port_specs(v, f"{path}.{k}", out)
    elif isinstance(spec, list) or (isinstance(spec, tuple)
                                    and not sharding._is_spec(spec)):
        for i, v in enumerate(spec):
            flat_port_specs(v, f"{path}.{i}", out)
    else:
        assert spec is None or sharding._is_spec(spec), (path, spec)
        out[path] = spec
    return out


def _ints_as_scalars(tree):
    """The port's Python-int ``step``/``count`` as int32 scalar stand-ins."""
    if isinstance(tree, dict):
        return {k: _ints_as_scalars(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QTensor):
        return type(tree)(_ints_as_scalars(v) for v in tree)
    if isinstance(tree, int):
        return specs.sds((), torch.int32)
    return tree


_PARAMS = {}


def _cached_param_shapes(real):
    """``param_shapes`` once per (package, arch): each program of an arch
    starts from the same tree (a pure function of the config)."""
    def cached(model, cfg):
        key = (real.__module__, cfg.name)
        if key not in _PARAMS:
            _PARAMS[key] = real(model, cfg)
        return _PARAMS[key]
    return cached


@pytest.fixture(autouse=True)
def _cache_trees(monkeypatch):
    monkeypatch.setattr(jspecs, "param_shapes",
                        _cached_param_shapes(jspecs.param_shapes))
    monkeypatch.setattr(specs, "param_shapes",
                        _cached_param_shapes(specs.param_shapes))


def _cells(arch):
    cfg = get_config(arch)
    out = []
    for name, shape in SHAPES.items():
        if not cell_applicable(cfg, shape)[0]:
            continue
        for w in (("bf16",) if shape.kind == "train"
                  else ("bf16", "int8", "int4")):
            out.append((name, w))
    return out


def _check_program(prog, jprog):
    assert prog.name == jprog.name
    assert prog.donate_argnums == jprog.donate_argnums
    assert len(prog.args) == len(jprog.args)
    for a, ja in zip(prog.args, jprog.args):
        assert flat_port(_ints_as_scalars(a)) == flat_reference(ja)
    for sh, jsh in ((prog.in_shardings, jprog.in_shardings),
                    (prog.out_shardings, jprog.out_shardings)):
        assert len(sh) == len(jsh)
        for s, js, like in zip(sh, jsh, prog.args):
            assert flat_port_specs(s) == flat_ref_specs(js, like)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_programs_match_reference_on_the_production_mesh(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    layouts = [False] + ([True] if arch in ("smollm-135m",
                                            "llama4-scout-17b-a16e") else [])
    for pod in layouts:
        shape, names = mesh_layout("production", multi_pod=pod)
        mesh, jmesh = AbstractMesh(shape, names), JAbstractMesh(shape, names)
        for name, w in _cells(arch):
            prog = steps.build_cell(cfg, SHAPES[name], mesh, weights=w)
            jprog = jsteps.build_cell(jcfg, JSHAPES[name], jmesh, weights=w)
            _check_program(prog, jprog)


def test_int8_kv_program_matches_reference():
    cfg, jcfg = get_config("smollm-135m"), jget_config("smollm-135m")
    shape, names = mesh_layout("production")
    prog = steps.build_cell(cfg, SHAPES["decode_32k"], AbstractMesh(
        shape, names), weights="int4", kv="int8")
    jprog = jsteps.build_cell(jcfg, JSHAPES["decode_32k"], JAbstractMesh(
        shape, names), weights="int4", kv="int8")
    _check_program(prog, jprog)
    assert "k_scale" in prog.args[2]


# ------------------------------------------------------------ the steps
B, S, PROMPT = 2, 64, 32
ONE = ((1, 1), ("data", "model"))
STEP_CASES = [("smollm-135m", "bf16", "bf16"), ("smollm-135m", "int8", "bf16"),
              ("smollm-135m", "int4", "bf16"), ("smollm-135m", "int4", "int8"),
              ("llama4-scout-17b-a16e", "int4", "int8"),
              ("phi-3-vision-4.2b", "int8", "bf16"),
              ("whisper-medium", "int4", "bf16"),
              ("mamba2-130m", "int8", "bf16"),
              ("recurrentgemma-2b", "int4", "bf16")]


def _reference_weights(jparams, jcfg, weights, rng):
    """The reference's init, its quantizable sites as QTensors of uniform
    random codes (zero at the grid's middle, dequantized std K^-0.5)."""
    if weights == "bf16":
        return jparams
    bits = 8 if weights == "int8" else 4
    qshapes = jspecs.quantize_param_shapes(
        jax.eval_shape(lambda: jparams), jcfg, bits)

    def draw(q, w):
        if not isinstance(q, JQTensor):
            return w
        levels = 2 ** bits
        hi = 256 if q.packed else levels
        codes = rng.integers(0, hi, q.codes.shape).astype(np.uint8)
        scale = np.full(q.scale.shape, (12.0 / q.shape[-2]) ** 0.5 / levels,
                        np.float32)
        zero = np.full(q.zero.shape, float((levels - 1) // 2), np.float32)
        return JQTensor(codes=jnp.asarray(codes), scale=jnp.asarray(scale),
                        zero=jnp.asarray(zero), shape=q.shape, bits=q.bits,
                        packed=q.packed, dtype=q.dtype, pack_axis=q.pack_axis)

    return jax.tree.map(draw, qshapes, jparams,
                        is_leaf=lambda x: isinstance(x, JQTensor))


def _caches(jmodel, model, cfg, kv):
    """Zeroed caches of both packages, by ``specs.cache_shapes``' rule."""
    if cfg.family == "encdec":
        return (jmodel.init_cache(B, S, enc_len=specs.WHISPER_CROSS_LEN),
                model.init_cache(B, S, specs.WHISPER_CROSS_LEN, device="cpu"))
    quant = kv == "int8" and cfg.family in ("dense", "moe", "vlm") \
        and not cfg.use_mla
    return (jmodel.init_cache(B, S, kv_quant=quant),
            model.init_cache(B, S, kv_quant=quant, device="cpu"))


def _flat_np(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat_np(tree[k], f"{path}.{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_np(v, f"{path}.{i}"))
        return out
    return {path: bridge.to_numpy(tree) if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _check_caches(cache, jcache):
    got, want = _flat_np(cache), _flat_np(jcache)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).sum() <= max(1, d.size // 200), k
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(w).max()),
                err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("arch,weights,kv", STEP_CASES)
def test_steps_match_reference(arch, weights, kv):
    """Prefill then two decode steps: tokens equal, caches within the
    stated tolerance after each."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke_config(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    mesh, jmesh = AbstractMesh(*ONE), JAbstractMesh(*ONE)
    rng = np.random.default_rng(0)
    jparams = _reference_weights(jmodel.init(jax.random.key(0)), jcfg,
                                 weights, rng)
    params = bridge.params(jparams, "cpu")
    jcache, cache = _caches(jmodel, model, cfg, kv)

    pre = steps.build_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh,
                           weights, kv=kv)
    jpre = jsteps.build_cell(jcfg, JShapeSpec("p", S, B, "prefill"), jmesh,
                             weights, kv=kv)
    n_tok = PROMPT - (cfg.n_patches if cfg.family == "vlm" else 0)
    tokens = rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32)
    extra = []
    if cfg.family == "encdec":
        extra = [rng.normal(0, 1, (B, 48, cfg.d_model)).astype(np.float32)]
    elif cfg.family == "vlm":
        extra = [rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model)
                            ).astype(np.float32)]
    jtok, jcache = jax.jit(jpre.fn)(jparams, jnp.asarray(tokens), jcache,
                                    *map(jnp.asarray, extra))
    tok, cache = pre.fn(params, torch.from_numpy(tokens), cache,
                        *map(torch.from_numpy, extra))
    assert tok.dtype == torch.int32 and tok.shape == (B, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _check_caches(cache, jcache)

    dec = steps.build_cell(cfg, ShapeSpec("d", S, B, "decode"), mesh,
                           weights, kv=kv)
    jdec = jsteps.build_cell(jcfg, JShapeSpec("d", S, B, "decode"), jmesh,
                             weights, kv=kv)
    jstep = jax.jit(jdec.fn)
    for pos in (PROMPT, PROMPT + 1):
        jtok, jcache = jstep(jparams, jtok, jcache, jnp.int32(pos))
        tok, cache = dec.fn(params, tok, cache, pos)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        _check_caches(cache, jcache)


def test_train_cell_step_matches_reference():
    """One step of smollm's train cell (``TRAIN_OPT["dp"]``) against the
    reference's ``make_train_step`` under ``jax.jit`` (no donation)."""
    arch = "smollm-135m"
    cfg, jcfg = get_smoke_config(arch), jget_smoke_config(arch)
    jmodel = jbuild_model(jcfg)
    shape = ShapeSpec("t", 32, 4, "train")
    prog = steps.build_cell(cfg, shape, AbstractMesh(*ONE))
    assert prog.name == f"{cfg.name}:t" and prog.donate_argnums == (0,)
    opt = steps.TRAIN_OPT["dp"]
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jparams = jmodel.init(jax.random.key(0))
    jstate = {"params": jparams, "opt": jadam_init(jparams, opt),
              "step": jnp.int32(0)}
    jstate, jm = jax.jit(jsteps.make_train_step(jmodel, jcfg, opt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.params(jparams, "cpu")
    state = {"params": params, "opt": adam_init(params, opt), "step": 0}
    state, m = prog.fn(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert state["step"] == 1 and state["opt"]["count"] == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=1e-5)
    _check_params(state["params"], jstate["params"])

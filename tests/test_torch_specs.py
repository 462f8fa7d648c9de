"""Port parity: the shape stand-ins (``launch/specs.py``) against the
reference's ``jax.eval_shape`` trees.

For every architecture at full size and every shape: ``param_shapes``,
``quantize_param_shapes`` at 8 and 4 bits, ``batch_shapes`` and
``cache_shapes`` (bf16 and int8 KV) equal the reference's leaf by leaf —
path, shape and dtype, and every QTensor field — exactly. The port keeps
``layers`` (deepseek's ``dense_layers``, whisper's ``enc_layers`` and
``dec_layers``) as lists of per-layer dicts where the reference stacks
them, so a stacked reference leaf is compared as L leaves without its
leading L. No leaf holds storage (every one is on ``meta``), and
``cell_applicable`` gives the reference's answers and reasons.
``materialize`` draws real tensors of a stand-in tree.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs import cell_applicable as jcell_applicable
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro_torch.configs import (ARCH_IDS, SHAPE_IDS, ShapeSpec,
                                 cell_applicable, get_config, get_shape,
                                 reduced)
from repro_torch.core.qtensor import QTensor
from repro_torch.launch import specs
from repro_torch.models.model import build_model

torch.set_num_threads(2)

_STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")
_QT = ("bits", "packed", "dtype", "pack_axis")


def _is_jqt(x):
    return hasattr(x, "codes") and hasattr(x, "pack_axis")


def _n_stacked(tree):
    leaf = jax.tree.leaves(tree, is_leaf=_is_jqt)[0]
    return (leaf.codes if _is_jqt(leaf) else leaf).shape[0]


def flat_reference(tree, path="", lead=0):
    """{path: record} of a reference shape tree, stacked subtrees (a dict
    under a ``_STACKED`` key) unstacked into per-layer paths. A record is
    (shape, dtype name) or, for a QTensor, its fields."""
    out = {}
    if _is_jqt(tree):
        out[path] = (("codes",) + tuple(tree.codes.shape[lead:]),
                     str(tree.codes.dtype), tuple(tree.scale.shape[lead:]),
                     str(tree.scale.dtype), tuple(tree.zero.shape[lead:]),
                     str(tree.zero.dtype), tuple(tree.shape)) + tuple(
                         str(getattr(tree, f)) for f in _QT)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k in _STACKED and isinstance(v, dict):
                for i in range(_n_stacked(v)):
                    out.update(flat_reference(v, f"{path}.{k}.{i}", lead + 1))
            else:
                out.update(flat_reference(v, f"{path}.{k}", lead))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_reference(v, f"{path}.{i}", lead))
    elif tree is not None:
        out[path] = (tuple(tree.shape[lead:]), str(tree.dtype))
    return out


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def flat_port(tree, path=""):
    """The same records of a port stand-in tree; every tensor must be on
    ``meta``."""
    out = {}
    if isinstance(tree, QTensor):
        for t in (tree.codes, tree.scale, tree.zero):
            assert t.device.type == "meta", path
        out[path] = (("codes",) + tuple(tree.codes.shape), _dt(tree.codes),
                     tuple(tree.scale.shape), _dt(tree.scale),
                     tuple(tree.zero.shape), _dt(tree.zero),
                     tuple(tree.shape)) + tuple(str(getattr(tree, f))
                                                for f in _QT)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_port(v, f"{path}.{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_port(v, f"{path}.{i}"))
    elif tree is not None:
        assert isinstance(tree, torch.Tensor) and tree.device.type == "meta", \
            (path, type(tree))
        out[path] = (tuple(tree.shape), _dt(tree))
    return out


_TREES = {}


def _trees(arch):
    """(reference cfg, model, params; port cfg, model, params), once per
    arch."""
    if arch not in _TREES:
        jcfg, cfg = jget_config(arch), get_config(arch)
        jm, m = jbuild_model(jcfg), build_model(cfg)
        _TREES[arch] = (jcfg, jm, jspecs.param_shapes(jm, jcfg),
                        cfg, m, specs.param_shapes(m, cfg))
    return _TREES[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_match_reference(arch):
    """The fp tree and its 8- and 4-bit serving forms, field for field."""
    jcfg, _, jp, cfg, _, p = _trees(arch)
    assert flat_port(p) == flat_reference(jp)
    for bits in (8, 4):
        assert flat_port(specs.quantize_param_shapes(p, cfg, bits)) == \
            flat_reference(jspecs.quantize_param_shapes(jp, jcfg, bits)), bits


@pytest.mark.parametrize("shape", SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shapes_match_reference(arch, shape):
    jcfg, jm, _, cfg, m, _ = _trees(arch)
    js, s = jget_shape(shape), get_shape(shape)
    assert cell_applicable(cfg, s) == jcell_applicable(jcfg, js)
    assert flat_port(specs.batch_shapes(cfg, s)) == \
        flat_reference(jspecs.batch_shapes(jcfg, js))
    for kv in ("bf16", "int8"):
        assert flat_port(specs.cache_shapes(m, cfg, s, kv)) == \
            flat_reference(jspecs.cache_shapes(jm, jcfg, js, kv)), kv


def test_deepseek_param_shapes_allocate_nothing():
    """The 671B tree (1.3 TB of bf16) comes back as meta stand-ins in
    seconds: nothing is drawn or stored."""
    cfg = get_config("deepseek-v3-671b")
    t0 = time.perf_counter()
    p = specs.param_shapes(build_model(cfg), cfg)
    took = time.perf_counter() - t0
    leaves = list(flat_port(p).values())  # asserts every leaf is on meta
    n = sum(int(np.prod(s)) for s, _ in leaves)
    assert n == sum(int(np.prod(t.shape)) for t in jax.tree.leaves(
        _trees("deepseek-v3-671b")[2]))
    assert n > 6e11 and took < 60, (n, took)


def _at(tree, path):
    for k in path.strip(".").split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_materialize_draws_the_stand_ins():
    """Real tensors on the CPU: each QTensor's codes of its stand-in's
    shape and within its grid (both nibbles of packed 2-bit codes), the
    fill tree's own tensors everywhere else; an int8 cache drawn without
    -128 and with positive scales; a fill of another shape raises."""
    cfg = reduced(get_config("smollm-135m"))
    m = build_model(cfg)
    fp = m.init(torch.Generator().manual_seed(0), device="cpu")
    meta = specs.param_shapes(m, cfg)
    for bits in (8, 4, 2):
        q = specs.quantize_param_shapes(meta, cfg, bits)
        real = specs.materialize(q, torch.Generator().manual_seed(1), "cpu",
                                 fill=fp)
        n_q = 0
        for path, rec in flat_port(q).items():
            node = _at(real, path)
            if not isinstance(node, QTensor):
                assert node is _at(fp, path), path
                continue
            n_q += 1
            c = node.codes.int()
            assert node.codes.device.type == "cpu"
            assert ("codes",) + tuple(c.shape) == rec[0]
            assert node.scale.shape == _at(q, path).scale.shape
            top = int(((c & 15).max().maximum((c >> 4).max())) if node.packed
                      else c.max())
            assert top < 2 ** bits
        assert n_q == 7 * cfg.n_layers
    cache = specs.materialize(specs.cache_shapes(
        m, cfg, ShapeSpec("d", 64, 2, "decode"), "int8"), torch.Generator(),
        "cpu")
    assert cache["k"].dtype == torch.int8 and cache["k"].device.type == "cpu"
    assert int(cache["k"].min()) >= -127
    assert float(cache["k_scale"].min()) >= np.float32(0.01)
    with pytest.raises(ValueError, match="fill has"):
        specs.materialize({"embed": specs.sds((3, 4), torch.float32)},
                          torch.Generator(), "cpu",
                          fill={"embed": torch.zeros(4, 3)})

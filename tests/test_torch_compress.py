"""Port parity for the compressed gradient all-reduce:
``repro_torch.optim.compress`` against ``repro.optim.compress``.

- ``compress_tree``: every leaf's int8 codes and block scales bit-exact
  against the reference's (the same block absmax, the same round-half-even)
  on trees of float32 leaves whose sizes do and do not fill their last
  128-element block; ``decompress_tree`` exact against the reference's.
- ``compression_error``: relative 1e-6 (a ratio of two float32 norms).
- ``compressed_psum`` outside a process group: the identity reduce of the
  dequantized codes and the error-feedback residual, exact against the
  reference's function outside ``shard_map`` (its ``pmean`` over an axis of
  one device); over 2 spawned gloo ranks: the mean of the ranks'
  dequantized codes (float32 sum of two then halved: exact), twice in a
  row with the residual fed back.
"""

import numpy as np
import pytest
import torch

from repro_torch.optim import compress as tc
from test_torch_mesh import save_rank, spawn_ranks, start_rank

torch.set_num_threads(2)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 40)).astype(np.float32),
            "b": {"c": (rng.standard_normal((3, 7)) * 1e-3).astype(np.float32),
                  "d": rng.standard_normal((256,)).astype(np.float32)},
            "e": [rng.standard_normal((5,)).astype(np.float32) * 40.0,
                  np.zeros((130,), np.float32)]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _code_leaves(tree):
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return [(np.asarray(tree["q"]), np.asarray(tree["s"]))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _code_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _code_leaves(v)]
    raise TypeError(type(tree))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_tree_codes_bit_exact(seed):
    import jax.numpy as jnp

    from repro.optim import compress as jc
    tree = _tree(seed)
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": {k: jnp.asarray(v) for k, v in tree["b"].items()},
             "e": [jnp.asarray(v) for v in tree["e"]]}
    comp, jcomp = tc.compress_tree(_to_torch(tree)), jc.compress_tree(jtree)
    got, want = _code_leaves(comp), _code_leaves(jcomp)
    assert len(got) == len(want) == 5
    for (q, s), (jq, js) in zip(got, want):
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        assert q.dtype == np.int8
    back = tc.decompress_tree(comp, _to_torch(tree))
    jback = jc.decompress_tree(jcomp, jtree)
    for a, b in zip(_leaves(back), _leaves(jback)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_compression_error_matches_reference(seed):
    import jax.numpy as jnp

    from repro.optim import compress as jc
    for g in _leaves(_tree(seed)):
        np.testing.assert_allclose(tc.compression_error(torch.from_numpy(g)),
                                   jc.compression_error(jnp.asarray(g)),
                                   rtol=1e-6, atol=1e-12)
    assert tc.compression_error(torch.ones(300)) < 1e-6


def test_compressed_psum_outside_a_group_is_the_identity_reduce():
    import jax
    import jax.numpy as jnp

    from repro.optim import compress as jc
    tree = _tree(3)
    red, res = tc.compressed_psum(_to_torch(tree))
    red2, res2 = tc.compressed_psum(_to_torch(tree), residual=res)
    jtree = jax.tree.map(jnp.asarray, tree)

    def both(g, r):  # the reference inside shard_map over one device
        return jc.compressed_psum(g, "data", r)

    mesh = jax.make_mesh((1,), ("data",))
    smap = jc.get_shard_map()
    run = smap(both, mesh=mesh, in_specs=(jax.sharding.PartitionSpec(),) * 2,
               out_specs=(jax.sharding.PartitionSpec(),) * 2)
    jzero = jax.tree.map(jnp.zeros_like, jtree)
    jred, jres = run(jtree, jzero)
    jred2, jres2 = run(jtree, jres)
    for a, b in zip(_leaves(red) + _leaves(res) + _leaves(red2)
                    + _leaves(res2), _leaves(jred) + _leaves(jres)
                    + _leaves(jred2) + _leaves(jres2)):
        np.testing.assert_array_equal(a, np.asarray(b))


def psum_worker(out_dir):
    import torch.distributed as dist
    start_rank()
    r = dist.get_rank()
    tree = _to_torch(_tree(10 + r))
    red, res = tc.compressed_psum(tree)
    red2, res2 = tc.compressed_psum(tree, group=dist.group.WORLD,
                                    residual=res)
    save_rank(out_dir, {"red": red, "res": res, "red2": red2, "res2": res2})


def test_compressed_psum_over_two_ranks(tmp_path):
    """Each rank's (dequant(quant(g + residual))) averaged over the two
    ranks, the same on both; the residual is the rank's own."""
    got = spawn_ranks(2, "test_torch_compress", "psum_worker", tmp_path)
    zero = [torch.zeros(x.shape) for x in _leaves(_tree(0))]
    deq, res = [], []
    for r in range(2):
        g = [torch.from_numpy(x) for x in _leaves(_tree(10 + r))]
        d1 = [tc._dq8(*tc._q8(x + z), x.shape) for x, z in zip(g, zero)]
        r1 = [x - d for x, d in zip(g, d1)]
        d2 = [tc._dq8(*tc._q8(x + e), x.shape) for x, e in zip(g, r1)]
        r2 = [x + e - d for x, e, d in zip(g, r1, d2)]
        deq.append((d1, d2))
        res.append((r1, r2))
    for r in range(2):
        for key, i in (("red", 0), ("red2", 1)):
            for got_l, a, b in zip(_leaves(got[r][key]), deq[0][i],
                                   deq[1][i]):
                np.testing.assert_array_equal(got_l, ((a + b) / 2).numpy())
        for key, i in (("res", 0), ("res2", 1)):
            for got_l, want in zip(_leaves(got[r][key]), res[r][i]):
                np.testing.assert_array_equal(got_l, want.numpy())
    assert any(np.abs(x).max() > 0 for x in _leaves(got[0]["res"]))

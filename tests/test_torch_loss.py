"""Port parity for the chunked cross entropy
(``repro_torch.models.common.fused_cross_entropy``) against
``repro.models.common.fused_cross_entropy``, value and gradients.

The hidden states, head, labels and masks are drawn once with numpy and
fed to both. Cases: S a multiple of the chunk and not (the remainder folded
into one padded, masked chunk), a chunk longer than S, with and without a
mask (and a mask that zeroes a whole chunk), ``logit_scale`` 1 and 1/8
(granite's), an untied head (its own (D, V) matrix) and a tied one (the
transposed (V, D) embedding, whose gradient flows back to the embedding).
Tolerances (float32): the loss to relative 1e-5; each gradient to
max |g - g_ref| <= 1e-5 * max |g_ref| + 1e-7 (the sums over chunks and
over the vocabulary are ordered differently). The backward recomputes each
chunk (``torch.utils.checkpoint``): a test counts the recomputed chunk
forwards.

On a DTensor a remainder is its own shorter chunk, sliced and not padded
(DTensor's redistribution planner fails on the pad of a sharded tensor on
a CUDA mesh with torch 2.11): on a world of one (a gloo group of one rank,
the hidden rows and labels ``Shard(0)`` over its ``data`` axis) the loss
and both gradients are the plain padded path's within the tolerance
policy (relative 8e-6), and a plain input's loss and gradients are bit for
bit those of the padded code as it stood before the DTensor path
(``_padded``, kept here). ``common.pad``, which the other pads of the
train cells' paths go through (the vlm's labels and mask, mamba2's and
recurrentgemma's causal convs, the RG-LRU scan), pads a DTensor shard by
shard: on the world of one it equals ``F.pad`` bit for bit, with a zero
and a non-zero value, for a rows-sharded and a partial-sum input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.models import common

torch.set_num_threads(2)

B, D, V = 2, 16, 40


def _case(S, masked, tied, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    w = rng.normal(0, 0.3, (V, D) if tied else (D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) < 0.7).astype(np.float32) if masked
            else None)
    return x, w, labels, mask


def _reference(x, w, labels, mask, chunk, scale, tied):
    def f(x, w):
        w_out = w.T if tied else w
        return jcommon.fused_cross_entropy(
            x, w_out, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk, scale)
    val, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                           jnp.asarray(w))
    return float(val), np.asarray(gx), np.asarray(gw)


def _port(x, w, labels, mask, chunk, scale, tied):
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = common.fused_cross_entropy(
        tx, tw.T if tied else tw, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk, scale)
    loss.backward()
    return float(loss.detach()), tx.grad.numpy(), tw.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, r in zip(got[1:], want[1:]):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max() + 1e-7


@pytest.mark.parametrize("S,chunk", [(24, 8), (27, 8), (5, 8), (32, 32),
                                     (40, 32)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("scale", [1.0, 1.0 / 8.0])
def test_value_and_gradients_match_reference(S, chunk, masked, tied, scale):
    x, w, labels, mask = _case(S, masked, tied, seed=S + 100 * chunk)
    _close(_port(x, w, labels, mask, chunk, scale, tied),
           _reference(x, w, labels, mask, chunk, scale, tied))


def test_a_fully_masked_chunk_and_an_empty_mask():
    """A chunk whose mask is all zero adds nothing; a mask of zeros gives
    0 / max(0, 1) = 0, as in the reference."""
    x, w, labels, _ = _case(24, False, False, seed=3)
    mask = np.ones((B, 24), np.float32)
    mask[:, 8:16] = 0.0
    _close(_port(x, w, labels, mask, 8, 1.0, False),
           _reference(x, w, labels, mask, 8, 1.0, False))
    zero = np.zeros((B, 24), np.float32)
    got = _port(x, w, labels, zero, 8, 1.0, False)
    assert got[0] == 0.0 == _reference(x, w, labels, zero, 8, 1.0, False)[0]
    assert not got[1].any() and not got[2].any()


def test_each_chunk_is_recomputed_in_the_backward(monkeypatch):
    """27 positions in chunks of 8: 4 chunk forwards, and 4 more when the
    backward recomputes them (nothing of a chunk's logits is kept)."""
    calls = []
    real = common._chunk_loss

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(common, "_chunk_loss", counted)
    x, w, labels, mask = _case(27, True, False, seed=4)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = common.fused_cross_entropy(tx, torch.from_numpy(w),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(mask), 8)
    assert len(calls) == 4 and all(s == (B, 8, D) for s in calls)
    loss.backward()
    assert len(calls) == 8


def test_a_boolean_mask_counts_as_its_float_values():
    """The reference multiplies by whatever mask it gets; a boolean mask
    is its 0/1 floats (here with the padded remainder)."""
    x, w, labels, mask = _case(27, True, False, seed=5)
    got = _port(x, w, labels, mask.astype(bool), 8, 1.0, False)
    _close(got, _reference(x, w, labels, mask, 8, 1.0, False))


def _padded(x, w_out, labels, mask, chunk):
    """``fused_cross_entropy`` as it stood before the DTensor remainder
    path: every remainder padded to a whole chunk with mask 0."""
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint
    B_, S, _ = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk
    mask = (torch.ones((B_, S)) if mask is None else mask.float())
    if rem:
        pad = chunk - rem
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        n += 1
    tot, cnt = torch.zeros(()), torch.zeros(())
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        l, m = checkpoint(common._chunk_loss, x[:, sl], labels[:, sl].long(),
                          mask[:, sl], w_out, 1.0, use_reentrant=False)
        tot, cnt = tot + l, cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def _grads(fn, x, w, *rest):
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = fn(tx, tw, *rest)
    loss.backward()
    return loss.detach(), tx.grad, tw.grad


@pytest.mark.parametrize("S,chunk", [(27, 8), (24, 8), (5, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_path_bit_for_bit_the_padded_code(S, chunk, masked):
    x, w, labels, mask = _case(S, masked, False, seed=7 + S)
    m = None if mask is None else torch.from_numpy(mask)
    lb = torch.from_numpy(labels)
    got = _grads(lambda a, b: common.fused_cross_entropy(a, b, lb, m, chunk),
                 x, w)
    want = _grads(lambda a, b: _padded(a, b, lb, m, chunk), x, w)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("masked", [False, True])
def test_dtensor_remainder_is_sliced_and_matches_the_padded_path(
        masked, monkeypatch):
    """27 positions in chunks of 8 on a world of one: the DTensor path
    runs 4 chunks, the last 3 positions long, and matches the plain path
    (whose last chunk is 8 long, padded)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.analysis.trace import one_rank_mesh
    from repro_torch.launch.steps import _on_mesh
    x, w, labels, mask = _case(27, masked, False, seed=11)
    lb = torch.from_numpy(labels)
    m = None if mask is None else torch.from_numpy(mask)
    want = _grads(lambda a, b: common.fused_cross_entropy(a, b, lb, m, 8),
                  x, w)
    shapes = []
    real = common._chunk_loss
    monkeypatch.setattr(common, "_chunk_loss", lambda *a: shapes.append(
        tuple(a[0].shape)) or real(*a))
    mesh, started = one_rank_mesh("cpu")
    try:
        rows, rep = (Shard(0), Replicate()), (Replicate(), Replicate())

        def loss(a, b):  # a world of one: each local tensor is whole
            return common.fused_cross_entropy(
                DTensor.from_local(a, mesh, rows),
                DTensor.from_local(b, mesh, rep),
                DTensor.from_local(lb, mesh, rows),
                None if m is None else DTensor.from_local(m, mesh, rows),
                8).full_tensor()

        # the backward recomputes the chunks: it runs on the mesh too
        got = _on_mesh(lambda: _grads(loss, x, w), mesh)()
    finally:
        if started:
            dist.destroy_process_group()
    assert shapes[:4] == [(B, 8, D)] * 3 + [(B, 3, D)]
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=8e-6)
    for g, r in zip(got[1:], want[1:]):
        assert float((g - r).abs().max()) <= 8e-6 * float(r.abs().max())


@pytest.mark.parametrize("value", [0.0, 1.0])
def test_pad_pads_a_dtensor_shard_by_shard(value):
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.analysis.trace import one_rank_mesh
    from repro_torch.launch.steps import _on_mesh
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 7, 5)).astype(np.float32))
    want = F.pad(x, (0, 0, 3, 0), value=value)
    assert torch.equal(common.pad(x, (0, 0, 3, 0), value=value), want)
    mesh, started = one_rank_mesh("cpu")
    try:
        for pl in ((Shard(0), Replicate()), (Shard(1), Partial())):
            def run():
                d = DTensor.from_local(x, mesh, pl)
                return common.pad(d, (0, 0, 3, 0), value=value)

            got = _on_mesh(run, mesh)()
            assert tuple(got.shape) == (2, 10, 5)
            assert torch.equal(got.full_tensor(), want), pl
    finally:
        if started:
            dist.destroy_process_group()

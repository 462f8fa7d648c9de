"""The port's calibration data against ``repro.data``.

``SyntheticTokens`` draws from a CPU ``torch.Generator`` seeded from
``(seed, step, host)``, not from JAX's threefry, so its tokens are checked
against the closed form of the recurrence on its own draws; its argument
errors, the calibration set's chunking and the straggler policy are the
reference's exactly (``assemble_global_batch`` and ``build_sharded`` are
fed the reference's own shards).
"""
import numpy as np
import pytest
import torch

from repro.data import CalibrationSet as JCalibrationSet
from repro.data import StragglerPolicy as JStragglerPolicy
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.data import assemble_global_batch as jassemble
from repro_torch.data import (CalibrationSet, StragglerPolicy, SyntheticTokens,
                              assemble_global_batch)

torch.set_num_threads(2)


def test_batch_is_a_pure_function_of_step_and_host():
    src = SyntheticTokens(vocab=500, seq_len=12, seed=3)
    a = src.batch(7, 8, host=1, n_hosts=2)
    b = SyntheticTokens(vocab=500, seq_len=12, seed=3).batch(7, 8, host=1,
                                                             n_hosts=2)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 12) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    for other in (src.batch(8, 8, host=1, n_hosts=2),
                  src.batch(7, 8, host=0, n_hosts=2),
                  SyntheticTokens(vocab=500, seq_len=12, seed=4).batch(
                      7, 8, host=1, n_hosts=2)):
        assert not torch.equal(a["tokens"], other["tokens"])


@pytest.mark.parametrize("vocab,seq_len,n_modes", [(500, 12, 8), (49152, 64, 8),
                                                   (7, 40, 3)])
def test_tokens_follow_the_closed_form(vocab, seq_len, n_modes):
    """t_i = (t0 * a^i + b * i + sum_{j<=i} noise_j) mod V, evaluated with
    Python integers on the port's own draws (no wrap-around)."""
    src = SyntheticTokens(vocab=vocab, seq_len=seq_len, seed=1, n_modes=n_modes)
    out = src.batch(10_000, 6)
    a, b, t0, noise = (x.tolist() for x in src._draws(10_000, 6, 0))
    for r in range(6):
        assert 1 <= a[r][0] <= n_modes and set(noise[r]) <= {0, 1, 2}
        want = [(t0[r][0] * a[r][0] ** i + b[r][0] * i + sum(noise[r][:i + 1]))
                % vocab for i in range(seq_len + 1)]
        assert out["tokens"][r].tolist() == want[:-1]
        assert out["labels"][r].tolist() == want[1:]


@pytest.mark.parametrize("batch,host,n_hosts", [(8, 2, 2), (8, -1, 2),
                                                (8, 0, 0), (9, 0, 2)])
def test_argument_errors_match_the_reference(batch, host, n_hosts):
    with pytest.raises(ValueError) as want:
        JSyntheticTokens(64, 8).batch(0, batch, host=host, n_hosts=n_hosts)
    with pytest.raises(ValueError) as got:
        SyntheticTokens(64, 8).batch(0, batch, host=host, n_hosts=n_hosts)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 5, 8, 10])
def test_calibration_set_chunks_like_the_reference(n):
    """Steps 10,000 + i, ``max(1, n // 4)`` sequences each, cut to n."""
    src = SyntheticTokens(vocab=300, seq_len=6)
    per = max(1, n // 4)
    want = torch.cat([src.batch(10_000 + i, per)["tokens"]
                      for i in range(-(-n // per))])[:n]
    cal = CalibrationSet.build(src, n)
    assert torch.equal(cal.tokens, want) and len(cal) == n
    jcal = JCalibrationSet.build(JSyntheticTokens(vocab=300, seq_len=6), n)
    assert tuple(cal.tokens.shape) == tuple(jcal.tokens.shape)


def _shards(n_hosts, rows=3, seq=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 99, (rows, seq)).astype(np.int32),
             "labels": rng.integers(0, 99, (rows, seq)).astype(np.int32)}
            for _ in range(n_hosts)]


def _equal(got, want):
    batch, weight = got
    jbatch, jweight = want
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
        assert batch[k].numpy().dtype == np.asarray(jbatch[k]).dtype
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jweight))


@pytest.mark.parametrize("drop", [(), (2,), (0,)])
def test_assemble_global_batch_equals_the_reference(drop):
    shards = [None if h in drop else s for h, s in enumerate(_shards(4))]
    _equal(assemble_global_batch(shards, StragglerPolicy()),
           jassemble(shards, JStragglerPolicy()))


def _bad_keys():
    s = _shards(2)
    del s[1]["labels"]
    return s


def _bad_shape():
    s = _shards(2)
    s[1]["tokens"] = s[1]["tokens"][:2]
    return s


@pytest.mark.parametrize("shards,policy", [
    ([None, None], {}),
    ([None] + _shards(1), {}),
    (_shards(3)[:2] + [None], {"min_fraction": 0.9}),
    (_bad_keys(), {}),
    (_bad_shape(), {}),
], ids=["all_missing", "half_missing", "below_min_fraction", "keys", "shape"])
def test_assemble_global_batch_errors_match_the_reference(shards, policy):
    with pytest.raises(Exception) as want:
        jassemble(shards, JStragglerPolicy(**policy))
    with pytest.raises(Exception) as got:
        assemble_global_batch(shards, StragglerPolicy(**policy))
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


class _Reference:
    """A port-side source that hands out the reference's shards."""

    def __init__(self, jsrc):
        self.jsrc = jsrc

    def batch(self, step, batch_size, host=0, n_hosts=1):
        out = self.jsrc.batch(step, batch_size, host=host, n_hosts=n_hosts)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("drop", [(), (1,)])
def test_build_sharded_equals_the_reference_on_its_shards(drop):
    jsrc = JSyntheticTokens(vocab=211, seq_len=7, seed=5)
    jcal, jw = JCalibrationSet.build_sharded(jsrc, 8, 4, drop_hosts=drop)
    cal, w = CalibrationSet.build_sharded(_Reference(jsrc), 8, 4,
                                          drop_hosts=drop)
    np.testing.assert_array_equal(cal.tokens.numpy(), np.asarray(jcal.tokens))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert float(w.sum()) == 8 - 2 * len(drop)

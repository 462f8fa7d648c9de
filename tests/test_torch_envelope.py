"""Port parity for the shape envelopes (``repro_torch.kernels.envelope``, a
jax-free copy of ``repro.kernels.envelope``): the table equals the
reference's field for field, the checks raise where the reference's do,
and K3's planner reads its contraction bound from the w8a8 envelope."""
import dataclasses

import pytest

from repro.kernels import envelope as jenv
from repro_torch.kernels import envelope as env
from repro_torch.kernels import qmatmul_int8 as k3


def test_table_equals_reference_field_for_field():
    assert list(env.SHAPE_ENVELOPES) == list(jenv.SHAPE_ENVELOPES)
    for name, e in env.SHAPE_ENVELOPES.items():
        assert dataclasses.asdict(e) == dataclasses.asdict(
            jenv.SHAPE_ENVELOPES[name]), name
    assert [f.name for f in dataclasses.fields(env.ShapeEnvelope)] == [
        f.name for f in dataclasses.fields(jenv.ShapeEnvelope)]
    assert (env.INT32_MAX, env.INT16_MAX, env.F32_TINY) == (
        jenv.INT32_MAX, jenv.INT16_MAX, jenv.F32_TINY)


@pytest.mark.parametrize("layout", sorted(jenv.SHAPE_ENVELOPES))
def test_get_and_check_agree_with_reference(layout):
    e, je = env.get_envelope(layout), jenv.get_envelope(layout)
    for m, k, n, ex in ((1, 1, 1, 1), (e.m_max, e.k_max, e.n_max, e.e_max),
                        (e.m_max + 1, 1, 1, 1), (1, e.k_max + 1, 1, 1),
                        (1, 1, e.n_max + 1, 1), (1, 1, 1, e.e_max + 1),
                        (0, 1, 1, 1)):
        assert e.contains(m, k, n, ex) == je.contains(m, k, n, ex)
        if e.contains(m, k, n, ex):
            env.check_envelope(layout, m, k, n, ex)
        else:
            with pytest.raises(ValueError, match="leaves the verified envelope"):
                env.check_envelope(layout, m, k, n, ex)


def test_unknown_layout_and_grid_guard_raise():
    with pytest.raises(KeyError, match="no shape envelope"):
        env.get_envelope("w3_mystery")
    env.assert_grid_divisible("k", M=(256, 128), K=(512, 128))
    with pytest.raises(ValueError, match="padded dim K=500"):
        env.assert_grid_divisible("k", M=(256, 128), K=(500, 128))
    with pytest.raises(ValueError):
        env.assert_grid_divisible("k", N=(128, 0))


def test_k3_planner_reads_the_w8a8_envelope():
    assert k3.K_MAX == env.get_envelope("w8a8").k_max == jenv._K_MAX
    k3.plan(64, k3.K_MAX, 256)
    with pytest.raises(ValueError, match="envelope"):
        k3.plan(64, k3.K_MAX + 1, 256)

"""Port parity: the fused FlexRound quantize (K4) behind
``repro_torch.kernels.ops.flexround_fake_quant``.

The reference's ``kernels/ops.flexround_fake_quant`` runs the same inputs
through its XLA path (``backend="xla"``) and its Pallas kernel in interpret
mode; the port (its plain version on the CPU) must agree with both **bit for
bit**: every step is one float32 operation that both frameworks round to
nearest, the division is IEEE and the rounding half to even. The shapes are
``tests/test_kernels.py``'s ``SHAPES_MN`` plus a ragged (7, 200), in float32
and bfloat16, per tensor and per channel; inputs are drawn with numpy. The
CUDA kernel is held against the plain version on the card (``requires_cuda``
here, and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flexround as jfr
from repro.core.quant_config import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core import flexround
from repro_torch.core.quant_config import QuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flexround_quant import flexround_quant

torch.set_num_threads(2)

SHAPES_MN = [(8, 128), (64, 256), (100, 384), (256, 512), (7, 200)]
CPU = "cpu"


def _inputs(M, N, dtype, per_channel, seed=0):
    rng = np.random.default_rng([seed, M, N, per_channel])
    w = (rng.standard_normal((M, N)) * 0.1).astype(np.float32)
    s2 = np.exp(0.05 * rng.standard_normal((M, N))).astype(np.float32)
    if per_channel:
        s1 = (np.exp(rng.standard_normal((1, N)) * 0.1) * 0.01).astype(np.float32)
        zero = np.round(rng.uniform(0, 1, (1, N)) * 8).astype(np.float32)
    else:
        s1 = np.full((1, 1), 0.01, np.float32)
        zero = np.full((1, 1), 7.0, np.float32)
    s3 = np.exp(0.05 * rng.standard_normal((1, N))).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    state = {"s1": s1, "s2": s2, "s3": s3, "zero": zero}
    return jw, state


def _port_state(state, device=CPU):
    return {k: bridge.tensor(v, device) for k, v in state.items()}


_QCFG = (JQuantConfig(bits=4, observer="minmax"),
         QuantConfig(bits=4, observer="minmax"))


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES_MN, ids=[f"{m}x{n}" for m, n in SHAPES_MN])
def test_fake_quant_bit_exact_against_reference(shape, dtype, per_channel):
    jq, tq = _QCFG
    jw, state = _inputs(*shape, dtype, per_channel)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    want_xla = np.asarray(jops.flexround_fake_quant(jw, jstate, jq,
                                                    backend="xla"))
    want_pl = np.asarray(jops.flexround_fake_quant(jw, jstate, jq,
                                                   backend="pallas",
                                                   interpret=True))
    got = ops.flexround_fake_quant(bridge.tensor(np.asarray(jw), CPU),
                                   _port_state(state), tq)
    assert ops.last_kernel == "flexround_quant_ref"
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    got = bridge.to_numpy(got)
    np.testing.assert_array_equal(got, want_xla.astype(np.float32))
    np.testing.assert_array_equal(got, want_pl.astype(np.float32))


@pytest.mark.parametrize("scalar", ["0d", "1x1"])
def test_scalar_state_rows(scalar):
    """s1, s3 and zero of shape () or (1, 1), as ``core.flexround.init``
    gives them per tensor (``tests/test_deploy_parity.py:247``)."""
    jq = JQuantConfig(bits=4, symmetric=True, observer="minmax")
    tq = QuantConfig(bits=4, symmetric=True, observer="minmax")
    rng = np.random.default_rng(9)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    s2 = np.exp(0.05 * rng.standard_normal((16, 8))).astype(np.float32)
    mk = ((lambda v: np.float32(v)) if scalar == "0d"
          else (lambda v: np.full((1, 1), v, np.float32)))
    state = {"s1": mk(0.01), "zero": mk(0.0), "s2": s2, "s3": mk(1.0)}
    want = np.asarray(jops.flexround_fake_quant(
        jnp.asarray(w), {k: jnp.asarray(v) for k, v in state.items()}, jq,
        backend="xla"))
    for backend in ("auto", "torch"):
        got = ops.flexround_fake_quant(torch.from_numpy(w),
                                       _port_state(state), tq, backend=backend)
        np.testing.assert_array_equal(bridge.to_numpy(got), want)


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_matches_flexround_apply_with_perturbed_s2(granularity):
    """The kernel path's forward equals ``core.flexround.apply`` on a state
    from ``flexround.init`` with a perturbed s2 (``tests/test_kernels.py:44``),
    and the reference's ``apply`` on the same state."""
    jq = JQuantConfig(bits=4, symmetric=True, observer="minmax",
                      granularity=granularity)
    tq = QuantConfig(bits=4, symmetric=True, observer="minmax",
                     granularity=granularity)
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 128)) * 0.2).astype(np.float32)
    st = flexround.init(torch.from_numpy(w), tq)
    st["s2"] = torch.from_numpy(
        np.exp(0.03 * rng.standard_normal(w.shape)).astype(np.float32))
    got = ops.flexround_fake_quant(torch.from_numpy(w), st, tq)
    want = flexround.apply(torch.from_numpy(w), st, tq)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfr.apply(jnp.asarray(w), jst, jq)))


def test_cpu_tensors_take_the_plain_version_without_counting():
    jw, state = _inputs(8, 128, jnp.float32, True)
    st = _port_state(state)
    before = flexround_quant.launches
    out = flexround_quant(bridge.tensor(np.asarray(jw), CPU), st["s1"],
                          st["s2"], st["s3"], st["zero"], qmin=0, qmax=15)
    assert out.shape == (8, 128) and flexround_quant.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flexround_fake_quant(bridge.tensor(np.asarray(jw), CPU), st,
                                 _QCFG[1], backend="kernel")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 200), (576, 1536)],
                         ids=["7x200", "576x1536"])
def test_cuda_kernel_bit_exact_against_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this kernel on "
                    "the card")
    jw, state = _inputs(*shape, dtype, True)
    w = bridge.tensor(np.asarray(jw), "cuda")
    st = _port_state(state, "cuda")
    before = flexround_quant.launches
    got = ops.flexround_fake_quant(w, st, _QCFG[1])
    torch.cuda.synchronize()
    assert ops.last_kernel == "flexround_quant"
    assert flexround_quant.launches == before + 1
    want = ops.flexround_fake_quant(w, st, _QCFG[1], backend="torch")
    assert torch.equal(got, want)

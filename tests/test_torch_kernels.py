"""Port parity: ``repro_torch.kernels.ops.qtensor_matmul`` against the
reference dispatcher, for every 2-D kernel-table layout.

On the CPU the port runs the plain versions of its kernels; they are held
against ``repro.kernels.ops.qtensor_matmul(backend="xla")`` over the
reference's whole differential shape lattice
(``analysis/diffcheck.py:shape_lattice``), and against the interpreted
Pallas kernels (``backend="pallas"``) on three shapes per layout. Inputs
(QTensor, activations, activation grid) are carried across the bridge.

Inputs are drawn with numpy from a seed per shape: integer codes straight
on the grid (nibble-packed along K for even-K 4-bit), per-channel scale and
zero point, activations, and the activation grid the reference's
``lsq.init``/``deploy_astate`` derive from the activation range. The
reference runs jitted, as it serves.

Tolerances: the W8A8 path is bit-exact (integer accumulation, the same
elementwise epilogue); the float paths use rtol=atol=1e-5, which covers a
float32 contraction of up to ~1000 terms summed in another order. The CUDA
kernels themselves are compared on the card by ``chip_smoke.py``; the one
card-only test here checks the kernel names ``last_kernel`` records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.diffcheck import EXPECTED_KERNELS, shape_lattice
from repro.core import lsq as jlsq
from repro.core.qtensor import QTensor as JQTensor
from repro.core.quant_config import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.kernels import ops

torch.set_num_threads(2)

LAYOUTS = ("w4_packed", "w4a8_packed", "w8a8", "w8_weight_only",
           "w4_odd_unpacked")
# layout -> (weight bits, with activation grid)
_LAYOUT = {"w4_packed": (4, False), "w4a8_packed": (4, True),
           "w8a8": (8, True), "w8_weight_only": (8, False),
           "w4_odd_unpacked": (4, False)}
CASES = [(layout, shape) for layout in LAYOUTS
         for shape in shape_lattice(layout)]
_AQ = JQuantConfig(bits=8, symmetric=False, granularity="per_tensor",
                   observer="minmax")
_ref_jit = jax.jit(lambda x, qt, a: jops.qtensor_matmul(x, qt, a_state=a,
                                                         backend="xla"))


def _example(layout, m, k, n, seed=0):
    """(x, reference QTensor, activation grid or None) for one cell."""
    bits, with_a = _LAYOUT[layout]
    rng = np.random.default_rng([seed, m, k, n, bits])
    q = rng.integers(0, 2**bits, size=(k, n)).astype(np.uint8)
    packed = bits == 4 and k % 2 == 0
    codes = (q[0::2] | (q[1::2] << 4)).astype(np.uint8) if packed else q
    # grid steps that span weights of about +-0.1, as the reference's
    # lattice exemplars (N(0, 0.1) weights) have
    scale = (np.exp(rng.standard_normal((1, n)) * 0.2) * 0.2
             / (2**bits - 1)).astype(np.float32)
    zero = np.round(rng.uniform(0, 2**bits - 1, (1, n))).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qt = JQTensor(codes=jnp.asarray(codes), scale=jnp.asarray(scale),
                  zero=jnp.asarray(zero), shape=(k, n), bits=bits,
                  packed=packed, dtype="float32", pack_axis=0)
    a_state = None
    if with_a:
        st = jlsq.init(jnp.asarray([x.min(), x.max()], jnp.float32), _AQ)
        a_state = jlsq.deploy_astate(st, _AQ)
    return jnp.asarray(x), qt, a_state


def _port_inputs(x, qt, a_state, device="cpu"):
    return (bridge.tensor(x, device), bridge.qtensor(qt, device),
            None if a_state is None
            else tuple(bridge.tensor(v, device) for v in a_state))


def _port_matmul(x, qt, a_state, backend, device="cpu"):
    xt, qtt, at = _port_inputs(x, qt, a_state, device)
    return ops.qtensor_matmul(xt, qtt, a_state=at, backend=backend)


def _check(layout, got, want):
    got = bridge.to_numpy(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype
    if layout == "w8a8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout,shape", CASES,
                         ids=[f"{l}-e{e}m{m}k{k}n{n}" for l, (e, m, k, n) in CASES])
def test_plain_versions_match_reference_xla(layout, shape):
    _, m, k, n = shape
    x, qt, a_state = _example(layout, m, k, n)
    want = _ref_jit(x, qt, a_state)
    got = _port_matmul(x, qt, a_state, "auto")
    _check(layout, got, want)
    assert ops.last_kernel == EXPECTED_KERNELS[layout][0]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_match_reference_pallas_interpret(layout):
    for _, m, k, n in shape_lattice(layout)[:3]:
        x, qt, a_state = _example(layout, m, k, n)
        want = jops.qtensor_matmul(x, qt, a_state=a_state, backend="pallas",
                                   interpret=True)
        _check(layout, _port_matmul(x, qt, a_state, "torch"), want)


def test_snapped_activation_codes_bit_exact():
    """The deploy grid's integer codes (the W8A8 kernel's input) agree bit
    for bit, including the clip at both ends of [0, 255]."""
    x, qt, a_state = _example("w8a8", 33, 48, 24)
    x = x * 1.5  # push part of the activations past the grid
    want = np.asarray(jops._lsq_int8_codes(x, *a_state))
    xt, _, at = _port_inputs(x, qt, a_state)
    got = ops._lsq_int8_codes(xt, *at)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -128 and got.max() == 127


def test_kernel_backend_refuses_cpu_tensors():
    """No CPU fallback hides behind the kernel backend."""
    x, qt, a_state = _example("w4_packed", 5, 16, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _port_matmul(x, qt, a_state, "kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.resolve_backend("xla", torch.device("cpu"))


def test_batched_experts_not_ported():
    x, qt, _ = _example("w4_packed", 5, 16, 8)
    qt = JQTensor(codes=qt.codes[None], scale=qt.scale[None],
                  zero=qt.zero[None], shape=(1, 16, 8), bits=4, packed=True,
                  dtype="float32", pack_axis=1)
    with pytest.raises(NotImplementedError, match="K5"):
        _port_matmul(x[None], qt, None, "auto")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_kernels_match_plain_versions(layout):
    """On a card: each layout launches the kernel the reference's table
    names, and agrees with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these kernels "
                    "on the card")
    _, m, k, n = shape_lattice(layout)[-1]
    x, qt, a_state = _example(layout, m, k, n)
    before = ops.launch_counts()
    got = _port_matmul(x, qt, a_state, "kernel", device="cuda")
    torch.cuda.synchronize()
    assert ops.last_kernel == EXPECTED_KERNELS[layout][1]
    assert ops.launch_counts()[ops.last_kernel] == before[ops.last_kernel] + 1
    want = _port_matmul(x, qt, a_state, "torch", device="cuda")
    np.testing.assert_allclose(bridge.to_numpy(got), bridge.to_numpy(want),
                               rtol=1e-5, atol=1e-5)

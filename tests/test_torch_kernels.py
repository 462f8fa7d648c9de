"""Port parity: ``repro_torch.kernels.ops.qtensor_matmul`` against the
reference dispatcher, for every kernel-table layout: the five 2-D ones and
the stacked-expert one (``experts_batched``, the reference's K5).

On the CPU the port runs the plain versions of its kernels; they are held
against ``repro.kernels.ops.qtensor_matmul(backend="xla")`` over the
reference's whole differential shape lattice
(``analysis/diffcheck.py:shape_lattice``), and against the interpreted
Pallas kernels (``backend="pallas"``) on three shapes per layout. Inputs
(QTensor, activations, activation grid) are carried across the bridge.

Inputs are drawn with numpy from a seed per shape: integer codes straight
on the grid (nibble-packed along K for even-K 4-bit; for stacked experts
(E, K/2, N) packed along axis 1), per-channel scale and
zero point, activations, and the activation grid the reference's
``lsq.init``/``deploy_astate`` derive from the activation range. The
reference runs jitted, as it serves.

Tolerances: the W8A8 path is bit-exact (integer accumulation, the same
elementwise epilogue); the float paths use rtol=atol=1e-5, which covers a
float32 contraction of up to ~1000 terms summed in another order. The CUDA
kernels themselves are compared on the card by ``chip_smoke.py``; the one
card-only tests here check the kernel names ``last_kernel`` records.
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
           "w4_odd_unpacked", "experts_batched")
# layout -> (weight bits, with activation grid)
_LAYOUT = {"w4_packed": (4, False), "w4a8_packed": (4, True),
           "w8a8": (8, True), "w8_weight_only": (8, False),
           "w4_odd_unpacked": (4, False), "experts_batched": (4, False)}
CASES = [(layout, shape) for layout in LAYOUTS
         for shape in shape_lattice(layout)]
_AQ = JQuantConfig(bits=8, symmetric=False, granularity="per_tensor",
                   observer="minmax")
_ref_jit = jax.jit(lambda x, qt, a: jops.qtensor_matmul(x, qt, a_state=a,
                                                         backend="xla"))


def _example(layout, m, k, n, seed=0, e=None):
    """(x, reference QTensor, activation grid or None) for one cell; with
    ``e`` experts the weight is stacked (e, k, n) and x is (e, m, k)."""
    bits, with_a = _LAYOUT[layout]
    lead = () if e is None else (e,)
    ax = len(lead)  # the contraction axis K
    rng = np.random.default_rng([seed, m, k, n, bits] + list(lead))
    q = rng.integers(0, 2**bits, size=lead + (k, n)).astype(np.uint8)
    packed = bits == 4 and k % 2 == 0
    codes = ((q.take(range(0, k, 2), ax) | (q.take(range(1, k, 2), ax) << 4))
             .astype(np.uint8) if packed else q)
    # grid steps that span weights of about +-0.1, as the reference's
    # lattice exemplars (N(0, 0.1) weights) have
    scale = (np.exp(rng.standard_normal(lead + (1, n)) * 0.2) * 0.2
             / (2**bits - 1)).astype(np.float32)
    zero = np.round(rng.uniform(0, 2**bits - 1, lead + (1, n))).astype(np.float32)
    x = rng.standard_normal(lead + (m, k)).astype(np.float32)
    qt = JQTensor(codes=jnp.asarray(codes), scale=jnp.asarray(scale),
                  zero=jnp.asarray(zero), shape=lead + (k, n), bits=bits,
                  packed=packed, dtype="float32", pack_axis=ax)
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


def _lattice_example(layout, e, m, k, n):
    return _example(layout, m, k, n,
                    e=e if layout == "experts_batched" else None)


@pytest.mark.parametrize("layout,shape", CASES,
                         ids=[f"{l}-e{e}m{m}k{k}n{n}" for l, (e, m, k, n) in CASES])
def test_plain_versions_match_reference_xla(layout, shape):
    x, qt, a_state = _lattice_example(layout, *shape)
    want = _ref_jit(x, qt, a_state)
    got = _port_matmul(x, qt, a_state, "auto")
    _check(layout, got, want)
    assert ops.last_kernel == EXPECTED_KERNELS[layout][0]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_match_reference_pallas_interpret(layout):
    for shape in shape_lattice(layout)[:3]:
        x, qt, a_state = _lattice_example(layout, *shape)
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


def test_recentred_codes_equal_the_int32_form():
    """W8A8's weight codes u in [0, 255] become int8 u - 128 in one byte-wide
    pass (u ^ 0x80); over all 256 codes that is the int32 form it replaced,
    (u - 128) cast to int8."""
    u = torch.arange(256, dtype=torch.uint8)
    got = ops.recentre_codes(u)
    assert got.dtype == torch.int8
    assert torch.equal(got, (u.to(torch.int32) - 128).to(torch.int8))


@pytest.mark.parametrize("m,k,n", [(5, 256, 16), (33, 48, 24)])
def test_w8a8_over_every_code_matches_reference(m, k, n):
    """qtensor_matmul on the w8a8 layout with weight codes that take all 256
    values matches the reference dispatcher bit for bit."""
    x, qt, a_state = _example("w8a8", m, k, n)
    codes = (np.arange(k * n) * 97 % 256).astype(np.uint8).reshape(k, n)
    assert len(np.unique(codes)) == 256
    qt = JQTensor(codes=jnp.asarray(codes), scale=qt.scale, zero=qt.zero,
                  shape=qt.shape, bits=8, packed=False, dtype="float32",
                  pack_axis=0)
    want = _ref_jit(x, qt, a_state)
    _check("w8a8", _port_matmul(x, qt, a_state, "auto"), want)
    assert ops.last_kernel == "qmatmul_int8_ref"


def test_kernel_backend_refuses_cpu_tensors():
    """No CPU fallback hides behind the kernel backend."""
    x, qt, a_state = _example("w4_packed", 5, 16, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _port_matmul(x, qt, a_state, "kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.resolve_backend("xla", torch.device("cpu"))


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_batched_experts_token_axes_move_as_reference(lead):
    """x (..., E, n, K) against stacked experts: leading token axes fold
    into each expert's rows and back, unpacked 8-bit codes take the same
    kernel, and more than one batch dim dequantizes (the reference's
    fallback)."""
    x, qt, _ = _example("experts_batched", 3, 16, 8, e=4)
    x = jnp.broadcast_to(x, lead + x.shape) * (1 + jnp.arange(
        int(np.prod(lead)), dtype=jnp.float32).reshape(lead + (1, 1, 1)))
    want = _ref_jit(x, qt, None)
    _check("experts_batched", _port_matmul(x, qt, None, "torch"), want)
    assert ops.last_kernel == "dequant_matmul_batched_ref"
    w8 = JQTensor(codes=qt.unpacked_codes(), scale=qt.scale, zero=qt.zero,
                  shape=qt.shape, bits=8, packed=False, dtype="float32",
                  pack_axis=1)
    _check("experts_batched", _port_matmul(x, w8, None, "auto"),
           _ref_jit(x, w8, None))
    assert ops.last_kernel == "dequant_matmul_batched_ref"
    qt2 = JQTensor(codes=qt.codes[None], scale=qt.scale[None],
                   zero=qt.zero[None], shape=(1,) + qt.shape, bits=4,
                   packed=True, dtype="float32", pack_axis=2)
    x2 = x.reshape(lead + (1,) + x.shape[len(lead):])
    _check("experts_batched", _port_matmul(x2, qt2, None, "auto"),
           _ref_jit(x2, qt2, None))
    assert ops.last_kernel == ops.FALLBACK


def test_launch_counters_list_every_kernel():
    counts = ops.launch_counts()
    assert set(counts) == {
        "dequant_matmul_w4", "dequant_matmul_w8", "qmatmul_int8",
        "flexround_quant", "dequant_matmul_batched",
        "dequant_matmul_w4[decode]", "dequant_matmul_w4[mma]",
        "dequant_matmul_w4[fp32]", "dequant_matmul_w8[decode]",
        "dequant_matmul_w8[mma]", "dequant_matmul_w8[fp32]",
        "dequant_matmul_batched[packed]", "dequant_matmul_batched[unpacked]",
        "dequant_matmul_batched[decode]", "dequant_matmul_batched[mma]",
        "dequant_matmul_batched[fp32]"}
    ops.reset_launch_counts()
    assert not any(ops.launch_counts().values())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cuda_kernels_match_plain_versions(layout):
    """On a card: each layout launches the kernel the reference's table
    names, and agrees with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these kernels "
                    "on the card")
    x, qt, a_state = _lattice_example(layout, *shape_lattice(layout)[-1])
    before = ops.launch_counts()
    got = _port_matmul(x, qt, a_state, "kernel", device="cuda")
    torch.cuda.synchronize()
    assert ops.last_kernel == EXPECTED_KERNELS[layout][1]
    assert ops.launch_counts()[ops.last_kernel] == before[ops.last_kernel] + 1
    want = _port_matmul(x, qt, a_state, "torch", device="cuda")
    np.testing.assert_allclose(bridge.to_numpy(got), bridge.to_numpy(want),
                               rtol=1e-5, atol=1e-5)


K5_CARD = [(regime, rows) for regime in ("decode", "mma", "fp32")
           for rows in ("dense", "routed", "partial", "zero")]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("regime,rows", K5_CARD,
                         ids=[f"{r}-{x}" for r, x in K5_CARD])
def test_cuda_batched_experts_regimes_and_skip(regime, rows):
    """On a card: K5 in each regime (bf16 M = 4, bf16 M = 40, float32 x)
    on x whose experts are dense, routed (two experts hold a token, the
    rest zero), zero over part of K, or all zero; it launches once in the
    planned regime, agrees with its plain version, and every expert whose
    rows are all zero gives exactly +0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these kernels "
                    "on the card")
    from repro_torch.kernels import dequant_matmul_w4 as k12
    from repro_torch.kernels import ref
    E, M, K, N = 6, (40 if regime == "mma" else 4), 578, 200
    dtype = torch.float32 if regime == "fp32" else torch.bfloat16
    rng = np.random.default_rng([E, M, K, N])
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    if rows == "routed":
        x[[0, 2, 3, 5]] = 0.0
        x[[1, 4], 1:] = 0.0
    elif rows == "partial":
        x[1, :, :K // 2] = 0.0
        x[2] = -0.0
    elif rows == "zero":
        x[:] = 0.0
    codes = rng.integers(0, 256, (E, K // 2, N)).astype(np.uint8)
    scale = (rng.uniform(0.5, 1.5, (E, 1, N)) * 0.01).astype(np.float32)
    zero = np.round(rng.uniform(0, 15, (E, 1, N))).astype(np.float32)
    xt, ct, st, zt = (torch.from_numpy(a).cuda() for a in (x, codes, scale,
                                                             zero))
    xt = xt.to(dtype)
    forms = dict(k12.dequant_matmul_batched.forms)
    got = k12.dequant_matmul_batched(xt, ct, st, zt, True)
    want = ref.dequant_matmul_batched_ref(xt, ct, st, zt, True)
    torch.cuda.synchronize()
    took = sorted(f for f in forms
                  if k12.dequant_matmul_batched.forms[f] != forms[f])
    assert took == sorted([regime, "packed"])
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    empty = ~(xt != 0).flatten(1).any(1)
    out = got[empty].float().cpu().numpy()
    assert (out == 0).all() and not np.signbit(out).any()


K3_CARD = [(7, 577, 200), (130, 577, 200), (130, 4097, 200), (512, 5120, 1024),
           (64, 32768, 256)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,K,N", K3_CARD,
                         ids=[f"m{M}k{K}n{N}" for M, K, N in K3_CARD])
def test_cuda_qmatmul_int8_ragged_and_split(M, K, N):
    """On a card: K3 at ragged shapes (one and two row tiles), with K split
    (the last block of a tile adds the int32 partial sums), and at the
    envelope's edge (K = 32768, every code -128, acc = 2^29): the int32
    accumulator equals the float64 product exactly, and the epilogue
    agrees with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these kernels "
                    "on the card")
    from repro_torch.kernels import qmatmul_int8 as k3
    from repro_torch.kernels import ref
    rng = np.random.default_rng([M, K, N])
    if K == k3.K_MAX:
        a = np.full((M, K), -128, np.int8)
        b = np.full((K, N), -128, np.int8)
    else:
        a = rng.integers(-128, 128, (M, K)).astype(np.int8)
        b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    a_q, b_q = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    assert (k3.plan(M, K, N).splits > 1) == (K >= 4097)
    ones, nil = torch.ones((1, N), device="cuda"), torch.zeros((1, N),
                                                               device="cuda")
    before = k3.qmatmul_int8.launches
    acc = k3.qmatmul_int8(a_q, b_q, 1.0, 0.0, ones, nil)
    torch.cuda.synchronize()
    assert k3.qmatmul_int8.launches == before + 1
    exact = torch.matmul(a_q.double(), b_q.double()).float()
    assert torch.equal(acc, exact)
    b_s = torch.from_numpy((np.exp(rng.standard_normal((1, N)) * 0.2) * 0.2
                            / 255).astype(np.float32)).cuda()
    b_z = torch.from_numpy((np.round(rng.uniform(0, 255, (1, N))) - 128
                            ).astype(np.float32)).cuda()
    a_s, a_z = 0.021, -121.0
    got = k3.qmatmul_int8(a_q, b_q, a_s, a_z, b_s, b_z)
    want = ref.qmatmul_int8_ref(a_q, b_q, torch.tensor(a_s, device="cuda"),
                                torch.tensor(a_z, device="cuda"), b_s, b_z)
    # the kernel's epilogue associates as the Pallas kernel, the plain
    # version as ref.py: each rounds ~5 times at the size of its largest
    # term (the bound chip_smoke.py states)
    terms = (exact.double().abs()
             + (a_z * b_q.double().sum(0, keepdim=True)).abs()
             + (a_q.double().sum(1, keepdim=True) * b_z.double()).abs()
             + (K * a_z * b_z.double()).abs())
    tol = 16 * 2.0**-24 * (a_s * b_s.double()).abs() * terms
    assert bool(((got.double() - want.double()).abs() <= tol).all())

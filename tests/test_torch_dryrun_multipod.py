"""The dry run's family matrix on the multi-pod debug mesh (2, 2, 2) of
pod x data x model: the (2, 4) half and the measurements are in
``test_torch_dryrun.py``, which this file mirrors (a file of its own so
that ``--dist loadfile`` spreads the matrix). Each reduced() cell traces
on a ``"fake"`` group of 8 ranks with a fresh ``DeviceMesh`` (a mesh
flattens ``("pod", "data")`` once per trace and keeps the flattened mesh,
made under that trace's fake mode), and its record has flops, a memory
peak and a collective breakdown. The train cells' gradients of the
replicated parameters are reduced over pod and data in one all-reduce
each."""
import pytest

from repro_torch.launch import dryrun
from test_torch_dryrun import ARCHS, KINDS, check_record, record


@pytest.fixture
def world():
    with dryrun.fake_world(8):
        yield


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_matrix_multi_pod(world, arch, kind):
    check_record(record(arch, kind, multi_pod=True))


def test_dp_gradients_reduced_once_over_pod_and_data(world):
    """mamba2's dp train cell on (2, 2, 2): one all-reduce per parameter,
    as on (2, 4), with the same bytes (the gradients' float32 bytes)."""
    multi = record("mamba2-130m", "train", multi_pod=True, mode="dp")
    single = record("mamba2-130m", "train", mode="dp")
    assert multi["collectives"]["all-reduce"] == \
        single["collectives"]["all-reduce"]
    assert multi["analysis"]["collective_breakdown"]["all-reduce"] == \
        single["analysis"]["collective_breakdown"]["all-reduce"]

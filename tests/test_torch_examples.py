"""The port's stand-alone examples, run as a user runs them
(``PYTHONPATH=src python examples/torch_*.py --device cpu``), beside live
runs of the reference.

- ``torch_quickstart.py --iters 4``: exits 0 and prints one row per method
  the reference registers (``repro.core.method_api.available_methods()``
  in a fresh process, the port's the same list), each error finite and
  positive.
- ``torch_train_small.py --steps 52 --simulate-failure-at 50``, then again
  without the failure: the first run stops after step 50 with the
  reference's crash line, the second prints ``resumed from step 50`` and
  ends with checkpoints of steps 50 and 52, as
  ``examples/train_small.py`` run the same way does. Both print their
  losses at the same steps; the data are the same ``SyntheticTokens``
  batches and only the initial weights differ (each package draws its
  own), so each loss is within 2% of the reference's (measured: 0.8% at
  step 0, under 0.1% from step 25).
- Neither example imports ``jax`` or ``repro`` (``test_torch_no_jax.py``).
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(script, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        script), *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


_METHODS = r"""
from repro.core import method_api as jmethods
from repro_torch.core import method_api
print(" ".join(jmethods.available_methods()))
print(" ".join(method_api.available_methods()))
"""


def test_quickstart_prints_every_registered_method():
    """The registries are read in a fresh process, as the example's: tests
    elsewhere register toy methods in this one."""
    out = run("torch_quickstart.py", "--device", "cpu", "--iters", "4")
    rows = [line.split() for line in out.splitlines()
            if re.match(r"^\w+\s+\S+e[-+]\d+\s+\S+e[-+]\d+$", line)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref, port = subprocess.run(
        [sys.executable, "-c", _METHODS], env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout.splitlines()
    methods = ref.split()
    assert port.split() == methods
    assert [r[0] for r in rows] == methods
    for _, before, after in rows:
        assert 0 < float(before) < float("inf")
        assert 0 < float(after) < float("inf")
    assert out.splitlines()[0].startswith("block: layers.0, sites: ")


def _losses(out):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+)\s+loss ([0-9.]+)$", out, re.M)}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """{package: (first run's output, rerun's output, checkpoint dir)}."""
    out = {}
    for name, script, extra in (
            ("port", "torch_train_small.py", ("--device", "cpu")),
            ("reference", "train_small.py", ())):
        ckpt = str(tmp_path_factory.mktemp(name) / "ckpt")
        first = run(script, "--steps", "52", "--simulate-failure-at", "50",
                    "--ckpt", ckpt, *extra)
        again = run(script, "--steps", "52", "--ckpt", ckpt, *extra)
        out[name] = (first, again, ckpt)
    return out


def test_train_small_crashes_and_resumes_as_the_reference(train_runs):
    for name in ("port", "reference"):
        first, again, ckpt = train_runs[name]
        assert "simulated crash" in first.splitlines()[-1], name
        assert "resumed from step 50" in again, name
        assert again.splitlines()[-1].startswith("done; checkpoints in")
        assert sorted(os.listdir(ckpt)) == ["step_0000000050",
                                            "step_0000000052"], name


def test_train_small_losses_beside_the_reference(train_runs):
    port = [_losses(o) for o in train_runs["port"][:2]]
    ref = [_losses(o) for o in train_runs["reference"][:2]]
    assert [sorted(p) for p in port] == [sorted(r) for r in ref] == [
        [0, 25, 50], [50, 51]]
    for p, r in zip(port, ref):
        for step in p:
            assert abs(p[step] - r[step]) <= 0.02 * r[step], (step, p, r)
    # the resumed run starts where the first one stood at step 50
    assert port[1][50] == port[0][50]

"""What the benchmark loads: nothing whose whole top-level module name is
``jax``, ``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` is not
``repro``), and the reference nothing of ``repro_torch`` either. Each
check runs in a fresh interpreter, so modules other tests loaded do not
count."""
import json
import subprocess
import sys

from bench.env import ROOT

CHECK = """
import json, sys
sys.path.insert(0, {root!r})
from bench import env
env.prepare()
{imports}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def loaded(imports: str):
    code = CHECK.format(root=str(ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    tops = loaded("import bench.run, bench.control, bench.drivers.ptq, "
                  "bench.drivers.serve, bench.compare.ptq, bench.compare.serve\n"
                  "import repro_torch.core.reconstruct, repro_torch.serve.engine")
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


def test_reference_loads_nothing_of_the_port():
    tops = loaded("import bench.reference.dense, bench.reference.quant, "
                  "bench.weights, bench.flops, bench.peaks, bench.trace, "
                  "bench.stats")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_modules_compares_whole_names():
    from bench import env
    assert "repro" not in env.forbidden_modules() or "repro" in {
        m.split(".", 1)[0] for m in sys.modules}


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                          "olmo-1b.ptq.w4a8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not out.stdout.strip()

"""The port stands alone: importing ``repro_torch`` and every submodule pulls
in neither ``jax`` nor the reference package, and the default device is
CUDA, which raises when no card is visible (no silent CPU fallback)."""
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device

torch.set_num_threads(2)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for m in mods:
    importlib.import_module(m)
print(len(mods), 'jax' in sys.modules, 'repro' in sys.modules,
      any(k.startswith(('jax.', 'repro.')) for k in sys.modules))
print(' '.join(mods))
"""

NEW_MODULES = ("repro_torch.models.moe", "repro_torch.kernels.flexround_quant",
               "repro_torch.configs.llama4_scout_17b_a16e",
               "repro_torch.core.rtn", "repro_torch.core.adaround",
               "repro_torch.core.adaquant", "repro_torch.core.qdrop",
               "repro_torch.optim", "repro_torch.optim.adam",
               "repro_torch.obs", "repro_torch.obs.telemetry",
               "repro_torch.obs.sink", "repro_torch.obs.serve_metrics",
               "repro_torch.serve.scheduler", "repro_torch.data",
               "repro_torch.data.pipeline", "repro_torch.checkpoint",
               "repro_torch.checkpoint.checkpoint", "repro_torch.launch",
               "repro_torch.launch.quantize", "repro_torch.obs.profiler",
               "repro_torch.obs.compile_events")


def test_import_pulls_in_no_jax_and_no_reference():
    lines = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                           text=True, timeout=120,
                           check=True).stdout.splitlines()
    out = lines[0].split()
    assert int(out[0]) >= 28
    assert out[1:] == ["False", "False", "False"]
    assert set(NEW_MODULES) <= set(lines[1].split())


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_default_to_cuda(monkeypatch):
    _check_defaults_to_cuda(monkeypatch, "smollm-135m")


def test_moe_entry_points_default_to_cuda(monkeypatch):
    _check_defaults_to_cuda(monkeypatch, "llama4-scout-17b-a16e")


def _check_defaults_to_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8, kv_quant=True)
    from repro_torch.launch import quantize
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize.main(["--arch", arch, "--smoke", "--iters", "0"])


def test_unported_architectures_raise():
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="not ported yet, see ROADMAP"):
        get_config("qwen2.5-14b")

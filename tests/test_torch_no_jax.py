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
               "repro_torch.obs.compile_events", "repro_torch.kernels.envelope",
               "repro_torch.configs.granite_3_2b",
               "repro_torch.configs.qwen2_5_14b", "repro_torch.configs.olmo_1b",
               "repro_torch.configs.phi3_vision_4_2b",
               "repro_torch.models.mla",
               "repro_torch.configs.deepseek_v3_671b",
               "repro_torch.models.encdec", "repro_torch.models.ssm",
               "repro_torch.configs.whisper_medium",
               "repro_torch.configs.mamba2_130m", "repro_torch.models.rglru",
               "repro_torch.configs.recurrentgemma_2b",
               "repro_torch.configs.shapes", "repro_torch.launch.sharding",
               "repro_torch.launch.steps", "repro_torch.launch.train",
               "repro_torch.launch.mesh", "repro_torch.optim.compress",
               "repro_torch.analysis", "repro_torch.analysis.report",
               "repro_torch.analysis.layouts", "repro_torch.analysis.coverage",
               "repro_torch.analysis.diffcheck",
               "repro_torch.analysis.ast_rules",
               "repro_torch.analysis.allowlist", "repro_torch.analysis.lint")


def test_import_pulls_in_no_jax_and_no_reference():
    lines = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                           text=True, timeout=120,
                           check=True).stdout.splitlines()
    out = lines[0].split()
    assert int(out[0]) >= 30
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


def test_deepseek_entry_points_default_to_cuda(monkeypatch):
    _check_defaults_to_cuda(monkeypatch, "deepseek-v3-671b")


def test_mamba2_entry_points_default_to_cuda(monkeypatch):
    """mamba2's init, init_cache and launcher default to the card (its
    int8 cache is refused, so the cache is asked for in float32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config("mamba2-130m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    from repro_torch.launch import quantize
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize.main(["--arch", "mamba2-130m", "--smoke", "--iters", "0"])


def test_whisper_entry_points_default_to_cuda(monkeypatch):
    """whisper's init and int8 self and cross caches default to the card;
    its entry points are the library's (the launcher refuses the
    family before any work)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config("whisper-medium"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8, 16, kv_quant=True)


def _check_defaults_to_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8, kv_quant=not model.cfg.use_mla)
    from repro_torch.launch import quantize
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize.main(["--arch", arch, "--smoke", "--iters", "0"])


def test_unported_architectures_raise():
    """Every architecture of the reference is ported: the ten configs, in
    the reference's order, each building its family's model; an unknown
    name raises ``KeyError`` listing them."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.model import build_model
    assert ARCH_IDS == ("qwen2.5-14b", "smollm-135m", "granite-3-2b",
                        "olmo-1b", "recurrentgemma-2b",
                        "llama4-scout-17b-a16e", "deepseek-v3-671b",
                        "mamba2-130m", "whisper-medium", "phi-3-vision-4.2b")
    families = {get_config(a).family for a in ARCH_IDS}
    assert families == {"dense", "moe", "hybrid", "ssm", "encdec", "vlm"}
    for arch in ARCH_IDS:
        assert build_model(get_config(arch)).cfg.name == arch
    with pytest.raises(KeyError, match="recurrentgemma-2b"):
        get_config("gemma-7b")


def test_recurrentgemma_entry_points_default_to_cuda(monkeypatch):
    """recurrentgemma-2b's init, cache and launcher default to the card (its
    int8 cache is refused, so the cache is asked for in float32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke_config("recurrentgemma-2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
    from repro_torch.launch import quantize
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize.main(["--arch", "recurrentgemma-2b", "--smoke", "--iters",
                       "0"])


def test_train_launcher_defaults_to_cuda(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "recurrentgemma-2b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_chip_smoke_imports_no_jax_and_no_reference():
    """``chip_smoke.py`` (run on the card without the JAX package) imports
    neither ``jax`` nor ``repro`` at import time nor in any function."""
    import ast
    import pathlib
    src = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}

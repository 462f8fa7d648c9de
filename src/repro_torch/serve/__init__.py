"""Quantized continuous-batching serving engine of the port.

  kv.py        int8 KV cache: quantizer, dequant-free decode attention,
               per-slot byte accounting, KVQuantUnsupported
  engine.py    bucketed prefill + slot-based decode over the deploy path
  scheduler.py host-side admission queue + async detokenize thread
  smoke.py     machine-readable serve-capability probe

``repro_torch.serve.kv`` must stay importable from ``repro_torch.models``
(the model families quantize-on-append through it), so this package
imports the engine side lazily: ``from repro_torch.serve import
ServeEngine`` works, but importing ``repro_torch.serve`` (as the models do
for ``kv``) pulls in nothing of the engine, the scheduler or the probe.
"""
from repro_torch.serve.kv import (  # noqa: F401
    KV_SCALE_MIN,
    KVQuantUnsupported,
    hbm_per_slot_mib,
    int8_decode_attention,
    kv_dequantize,
    kv_quantize,
)

_LAZY = {
    "ServeEngine": "repro_torch.serve.engine",
    "EngineConfig": "repro_torch.serve.engine",
    "Scheduler": "repro_torch.serve.scheduler",
    "Request": "repro_torch.serve.scheduler",
    "serve_capability": "repro_torch.serve.smoke",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.serve' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)

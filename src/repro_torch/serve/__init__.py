"""Quantized continuous-batching serving engine of the port.

  kv.py        int8 KV cache: quantizer, dequant-free decode attention,
               per-slot byte accounting, KVQuantUnsupported
  engine.py    bucketed prefill + slot-based decode over the deploy path
  smoke.py     machine-readable serve-capability probe
"""

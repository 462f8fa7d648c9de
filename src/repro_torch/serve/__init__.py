"""Quantized continuous-batching serving engine of the port.

  kv.py        int8 KV cache: quantizer, dequant-free decode attention,
               per-slot byte accounting, KVQuantUnsupported
  engine.py    bucketed prefill + slot-based decode over the deploy path
  scheduler.py host-side admission queue + async detokenize thread
  smoke.py     machine-readable serve-capability probe
"""

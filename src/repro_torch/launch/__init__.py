"""Entry points of the port: ``python -m repro_torch.launch.quantize`` (PTQ)
and ``python -m repro_torch.launch.train`` (training)."""

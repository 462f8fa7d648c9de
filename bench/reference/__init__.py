"""Plain PyTorch references: float32 forwards and quantizers written from
the published descriptions. They import nothing of the port and take no
tensor it made; the benchmark hands both sides the same seeded inputs."""

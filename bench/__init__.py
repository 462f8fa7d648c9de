"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; ``bench/README.md`` says how the files
under this folder are found by name.
"""

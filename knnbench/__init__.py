"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: repeated k-NN
ticks through ``repro_torch.api.KnnSession`` on one NVIDIA H100.

Run one cell from the repository root on a machine with the card::

    python3 knnbench/run.py --workload uniform_1m.move_all --seed 7 \\
        --seconds 51 --trace 0

``BENCHMARK.json`` at the root lists the cells and metrics; each
configuration, traffic mix, metric and reference is a file of its own here,
found by name (``harness.py``).  Nothing here imports JAX or the JAX package.
"""

"""The benchmark of gravit_tpu_torch (the PyTorch + CUDA port): one cell is
one configuration under one traffic mix, as BENCHMARK.json lists them.
See README.md."""

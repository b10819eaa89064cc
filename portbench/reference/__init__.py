"""The plain reference: PyTorch and NumPy only. It imports nothing of the
program (gravit_tpu_torch) and nothing of the JAX package, and works every
frame, loss and count out again from the inputs the benchmark makes."""

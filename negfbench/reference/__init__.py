"""Plain references of the benchmark: NumPy and plain PyTorch in complex128.

Nothing here imports the program under test (``gaunegf_tpu_torch``), the
JAX package or JAX.  Every input comes from the benchmark's own
configuration builders; the program's outputs are only read to be judged.
"""

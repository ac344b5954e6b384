# Hand-written CUDA kernels for Hopper (csrc/*.cu), their wrappers (ops.py)
# and their plain PyTorch versions (ref.py).

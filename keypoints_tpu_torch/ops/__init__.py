"""Plain PyTorch ops: the kernels' oracles and the path for CPU tensors."""

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

#: bfloat16 / float16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores
F32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12

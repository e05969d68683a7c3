"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity)."""
FP32_FLOP_S = 67e12     # float32 outside the tensor cores
BF16_FLOP_S = 989e12    # bfloat16 tensor cores
BYTES_S = 3.35e12       # HBM3

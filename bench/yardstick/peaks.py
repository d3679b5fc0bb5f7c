"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of a
peak is stated against these, with the card's power limit beside it."""

#: dense bfloat16 tensor-core operations a second
BF16_OPS_PER_S = 989e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12

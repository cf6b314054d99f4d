"""The chip's published peaks: NVIDIA H100 SXM data sheet, dense rates
without sparsity, at the card's full 700 W power limit. A run states the
card's power limit beside every share of these peaks."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

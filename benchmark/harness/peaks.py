"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit); every roofline and MFU divides by these."""

PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 / fp16 dense
PEAK_BYTES_PER_S = 3.35e12  # HBM3

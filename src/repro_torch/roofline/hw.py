"""NVIDIA H100 SXM5 80GB constants, the port's target card, in place of the
reference's TPU v5e (``src/repro/roofline/hw.py``).

Source: NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column (dense
rates, without sparsity).  ``chip_smoke.py``'s kernel bounds and the dry
run's roofline read these same numbers.
"""
from __future__ import annotations

# device memory (HBM3) bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
# peak operation rate per input type: bf16 on the tensor cores, f32 on the
# CUDA cores (the datasheet's "FP32" row; the port's f32 products stay full
# f32, see device.py)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
PEAK_FLOPS_BF16 = PEAK_OPS_PER_S["bfloat16"]
# TF32 on the tensor cores (the datasheet's "TF32 Tensor Core" row, dense):
# the bound of an f32-accurate split of an f32 product into TF32 products,
# which chip_smoke.py records beside the power iteration's f32 bound
PEAK_TF32_OPS_PER_S = 495e12
# device memory per card ("80GB" on the datasheet)
HBM_BYTES = 80e9
# NVLink 4 bandwidth per card, both directions together (datasheet: 900
# GB/s); a collective's bytes leave a card in one direction at half of it
NVLINK_BYTES_PER_S = 900e9
COLLECTIVE_BYTES_PER_S = NVLINK_BYTES_PER_S / 2

"""NVIDIA H100 80GB HBM3 (SXM, 700 W) constants for the roofline model,
per card, under the JAX package's names (``repro.roofline.hw``).

These are datasheet peaks, dense (no sparsity): bf16 and TF32 on the
tensor cores, fp32 on the CUDA cores. ``HBM_BYTES`` is the
``total_memory`` that the card itself reports to
``torch.cuda.get_device_properties``. ``ICI_BW_PER_LINK`` is NVLink 4's
rate in one direction: one card has no link, so the collective term of a
roofline stays notional until four cards run.
"""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_TF32 = 494.7e12  # FLOP/s, dense TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s, HBM3
ICI_BW_PER_LINK = 450e9  # bytes/s, NVLink 4, one direction
HBM_BYTES = 85_017_493_504  # torch.cuda.get_device_properties(0).total_memory


def peak_flops(dtype) -> float:
    """The peak for a step computed in ``dtype`` (a name or a torch dtype):
    bf16 and fp16 on the tensor cores; fp32 on the CUDA cores, since the
    port leaves TF32 matmuls off (PyTorch's default)."""
    name = str(dtype).removeprefix("torch.")
    if name in ("bfloat16", "float16"):
        return PEAK_FLOPS_BF16
    if name == "float32":
        return PEAK_FLOPS_FP32
    raise ValueError(f"no peak for dtype {dtype!r}")

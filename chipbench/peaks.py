"""The card's published peaks, by ``torch.cuda.get_device_name()``.

Dense tensor-core rates (no sparsity): an H100 SXM5 does 989 TFLOP/s on
bf16 or fp16 inputs and 495 TFLOP/s on TF32, the fastest route for
float32 inputs, so no legitimate kernel on either can exceed its share;
HBM3 moves 3.35 TB/s."""
from __future__ import annotations

from typing import Dict

H100_SXM = {"bf16_flops": 989e12, "float32_flops": 495e12,
            "hbm_bytes_per_s": 3.35e12}

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks(kind: str) -> Dict[str, float]:
    """The peaks of ``kind``; an H100 SXM's where the name is not listed
    (the caller records the name beside every number)."""
    return PEAKS.get(kind, H100_SXM)


def flops_peak(p: Dict[str, float], dtype: str) -> float:
    """The fastest rate for inputs of ``dtype`` (``bfloat16`` or
    ``float32``)."""
    return p["float32_flops"] if dtype == "float32" else p["bf16_flops"]

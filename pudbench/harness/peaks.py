"""Published peaks of the chips the benchmark runs on (dense rates,
without sparsity), keyed by ``torch.cuda.get_device_name()``.  NVIDIA
H100 SXM data sheet: 989.4 TFLOP/s bf16, 1,978.9 TOP/s int8, 3.35 TB/s of
HBM3; the rates assume the full 700 W power limit."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "int8_ops": 1978.9e12,
                              "hbm_bytes_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The peaks of ``device_name``, or None for a chip not in the table
    (a reader then reports nothing rather than a share of a guess)."""
    return PEAKS.get(device_name)

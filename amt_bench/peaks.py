"""Data-sheet peaks of one NVIDIA H100 by part (NVIDIA H100 data sheet,
dense rates without sparsity), frozen from ``chip_smoke.py``'s ``PEAKS`` and
``repro_torch/launch/roofline.py``'s ``H100_SXM`` at commit 34e7d4a: HBM
bytes/s; FP64 and FP32 outside the tensor cores; FP64 and BF16 on the tensor
cores. They assume the card's full power limit (700 W on the SXM part)."""

PEAKS = {
    "SXM": {"hbm": 3.35e12, "f64": 34e12, "f64_tc": 67e12, "f32": 67e12, "bf16": 989e12},
    "PCIe": {"hbm": 2.0e12, "f64": 26e12, "f64_tc": 51e12, "f32": 51e12, "bf16": 756e12},
    "NVL": {"hbm": 3.9e12, "f64": 30e12, "f64_tc": 60e12, "f32": 60e12, "bf16": 835e12},
}


def peaks_of(device_name: str) -> dict:
    """The peaks of the part ``torch.cuda.get_device_name()`` names."""
    for part in ("PCIe", "NVL"):
        if part in device_name:
            return PEAKS[part]
    return PEAKS["SXM"]

"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates): device memory bytes/s and float32 operations/s outside the
tensor cores. A frozen copy of chip_smoke.py's PEAKS, with the card
names matched most specific first."""
from __future__ import annotations

PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12),
    ("H100 NVL", 3.9e12, 60.0e12),
    ("H200", 4.8e12, 67.0e12),
    ("H100", 3.35e12, 67.0e12),  # SXM (HBM3)
)


def peaks_for(kind: str):
    """(bytes/s, float32 operations/s) of the card named `kind`
    (torch.cuda.get_device_name()), or None for a card not listed."""
    for name, bw, ops in PEAKS:
        if name in kind:
            return bw, ops
    return None

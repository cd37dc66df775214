"""Published peaks of the cards the benchmark knows (NVIDIA data sheets,
dense rates without sparsity, at the full power limit). A card not listed
has no peaks, and the shares of a peak are then not reported."""
from __future__ import annotations

from typing import Dict, Optional

# name fragment -> {precision: FLOP/s, "bytes_per_s": B/s}; first match wins
TABLE = (
    ("H100 PCIe", {"float32": 51.2e12, "tf32": 378e12, "bfloat16": 756e12,
                   "bytes_per_s": 2.0e12}),
    ("H100", {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12}),
)


def for_device(device_name: str, precision: str) -> Optional[Dict[str, float]]:
    """{"flops", "bytes_per_s"} of the card at `precision` ("float32" with
    TF32 off, "tf32", "bfloat16"), or None for a card not in the table."""
    for fragment, peaks in TABLE:
        if fragment in device_name:
            return {"flops": peaks[precision], "bytes_per_s": peaks["bytes_per_s"]}
    return None

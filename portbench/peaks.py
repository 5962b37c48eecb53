"""The card's peaks, from NVIDIA's data sheets (dense rates, full power
limit), and the roofline bound of a piece of work."""
from __future__ import annotations

from typing import Tuple


def peaks(name: str) -> Tuple[float, float]:
    """(f32 FLOP/s without tensor cores, HBM bytes/s): H100 SXM 67 TFLOP/s
    and 3.35 TB/s, H100 PCIe 51 and 2.0."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    return 67e12, 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float,
          peak_bw: float) -> Tuple[float, str]:
    """(the least seconds the work can take on the card, which of the two
    bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")

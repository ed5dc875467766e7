"""The yardstick of the kernels' roofline shares: the chip's published
peaks and the bytes each kernel of the main path has to move, computed
from its shapes.

A share is the least time the chip could take for the work (the bytes
over the peak memory bandwidth; both kernels are bound by bytes, not by
operations) over the kernel's measured device time.  Each input byte is
counted read once and each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
H100 = {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}
PEAKS = {"NVIDIA H100 80GB HBM3": H100}


def peaks(device_name: str) -> dict | None:
    """The peaks of a card by its name, or None for a card not listed."""
    if device_name in PEAKS:
        return PEAKS[device_name]
    return H100 if "H100" in device_name else None


def solve_bytes(n_flows: int, n_live, n_touched) -> float:
    """Bytes one ``maxmin_solve`` launch needs, summed over its lanes:
    each lane reads its live mask (``n_flows`` bytes), writes its rates
    (``4 n_flows``), reads each live flow's provider, consumer and rate
    limit (12 bytes) and each touched spreader's capacity (4 bytes).
    ``n_live`` and ``n_touched`` give one number a lane."""
    return float(sum(5 * n_flows + 12 * int(a) + 4 * int(b)
                     for a, b in zip(n_live, n_touched)))


def masked_min_bytes(n_lanes: int, n: int) -> float:
    """Bytes one ``masked_min`` launch needs: each lane reads ``n``
    candidates (f32) and their mask (bytes) and writes one f32."""
    return float(n_lanes * (5 * n + 4))

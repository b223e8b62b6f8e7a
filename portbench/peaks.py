"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 80 GB (data sheet): HBM3 at 3.35 TB/s, at the full
700 W power limit.  The data sheet gives no integer rate; the INT32 peak
is 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T ops/s, the rate
an integer hash runs at when nothing else binds.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 132 * 64 * 1.98e9},
}


def peaks_for(device_name: str) -> dict:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no peak table for {device_name!r}")

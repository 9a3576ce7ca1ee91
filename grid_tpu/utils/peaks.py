"""Published peak rates that benchmark times are divided by.

One table keyed by ``jax.Device.device_kind``. Source: NVIDIA's H100 data
sheet, SXM part, dense rates without sparsity, at the full 700 W power
limit. A card set below 700 W cannot hold these rates, so a utilization is
reported beside the card's power limit. A kind that is not in the table
has no peak: :func:`peak_for` returns None, never a borrowed one.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,  # outside the tensor cores: Precision.HIGHEST
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak_for(device_kind: str) -> dict | None:
    """The peak rates of ``device_kind``, or None for a kind not listed."""
    return PEAKS.get(device_kind)

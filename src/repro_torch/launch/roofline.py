"""Card peaks for roofline terms, keyed by the card's name.

The reference's ``repro/launch/roofline.py`` prices work at one TPU v5e
chip's constants. The port prices it at the peaks of the CUDA card it runs
on, read from :data:`PEAKS` by ``torch.cuda.get_device_name``: the
published dense rates of NVIDIA's data sheet at the card's full power
limit. A CUDA card missing from the table raises rather than borrowing
another card's peaks; the CPU has none. The reference's HLO parsers
(``collective_bytes``, ``roofline_terms``, ``loop_factor``,
``model_flops``) belong to the mesh tooling and are not ported.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """One card's peak rates: HBM bytes/s and FLOP/s by operand type."""

    name: str
    hbm_bytes_per_s: float
    fp32_flop_per_s: float     # outside the tensor cores
    bf16_flop_per_s: float     # dense, tensor cores

    def flop_per_s(self, dtype: str = "fp32") -> float:
        if dtype == "fp32":
            return self.fp32_flop_per_s
        if dtype == "bf16":
            return self.bf16_flop_per_s
        raise ValueError(f"no peak for dtype {dtype!r} (fp32 or bf16)")

    def terms(self, flops: float, n_bytes: float,
              dtype: str = "fp32") -> tuple[float, float]:
        """(compute_s, memory_s): ``flops`` at the type's peak, ``n_bytes``
        at the HBM rate."""
        return flops / self.flop_per_s(dtype), n_bytes / self.hbm_bytes_per_s


PEAKS = {
    p.name: p for p in (
        # H100 SXM5: 3.35 TB/s HBM3, 67 TFLOP/s fp32, 989 TFLOP/s bf16
        CardPeaks("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 989e12),
    )
}


def peaks_of(name: str) -> CardPeaks:
    """The table's entry for the card called ``name``; raises for a card
    the table does not hold."""
    try:
        return PEAKS[name]
    except KeyError:
        raise KeyError(
            f"no peaks for CUDA card {name!r}; known: {sorted(PEAKS)}"
        ) from None


def device_peaks(device) -> CardPeaks | None:
    """Peaks of the card behind ``device``; None on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    return peaks_of(torch.cuda.get_device_name(device))

"""Model and data inspection utilities (``onet_tpu/utils/summary.py``):
for now the signal-to-clutter ratio of a labelled target, which the ZY-3
preprocessing on-ramp reports. The parameter and FLOP tables are not
ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch


def scr_db(image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Signal-to-clutter ratio of the labelled extended target (dB): the
    mean energy under the label over the mean energy outside it. Stays on
    the device; ``get_scr`` is the host float."""
    lab = label.to(image.dtype)
    sig = torch.sum(torch.square(lab * image)) / torch.clamp_min(
        torch.sum(lab == 1), 1)
    noi = torch.sum(torch.square((1 - lab) * image)) / torch.clamp_min(
        torch.sum(lab == 0), 1)
    return 10.0 * torch.log10(sig / noi)


def get_scr(image: torch.Tensor, label: torch.Tensor) -> float:
    """Signal-to-clutter ratio of the labelled extended target (dB)."""
    return float(scr_db(image, label))

"""Default-device resolution for the port's entry points.

Entry points run on the card. Without one they raise: a number taken on
the CPU must never pass for a device number, so nothing falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; any CUDA device raises when no card is
    present; ``"cpu"`` (what the tests pass) is returned as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "onet_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev

"""Device selection for the port's entry points.

Every entry point takes a ``device`` that defaults to ``"cuda"``. Asking
for the card where there is none raises: nothing carries on on the CPU by
itself. The CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"`` or ``"cpu"`` -> a ``torch.device``; raises
    ``RuntimeError`` when CUDA is asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev

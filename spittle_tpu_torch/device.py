"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there is
no silent drop to the CPU when no card is present.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """"cuda" / "cuda:N" / "cpu" (or a torch.device) -> torch.device.

    Asking for a CUDA device without a visible card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev

"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and never falls back
to the CPU by itself: the CPU runs only when the caller asks for it (the
tests do, with ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch.device for an entry point's ``device`` argument.

    Raises RuntimeError when a CUDA device is asked for and none is
    available, instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev

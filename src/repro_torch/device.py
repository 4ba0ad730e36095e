"""Device policy of the port: entry points run on the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises if a CUDA device is asked for (or
    implied) and none is present: the port never moves to the CPU unless the
    caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the host")
    return dev

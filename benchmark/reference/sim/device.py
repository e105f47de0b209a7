"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as given, or ``cuda`` when it is None. Raises when CUDA is
    asked for, or implied, and absent: the port never falls back to the CPU
    by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

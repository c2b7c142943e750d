"""Device selection shared by the port's entry points.

The port runs on the card unless the caller asks for the CPU: an entry point
given no device takes ``cuda`` and raises when CUDA is absent, rather than
carrying on with the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without CUDA); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions of its kernels"
        )
    return dev

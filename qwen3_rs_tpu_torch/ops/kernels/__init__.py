"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts the kernel
launches of each wrapper (plain calls are not counted), so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"qmatmul_w8a16": 0, "flash_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts the kernel
launches of each wrapper (plain calls are not counted), so a run can show
that its path went through the kernels.  The attention kernels' modules each
say which head_dims their kernels take (``takes_head_dim``).
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    # The fused kernel's route at one row (``qmatmul.qmatmul_w8a16_row``).
    "qmatmul_w8a16": 0,
    "qmatmul_w8a16_q4": 0,
    # The fused kernel's mma route (``qmatmul.MMA_MIN_ROWS`` to ``TC_MIN_ROWS - 1`` rows).
    "qmatmul_w8a16_mma": 0,
    "qmatmul_w8a16_mma_q4": 0,
    # The fused kernel's tensor-core route (windows of ``qmatmul.TC_MIN_ROWS`` rows or more).
    "qmatmul_w8a16_tc": 0,
    "qmatmul_w8a16_tc_q4": 0,
    "flash_decode": 0,
    "qmatmul_w8a16_rows": 0,
    "qmatmul_w8a16_rows_q4": 0,
    "qmatmul_w8a16_rows_cols": 0,
    "dequant_w8_stacked": 0,
    "dequant_q4_stacked": 0,
    "qmatmul_w8a8_rows": 0,
    "causal_prefill_attention": 0,
    "paged_decode": 0,
    "paged_window_partials": 0,
    "decode_megakernel": 0,
    "decode_megakernel_q4": 0,
    # The measurement probes' kernels (``probes.py``), driven by ``qwen3_rs_tpu_torch.scripts``.
    "boundary_onecall": 0,
    "hbm_stream": 0,
    "head_a8": 0,
    "a8_depth": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

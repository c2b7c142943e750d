"""Shared set-up for the PyTorch port's parity tests: route the JAX package's
forward through its Pallas kernels in interpret mode, as its own parity tests
do (``tests/test_model_parity.py``), so that it follows the numerics the
port's kernels follow."""

import collections

import qwen3_rs_tpu.ops.pallas as pallas_pkg
import qwen3_rs_tpu.ops.pallas.flash_attention as jax_flash
from qwen3_rs_tpu.ops.pallas.qmatmul import qmatmul_pallas, qmatmul_pallas_stacked_fused


def route_jax_through_interpret_kernels(monkeypatch, min_seq_len: int) -> collections.Counter:
    """Megakernel off; the fused W8A16 kernel, the classifier kernel and
    flash decode on in interpret mode (flash decode from ``min_seq_len``
    cache rows).  Returns the count of kernel calls seen while tracing."""
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, interpret=True, **kw)

        return wrapper

    monkeypatch.setenv("QWEN3_TPU_DISABLE_MEGAKERNEL", "1")
    monkeypatch.setattr(pallas_pkg, "pallas_enabled", lambda: True)
    monkeypatch.setattr(
        pallas_pkg, "qmatmul_pallas_stacked_fused", counted("fused", qmatmul_pallas_stacked_fused)
    )
    monkeypatch.setattr(pallas_pkg, "qmatmul_pallas", counted("head", qmatmul_pallas))
    monkeypatch.setattr(
        jax_flash, "flash_gqa_decode_stacked", counted("flash", jax_flash.flash_gqa_decode_stacked)
    )
    monkeypatch.setattr(jax_flash, "MIN_SEQ_LEN", min_seq_len)
    return calls

"""The measurement probes' kernels: each plain version against the JAX probe
it stands in for, on the same numpy inputs, at tiny shapes.

* ``boundary_onecall`` (P1): each layer against the JAX package's
  ``qmatmul_pallas_stacked`` in interpret mode at #2's tolerance
  (``1e-4 · max|ref|``; power-of-two scales, as ``test_torch_qmatmul.py``).
* ``hbm_stream`` (P2): numpy's exact int64 sum, bit for bit.
* ``head_a8`` (P3): the JAX probe's own kernel body
  (``scripts/head_a8_probe.py::make_kernel``, the script imported with small
  ``sys.argv``) run by ``pl.pallas_call(..., interpret=True)``; f32 sums of
  the same products and fixups in another order: ``1e-5 · max|ref|``.
* ``a8_depth`` (P4): the JAX probe's arithmetic rebuilt with
  ``jax.lax.dot_general`` (its script runs at import): int32 per 64-deep group
  within 512-deep k-tiles, f32 across them.  The int arms bit for bit (every
  partial sum is an integer below 2^24), ``bf16-full`` at ``1e-5 · max|ref|``.

Each probe's entry point raises without CUDA.
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qwen3_rs_tpu.ops.pallas.qmatmul import qmatmul_pallas_stacked
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.probes import (
    A8_DEPTH_VARIANTS,
    HEAD_A8_VARIANTS,
    a8_depth,
    a8_depth_plain,
    boundary_onecall,
    boundary_onecall_plain,
    hbm_stream,
    hbm_stream_plain,
    head_a8,
    head_a8_plain,
    strip_threads,
)
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _rel_close(out, ref, rtol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


# --------------------------------------------------------------------- P1
@pytest.mark.parametrize("layers,n,d", [(3, 256, 256), (2, 512, 384)])
def test_boundary_onecall_plain_matches_qmatmul_pallas_stacked(layers, n, d):
    rng = np.random.default_rng(n + d)
    codes = rng.integers(-127, 127, (layers, n, d)).astype(np.int8)
    scales = (2.0 ** rng.integers(-9, -5, (layers, n // 64, d))).astype(np.float32)
    x = rng.normal(0, 1, (1, n)).astype(np.float32)
    jw = JaxQT(jnp.asarray(codes), jnp.asarray(scales).astype(jnp.bfloat16))
    tw = QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales).to(torch.bfloat16))
    got = boundary_onecall_plain(torch.from_numpy(x), tw, reps=4)
    assert got.shape == (layers, d) and got.dtype == torch.float32
    for l in range(layers):
        ref = qmatmul_pallas_stacked(jnp.asarray(x), jw, l, interpret=True, impl="scale_w")
        _rel_close(got[l : l + 1], ref, 1e-4)
    before = LAUNCHES["boundary_onecall"]
    assert torch.equal(boundary_onecall(torch.from_numpy(x), tw, 2), got)  # the CPU wrapper runs the plain version
    assert LAUNCHES["boundary_onecall"] == before


def test_strip_threads_give_every_sm_a_block_where_they_can():
    assert strip_threads(24576, 132) == 8  # w13: 192 strips of 128 columns
    assert strip_threads(6144, 132) == 2 and strip_threads(4096, 132) == 2  # as many strips as D/32 allows
    assert strip_threads(65536, 132) == 16
    with pytest.raises(ValueError, match="multiple of 32"):
        strip_threads(48, 132)


# --------------------------------------------------------------------- P2
@pytest.mark.parametrize("span", [16, 1024, 8192 * 8])
def test_hbm_stream_plain_is_the_exact_sum(span):
    rng = np.random.default_rng(span)
    x = rng.integers(-128, 128, 8192 * 24, dtype=np.int64).astype(np.int8)
    x[:4096] = -128  # a run of the extreme code
    want = int(x.astype(np.int64).sum())
    t = torch.from_numpy(x)
    got = hbm_stream_plain(t, span)
    assert got.dtype == torch.int64 and int(got) == want
    before = LAUNCHES["hbm_stream"]
    assert int(hbm_stream(t, span)) == want
    assert LAUNCHES["hbm_stream"] == before
    with pytest.raises(ValueError, match="multiple of 16"):
        hbm_stream(t, 24)


# --------------------------------------------------------------------- P3
B3, TN3, TD3, N_TILES = 3, 512, 32, 2


@pytest.fixture(scope="module")
def head_a8_script():
    """``scripts/head_a8_probe.py`` imported with small shapes (it reads
    ``sys.argv`` and sets up JAX's compile cache when imported)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("QWEN3_TPU_NO_COMPILE_CACHE", "1")
    mp.setattr(sys, "argv", ["head_a8_probe.py", str(B3), str(TN3), str(TD3)])
    spec = importlib.util.spec_from_file_location("_jax_head_a8_probe", ROOT / "scripts" / "head_a8_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    assert (mod.B, mod.TN, mod.TD, mod.TG) == (B3, TN3, TD3, TN3 // 64)
    return mod


def _head_inputs(seed):
    rng = np.random.default_rng(seed)
    tg = TN3 // 64
    return {
        "x": rng.standard_normal((B3, TN3)).astype(np.float32),
        "xq": rng.integers(-127, 128, (B3, TN3)).astype(np.int8),
        "xs": (rng.random((B3, tg)) * 0.01 + 0.001).astype(np.float32),
        "w": rng.integers(-127, 128, (N_TILES, TN3, TD3)).astype(np.int8),
        # Powers of two: code · bf16(scale) is exact in bf16, which XLA on the CPU does not round.
        "s": (2.0 ** rng.integers(-9, -5, (N_TILES, tg, TD3))).astype(np.float32),
    }


@pytest.mark.parametrize("variant", HEAD_A8_VARIANTS)
def test_head_a8_plain_matches_the_jax_probe_kernel(head_a8_script, variant):
    a = _head_inputs(7)
    args = (jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["xq"]), jnp.asarray(a["xs"]), jnp.asarray(a["w"]),
            jnp.asarray(a["s"]))
    ref = pl.pallas_call(
        head_a8_script.make_kernel(variant, N_TILES),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B3, TD3), jnp.float32),
        interpret=True,
    )(*args)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["x"] = t["x"].to(torch.bfloat16)
    got = head_a8_plain(variant, **t)
    assert got.shape == (B3, TD3) and got.dtype == torch.float32
    _rel_close(got, ref, 1e-5)
    before = LAUNCHES["head_a8"]
    assert torch.equal(head_a8(variant, **t), got)
    assert LAUNCHES["head_a8"] == before


def test_head_a8_sweeps_cycle_the_tiles():
    t = {k: torch.from_numpy(v) for k, v in _head_inputs(8).items()}
    t["x"] = t["x"].to(torch.bfloat16)
    one = head_a8_plain("i8-seg2", **t, sweeps=1)
    two = head_a8_plain("i8-seg2", **t, sweeps=2)
    tile1 = head_a8_plain("i8-seg2", **{**t, "w": t["w"][1:], "s": t["s"][1:]}, sweeps=1)
    assert torch.equal(two, one + tile1)
    with pytest.raises(ValueError, match="variant"):
        head_a8("i4-seg", **t)


# --------------------------------------------------------------------- P4
def _jax_a8_depth(variant, x, w):
    """The JAX probe's body over its grid's k axis (512-deep tiles): bf16 dots
    in f32, or int32 dots (per 64-deep group for i8-seg64) added as f32."""
    tile_n, g = 512, 64
    o = jnp.zeros((x.shape[0], w.shape[1]), jnp.float32)
    dims = (((1,), (0,)), ((), ()))
    for k0 in range(0, x.shape[1], tile_n):
        xt, wt = x[:, k0 : k0 + tile_n], w[k0 : k0 + tile_n]
        if variant == "bf16-full":
            o = o + jax.lax.dot_general(xt, wt, dims, preferred_element_type=jnp.float32)
        elif variant == "i8-full":
            o = o + jax.lax.dot_general(xt, wt, dims, preferred_element_type=jnp.int32).astype(jnp.float32)
        else:
            acc = jnp.zeros(o.shape, jnp.int32)
            for j in range(0, xt.shape[1], g):
                acc = acc + jax.lax.dot_general(xt[:, j : j + g], wt[j : j + g], dims,
                                                preferred_element_type=jnp.int32)
            o = o + acc.astype(jnp.float32)
    return np.asarray(o)


@pytest.mark.parametrize("variant", A8_DEPTH_VARIANTS)
def test_a8_depth_plain_matches_the_jax_probe_arithmetic(variant):
    rng = np.random.default_rng(11)
    xf = (rng.standard_normal((128, 1024)) * 3).astype(np.float32)
    wf = (rng.standard_normal((1024, 256)) * 3).astype(np.float32)
    if variant == "bf16-full":
        jx, jw = jnp.asarray(xf, jnp.bfloat16), jnp.asarray(wf, jnp.bfloat16)
        tx, tw = torch.from_numpy(xf).to(torch.bfloat16), torch.from_numpy(wf.T.copy()).to(torch.bfloat16)
    else:
        jx, jw = jnp.asarray(xf).astype(jnp.int8), jnp.asarray(wf).astype(jnp.int8)
        tx, tw = torch.from_numpy(np.array(jx)), torch.from_numpy(np.asarray(jw).T.copy())
        assert int(tx.abs().max()) <= 20  # N(0, 9) cast to int8: every partial sum stays below 2^24
    ref = _jax_a8_depth(variant, jx, jw)
    got = a8_depth_plain(variant, tx, tw)
    assert got.shape == (128, 256) and got.dtype == torch.float32
    if variant == "bf16-full":
        _rel_close(got, ref, 1e-5)
    else:
        assert np.array_equal(got.numpy(), ref)
    before = LAUNCHES["a8_depth"]
    assert torch.equal(a8_depth(variant, tx, tw), got)
    assert LAUNCHES["a8_depth"] == before


# ----------------------------------------------------------- entry points
@pytest.mark.parametrize("name", ["boundary_probe", "hbm_stream_bench", "head_a8_probe", "a8_depth_probe"])
def test_probe_entry_points_raise_without_cuda(name):
    mod = importlib.import_module(f"qwen3_rs_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.run(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run()

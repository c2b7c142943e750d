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

Beside them, the pure functions the card kernels follow: P1's plan and walk
(``onecall_plan``, ``onecall_walk``) at the 8B matrices, P3's cut of the work
(``head_a8_plan``), the int-to-float
identity of the magic number 1.5·2^23 over its whole range, and P4's tiles
and flush segments over K.  Each probe's entry point raises without CUDA.
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
    A8_DEPTH_TILE,
    A8_DEPTH_VARIANTS,
    A8_SEG_DEPTH,
    HEAD_A8_VARIANTS,
    a8_depth,
    a8_depth_flushes,
    a8_depth_plain,
    a8_depth_plan,
    boundary_onecall,
    boundary_onecall_plain,
    hbm_stream,
    hbm_stream_plain,
    head_a8,
    head_a8_grid,
    head_a8_plain,
    head_a8_plan,
    head_a8_smem,
    head_a8_workspace_floats,
    onecall_plan,
    onecall_smem,
    onecall_walk,
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


@pytest.mark.parametrize("layers", [1, 3, 8])
@pytest.mark.parametrize("mat", ["wqkv", "wo", "w13", "w2"])
def test_onecall_plan_covers_every_layer_strip_and_slice_once(mat, layers):
    """The one-call kernel's walk of a rep at the 8B matrices on an H100 (132
    SMs, 3 blocks each): every (layer, 128-column strip, 16-row k-slice)
    exactly once, split runs of whole warps' k-slices, and a grid of one wave
    of resident blocks (or every unit) whose units fill its waves."""
    from qwen3_rs_tpu_torch.scripts.boundary_probe import matrices

    n, d = matrices("8b")[mat]
    g, sms, per_sm = 64, 132, 3
    splits, spb, grid = onecall_plan(n, d, g, layers, sms, per_sm)
    strips, slices = -(-d // 128), -(-n // 16)
    units = layers * strips * splits
    assert spb % 8 == 0 and (splits - 1) * spb < slices <= splits * spb
    assert onecall_smem(n, spb, g) <= 64 * 1024  # three blocks an SM
    assert grid == min(units, sms * per_sm)
    assert units / (-(-units // grid) * grid) >= 0.88, (splits, units, grid)
    walk = onecall_walk(n, d, layers, splits, spb, grid)
    assert len(walk) == units and [rec[0] for rec in walk] == [u % grid for u in range(units)]
    seen = np.zeros((layers, strips, slices), np.int32)
    for _, layer, c0, c1, r0, r1 in walk:
        assert c0 % 128 == 0 and c1 == min(c0 + 128, d) and r0 % 16 == 0 and r0 < r1 <= n
        seen[layer, c0 // 128, r0 // 16 : -(-r1 // 16)] += 1
    assert (seen == 1).all()


def test_onecall_plan_takes_a_block_an_sm_where_x_fills_its_shared_memory():
    """Past N ≈ 28K, x's bf16 slots leave no room for a unit's scale rows
    under the 64 KB that lets three blocks share an SM: the plan takes one
    block an SM and up to 227 KB, and still covers every slice once."""
    n, d, g, layers = 40960, 256, 64, 2
    splits, spb, grid = onecall_plan(n, d, g, layers, 132, 3)
    assert onecall_smem(n, 8, g) > 64 * 1024
    assert onecall_smem(n, spb, g) <= 227 * 1024 and grid <= 132
    walk = onecall_walk(n, d, layers, splits, spb, grid)
    rows = sorted((layer, c0, r0, r1) for _, layer, c0, _, r0, r1 in walk)
    for layer in range(layers):
        for c0 in (0, 128):
            runs = [(r0, r1) for lay, c, r0, r1 in rows if lay == layer and c == c0]
            assert runs[0][0] == 0 and runs[-1][1] == n and all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


def test_conversion_for_free_is_exact_over_its_whole_range():
    """P4's flush (and #8's): a group's int32 partials start at the bits of
    1.5·2^23, the tensor cores add the dot as an integer, and the sum read as
    a float minus 12582912 is the dot exactly, for every |dot| <= 2^22."""
    dots = np.arange(-(2**22), 2**22 + 1, dtype=np.int64)
    edges = np.array([-(2**22), -(2**22) + 1, -1, 0, 1, 2**22 - 1, 2**22], np.int64)
    for d in (dots, edges):
        bits = (np.int64(0x4B400000) + d).astype(np.int32)  # the s32 accumulator, no overflow
        got = bits.view(np.float32) - np.float32(12582912.0)
        assert got.dtype == np.float32 and np.array_equal(got, d.astype(np.float32))
        assert np.array_equal(got.astype(np.int64), d)


@pytest.mark.parametrize("k", [64, 576, 4096])
@pytest.mark.parametrize("variant", A8_DEPTH_VARIANTS)
def test_a8_depth_flushes_and_tiles_cover_the_depth(variant, k):
    """P4's k-tiles (128 bytes of depth) cover K with less than one tile
    past it (i8-full: less than one 512-deep segment, whose k-tiles past K
    read zeros); the int arms' flushes (64 and 512 rows) cut K into whole
    64-deep groups in depth order, each A8_SEG_DEPTH deep but the last."""
    m, d = 256, 640
    plan = a8_depth_plan(variant, m, k, d)
    bm, bn = A8_DEPTH_TILE[variant]
    assert plan["tiles"] == (m // bm, -(-d // bn)) and plan["tile"] == (bm, bn)
    assert plan["k_tile"] == (64 if variant == "bf16-full" else 128)
    past = plan["k_tile"] if variant != "i8-full" else A8_SEG_DEPTH[variant]
    assert plan["k_tiles"] * plan["k_tile"] - past < k <= plan["k_tiles"] * plan["k_tile"]
    if variant == "i8-full":
        assert plan["k_tiles"] == 4 * len(plan["flushes"])
    if variant == "bf16-full":
        assert "flushes" not in plan
        return
    seg = A8_SEG_DEPTH[variant]
    flushes = a8_depth_flushes(variant, k)
    assert plan["flushes"] == flushes and plan["groups"] * 64 == k
    assert flushes[0][0] == 0 and flushes[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(flushes, flushes[1:]))
    assert all(k1 - k0 == seg for k0, k1 in flushes[:-1]) and 0 < flushes[-1][1] - flushes[-1][0] <= seg
    assert all(k0 % 64 == 0 and k1 % 64 == 0 for k0, k1 in flushes)


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


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("tn", [512, 4096])
@pytest.mark.parametrize("td", [16, 1536, 1552])
def test_head_a8_plan_covers_every_tile_column_and_group_once(td, tn, b):
    """P3's cut of the work (``head_a8_plan``, the kernel's ranges): every
    (tile, 16 columns, 64-row group) in one block exactly, each block one
    contiguous run of units that fits its shared memory and 96 units, a block
    on every SM of a 132-SM card at TD 1536 (TD 1552 = 97 column tiles: the
    units do not divide evenly).  The kernel finds the block of unit u as
    ``((u + 1)·G - 1) // U`` and writes the partial of block i and pair p =
    (tile, column tile) to slot i + p of B·16 floats: both hold here, and
    the slots are distinct and lie within the wrapper's workspace."""
    sms, n_tiles = 132, 2
    m_tiles, groups = td // 16, tn // 64
    n_units = n_tiles * m_tiles * groups
    for variant in HEAD_A8_VARIANTS:
        grid = head_a8_grid(variant, tn, td, n_tiles, sms)
        plan = head_a8_plan(tn, td, n_tiles, grid)
        assert len(plan) == grid and all(plan)
        assert max(len(p) for p in plan) <= 96 and head_a8_smem(variant, tn, max(len(p) for p in plan)) <= 226 * 1024
        flat = [u for p in plan for u in p]
        want = [(t, 16 * m, 64 * c) for t in range(n_tiles) for m in range(m_tiles) for c in range(groups)]
        assert flat == want  # each (tile, columns, group) once, in the kernel's unit order
        if td == 1536:
            assert grid == sms
        start = 0
        for i, p in enumerate(plan):
            for u in range(start, start + len(p)):
                assert ((u + 1) * grid - 1) // n_units == i
            start += len(p)
        segments = {(i, t * m_tiles + c0 // 16) for i, p in enumerate(plan) for t, c0, _ in p}
        slots = {i + pair for i, pair in segments}
        assert len(slots) == len(segments)
        assert (max(slots) + 1) * b * 16 <= head_a8_workspace_floats(grid, td, n_tiles, b)


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

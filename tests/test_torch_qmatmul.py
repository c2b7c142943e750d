"""W8A16 matmul: the port's plain version against the JAX package's Pallas
kernels run in interpret mode (``impl="scale_w"``, bf16 scales).

Both sides round the activations to bf16, take each weight element as
``bf16(code · scale)`` and accumulate in f32, so only the f32 summation order
differs: tolerance ``1e-4 · max|ref|``.  XLA on the CPU fuses the dequant
multiply into the dot and keeps the product in f32 (excess precision), where
the TPU rounds it to bf16 before the matrix unit.  So the interpret-mode
comparisons use power-of-two scales, whose products are exact in bf16, and
``test_weight_products_round_to_bf16`` holds the rounding itself against
numpy with general scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.pallas.qmatmul import (
    qmatmul_pallas,
    qmatmul_pallas_stacked,
    qmatmul_pallas_stacked_fused,
)
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
import qwen3_rs_tpu_torch.ops.kernels.qmatmul as port_qmm
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
    MAX_ROWS,
    MMA_MAX_ROWS,
    MMA_MIN_ROWS,
    TC_MIN_ROWS,
    TC_ROW_TILES,
    mma_cols,
    mma_k_slots,
    mma_plan,
    mma_slot_rows,
    qmatmul_w8a16,
    qmatmul_w8a16_mma,
    qmatmul_w8a16_plain,
    qmatmul_w8a16_row,
    qmatmul_w8a16_tc,
    route,
    row_max_spb,
    row_plan,
    row_runs,
    row_smem_bytes,
    tc_plan,
)
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor, QuantizedTensor, pack_q4_np
from qwen3_rs_tpu_torch.testing import QWEN3_CONFIGS

torch.set_num_threads(2)

L, N, D, G = 2, 256, 256, 64
RTOL = 1e-4


def _weights(seed, stacked=True):
    rng = np.random.default_rng(seed)
    shape = (L, N, D) if stacked else (N, D)
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    # Powers of two: code · scale is exact in bf16 (see the module note).
    scales = (2.0 ** rng.integers(-9, -5, (*shape[:-2], N // G, D))).astype(np.float32)
    jw = JaxQT(jnp.asarray(codes), jnp.asarray(scales).astype(jnp.bfloat16))
    tw = QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales).to(torch.bfloat16))
    return jw, tw, rng


def _close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= RTOL * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


@pytest.mark.parametrize("b", [1, 5, 256])
def test_unstacked_matches_qmatmul_pallas(b):
    jw, tw, rng = _weights(b, stacked=False)
    x = rng.normal(0, 1, (b, N)).astype(np.float32)
    ref = qmatmul_pallas(jnp.asarray(x), jw, interpret=True, impl="scale_w")
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw), ref)


@pytest.mark.parametrize("b", [1, 5, 256])
def test_stacked_matches_qmatmul_pallas_stacked(b):
    jw, tw, rng = _weights(10 + b)
    x = rng.normal(0, 1, (b, N)).astype(np.float32)
    ref = qmatmul_pallas_stacked(jnp.asarray(x), jw, 1, interpret=True, impl="scale_w")
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 1), ref)


@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("prologue", [None, "rms", "swiglu"])
@pytest.mark.parametrize("residual", [None, "f32", "bf16"])
def test_fused_matches_qmatmul_pallas_stacked_fused(b, prologue, residual):
    jw, tw, rng = _weights(100 + b)
    width = 2 * N if prologue == "swiglu" else N
    x = rng.normal(0, 1, (b, width)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.normal(0, 1, (L, N))).astype(np.float32)
    res = rng.normal(0, 1, (b, D)).astype(np.float32)
    jkw, tkw = {}, {}
    if prologue == "rms":
        jkw["norm_w"], tkw["norm_w"] = jnp.asarray(nw), torch.from_numpy(nw)
    if prologue == "swiglu":
        jkw["swiglu"] = tkw["swiglu"] = True
    if residual is not None:
        dt = jnp.float32 if residual == "f32" else jnp.bfloat16
        jkw["residual"] = jnp.asarray(res).astype(dt)
        tkw["residual"] = torch.from_numpy(np.array(jkw["residual"], np.float32)).to(
            torch.float32 if residual == "f32" else torch.bfloat16
        )
    ref = qmatmul_pallas_stacked_fused(
        jnp.asarray(x), jw, 0, eps=1e-6, interpret=True, impl="scale_w", **jkw
    )
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 0, eps=1e-6, **tkw), ref)


def test_bf16_activations_and_leading_dims():
    """bf16 x (the residual stream) with a [B, S, N] shape."""
    jw, tw, rng = _weights(7)
    x = rng.normal(0, 1, (2, 3, N)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    nw = (1.0 + 0.1 * rng.normal(0, 1, (L, N))).astype(np.float32)
    ref = qmatmul_pallas_stacked_fused(
        xj, jw, 1, norm_w=jnp.asarray(nw), interpret=True, impl="scale_w"
    )
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = qmatmul_w8a16(xt, tw, 1, norm_w=torch.from_numpy(nw))
    assert out.shape == (2, 3, D) and out.dtype == torch.float32
    _close(out, ref)


def test_weight_products_round_to_bf16():
    """General bf16 scales: the plain version equals x_bf16 · bf16(code · scale)
    summed in f64, up to f32 summation order."""
    rng = np.random.default_rng(11)
    codes = rng.integers(-127, 128, (N, D)).astype(np.int8)
    scales = torch.from_numpy(rng.uniform(0.001, 0.02, (N // G, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (3, N)).astype(np.float32))
    sb = scales.to(torch.bfloat16)
    w = (torch.from_numpy(codes).float() * sb.float().repeat_interleave(G, 0)).to(torch.bfloat16)
    ref = x.to(torch.bfloat16).double() @ w.double()
    out = qmatmul_w8a16_plain(x, QuantizedTensor(torch.from_numpy(codes), sb))
    assert float((out.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    exact_w = torch.from_numpy(codes).double() * sb.double().repeat_interleave(G, 0)
    unrounded = x.to(torch.bfloat16).double() @ exact_w
    # The rounding is visible at this tolerance, so the check above has teeth.
    assert float((out.double() - unrounded).abs().max()) > 1e-4 * float(ref.abs().max())


def test_cpu_wrapper_is_the_plain_version():
    _, tw, rng = _weights(3)
    x = torch.from_numpy(rng.normal(0, 1, (4, N)).astype(np.float32))
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    for launch in (qmatmul_w8a16, qmatmul_w8a16_mma, qmatmul_w8a16_tc):
        got = launch(x, tw, 0)
        assert torch.equal(got, qmatmul_w8a16_plain(x, tw, 0))
    for launch in (qmatmul_w8a16, qmatmul_w8a16_row):  # one row
        got = launch(x[:1], tw, 0)
        assert torch.equal(got, qmatmul_w8a16_plain(x[:1], tw, 0))
    assert LAUNCHES == before  # plain calls are not launches


@pytest.mark.parametrize("g", [2, 64, 512])
def test_row_max_spb_is_the_longest_split_that_fits(g):
    """The row kernel's split cap at group size ``g``: whole k-slices for each
    of its 8 warps, a block's shared memory within its cap, and no longer
    split of 8 more slices that would fit."""
    spb = row_max_spb(g)
    assert spb % 8 == 0 and 8 <= spb <= port_qmm._ROW_MAX_SPLIT
    assert row_smem_bytes(spb, g) <= port_qmm._ROW_SMEM_CAP
    assert spb == port_qmm._ROW_MAX_SPLIT or row_smem_bytes(spb + 8, g) > port_qmm._ROW_SMEM_CAP


def _8b_shapes():
    c = QWEN3_CONFIGS["8b"]
    ah, kvd = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    return [(c["dim"], ah + 2 * kvd), (ah, c["dim"]), (c["dim"], 2 * c["hidden_dim"]), (c["hidden_dim"], c["dim"])]


def test_route_is_by_rows_alone():
    """Every window of 1-256 rows takes exactly one route, by its rows alone:
    the row kernel below ``MMA_MIN_ROWS`` (one row), the mma kernel up to
    ``TC_MIN_ROWS``, the tensor cores from it on.  The crossovers are module
    constants, in that order, within the rows the mma kernel takes; the
    module reads no environment."""
    assert all(isinstance(c, int) for c in (MMA_MIN_ROWS, TC_MIN_ROWS, MMA_MAX_ROWS))
    assert MMA_MIN_ROWS == 2  # the row kernel takes one row
    assert 1 <= MMA_MIN_ROWS <= TC_MIN_ROWS <= MMA_MAX_ROWS + 1 <= MAX_ROWS
    routes = [route(rows) for rows in range(1, MAX_ROWS + 1)]
    assert routes == (["row"] * (MMA_MIN_ROWS - 1) + ["mma"] * (TC_MIN_ROWS - MMA_MIN_ROWS)
                      + ["tc"] * (MAX_ROWS - TC_MIN_ROWS + 1))
    for rows in (0, MAX_ROWS + 1):
        with pytest.raises(ValueError, match="activation rows"):
            route(rows)
    src = open(port_qmm.__file__).read()
    assert "os.environ" not in src and "getenv" not in src and "import os" not in src


@pytest.mark.parametrize("shape", _8b_shapes() + [(512, 1040), (520, 48), (768, 528), (256, 153600)])
def test_tc_plan_covers_the_contraction(shape):
    """The tensor-core route's plan at every row count 1-256 (the 8B
    projections, ragged D and N, the classifier): the smallest row tile
    that holds the rows, splits that cover the k-tiles with none empty, and
    at most one k-tile per split more than needed."""
    n, d = shape
    k_tiles = -(-n // 64)
    for rows in range(1, MAX_ROWS + 1):
        tile, splits, kts = tc_plan(n, d, rows, 132)
        assert tile == min(t for t in TC_ROW_TILES if t >= rows)
        assert 1 <= splits <= k_tiles and (splits - 1) * kts < k_tiles <= splits * kts
        assert splits == -(-k_tiles // kts)


def test_tc_plan_fills_the_card_at_8b():
    """At 16 and 64 rows (memory-bound) the plan's tiles keep at least 3/4 of
    132 SMs busy on each 8B projection."""
    for n, d in _8b_shapes():
        for rows in (16, 64):
            tile, splits, _ = tc_plan(n, d, rows, 132)
            tiles = -(-d // (256 if tile <= 128 else 128)) * splits
            waves = -(-tiles // 132)
            assert tiles / (waves * 132) >= 0.7, (n, d, rows, tiles)


_CLASSIFIER = (QWEN3_CONFIGS["8b"]["dim"], 153600)  # the 8B classifier, vocabulary padded


@pytest.mark.parametrize("shape", _8b_shapes() + [_CLASSIFIER, (520, 48), (768, 528)])
def test_mma_plan_covers_the_contraction(shape):
    """The mma route's plan at every row count it takes (1-16): the splits
    cover the 16-slot k-slices with none empty, each split whole slices for
    every one of a block's 8 warps and at most 128, and the 8B shapes keep
    at least 90% of the SMs at work over the plan's waves of blocks."""
    n, d = shape
    slices = -(-n // 16)
    for rows in range(1, MMA_MAX_ROWS + 1):
        splits, spb = mma_plan(n, d, rows, 132)
        assert spb % 8 == 0 and spb <= 128 and (splits - 1) * spb < slices <= splits * spb
        blocks = -(-d // 128) * splits
        busy = blocks / (-(-blocks // 132) * 132)  # the SMs' share at work over the waves
        assert busy >= 0.9 or (n, d) not in _8b_shapes() + [_CLASSIFIER], (rows, splits, spb)
    with pytest.raises(ValueError, match="activation rows"):
        mma_plan(n, d, MMA_MAX_ROWS + 1, 132)


def _maps_from_the_threads():
    """The k and column maps that the kernel's per-thread rules give under
    ``mma.sync.m16n8k16``'s fragment layout (PTX ISA).  Lane 4·r8 + t4 loads
    slots 4·t4 + j (j = 0..3) of columns 16·r8 .. 16·r8 + 15; its A register
    e of m-tile mt packs slots 4·t4 + 2·(e>>1) + {0, 1} of column
    16·r8 + 2·mt + (e&1), and the layout puts that register at row
    r8 + 8·(e&1), k 2·t4 + 8·(e>>1) + {0, 1}.  Its B register f packs
    slots 4·t4 + 2·f + {0, 1}, which the layout puts at k 2·t4 + 8·f + {0, 1}.
    Its C register e' (row r8 + 8·(e'>>1)) goes to column 16·r8 + 2·mt + (e'>>1)."""
    a_k, b_k = [None] * 16, [None] * 16
    a_col = [[None] * 16 for _ in range(8)]
    c_col = [[None] * 16 for _ in range(8)]
    for r8 in range(8):
        for t4 in range(4):
            for half in range(2):
                for e in range(4):
                    a_k[2 * t4 + 8 * (e >> 1) + half] = 4 * t4 + 2 * (e >> 1) + half
                    for mt in range(8):
                        a_col[mt][r8 + 8 * (e & 1)] = 16 * r8 + 2 * mt + (e & 1)
                        c_col[mt][r8 + 8 * (e >> 1)] = 16 * r8 + 2 * mt + (e >> 1)
                for f in range(2):
                    b_k[2 * t4 + 8 * f + half] = 4 * t4 + 2 * f + half
    return a_k, b_k, a_col, c_col


def test_mma_maps_are_bijections():
    """The mma kernel's relabellings: the 16 k indices of a slice onto its 16
    slots, thread t's four k indices (2t, 2t+1, 2t+8, 2t+9) onto its four
    loaded rows 4t..4t+3; the 8 m16 tiles' fragment rows onto the warp's 128
    columns, lane group r8's onto its 16 adjacent columns; and the staged
    INT4 slots onto the in-rows, every group's two halves.  The maps are the
    ones the threads' loads, fragments and stores make: the A and B operands
    agree on every k, the stores on every column."""
    a_k, b_k, a_col, c_col = _maps_from_the_threads()
    assert mma_k_slots().tolist() == a_k == b_k
    assert mma_cols().tolist() == a_col == c_col
    k = mma_k_slots()
    assert sorted(k.tolist()) == list(range(16))
    for t in range(4):
        assert sorted(k[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]].tolist()) == list(range(4 * t, 4 * t + 4))
    cols = mma_cols()
    assert sorted(cols.flatten().tolist()) == list(range(128))
    for r8 in range(8):
        assert sorted(cols[:, [r8, r8 + 8]].flatten().tolist()) == list(range(16 * r8, 16 * r8 + 16))
    for n, g in ((512, 32), (512, 64), (1024, 512), (96, 6)):
        rows = mma_slot_rows(n, g, True)
        assert sorted(rows.tolist()) == list(range(n))
        assert torch.equal(mma_slot_rows(n, g, False), torch.arange(n))


def _through_the_maps(x, w, g, q4):
    """x · W taken the way the mma kernel lays it out: per 16-slot k-slice
    and 128-column warp tile, the A operand [8 m-tiles, 16 fragment rows, 16
    k] gathered from the codes and scales through the maps, the B operand
    [16 k, rows] from x through the same k map, the products summed in f32,
    then the columns un-permuted."""
    n, d = w.shape
    rows_of = mma_slot_rows(n, g, q4)
    k_slots, cols = mma_k_slots(), mma_cols()
    xb = x.to(torch.bfloat16).float()
    out = torch.zeros(x.shape[0], d)
    for c0 in range(0, d, 128):
        wcols = c0 + cols  # [8, 16] columns of this warp tile
        valid = wcols < d
        acc = torch.zeros(8, 16, x.shape[0])
        for s0 in range(0, n, 16):
            slots = s0 + k_slots  # [16]: the slot of each k index
            ok = slots < n
            slot = slots.clamp(max=n - 1)
            if q4:
                p, half = slot // 2, slot % 2
                code = ((w.q[p[None, None, :], wcols.clamp(max=d - 1)[..., None]].int() >> (4 * half)) & 15) - 8
                grp = p // (g // 2)
            else:
                code = w.q[slot[None, None, :], wcols.clamp(max=d - 1)[..., None]].int()
                grp = slot // g
            sc = w.scales[grp[None, None, :], wcols.clamp(max=d - 1)[..., None]]
            a = (code.to(torch.bfloat16) * sc).float() * ok  # [8, 16, 16 k]
            b = xb[:, rows_of[slot]].T * ok[:, None]  # [16 k, rows]
            acc += torch.einsum("mrk,kn->mrn", a, b)
        out[:, wcols[valid]] = acc[valid].T
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g", [32, 64, 512])
def test_mma_maps_give_the_plain_product(bits, g):
    """A product taken through the mma kernel's maps equals the plain
    version within f32 rounding (the sums in another order): a wrong
    fragment map would pair a weight with another slot's activation or put a
    result in another column."""
    rng = np.random.default_rng(g + bits)
    n, d, rows = 1024, 272, 5
    codes = rng.integers(-8 if bits == 4 else -127, 8 if bits == 4 else 128, (n, d)).astype(np.int8)
    scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n // g, d)).astype(np.float32)).to(torch.bfloat16)
    w = (Q4Tensor(torch.from_numpy(pack_q4_np(codes, g)), scales) if bits == 4
         else QuantizedTensor(torch.from_numpy(codes), scales))
    x = torch.from_numpy(rng.normal(0, 1, (rows, n)).astype(np.float32))
    got = _through_the_maps(x, w, g, bits == 4)
    ref = qmatmul_w8a16_plain(x, w)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


_ROW_SHAPES = _8b_shapes() + [_CLASSIFIER, (520, 48), (768, 528), (12296, 272), (256, 16)]


@pytest.mark.parametrize("q4", [False, True])
@pytest.mark.parametrize("shape,g", [(s, g) for s in _ROW_SHAPES for g in (8, 32, 64, 128, 512) if s[0] % g == 0])
def test_row_plan_covers_the_contraction(shape, g, q4):
    """The row kernel's plan (the 8B projections and classifier, ragged N
    and D, group sizes 8-512, INT8 and INT4, two and three blocks an SM):
    splits of whole k-slices for each of a block's 8 warps, within the
    split cap and the shared-memory cap; the warps' runs, split by split
    and warp by warp in order, cover every code row of the contraction once
    and in order (split order is the order the strip's last block sums)."""
    n, d = shape
    code_rows = n // 2 if q4 else n
    slices = -(-n // 16)
    for per_sm in (2, 3):
        splits, spb = row_plan(n, d, g, q4, 132, per_sm)
        assert spb % 8 == 0 and 8 <= spb <= row_max_spb(g)
        assert row_smem_bytes(spb, g) <= port_qmm._ROW_SMEM_CAP
        assert (splits - 1) * spb < slices <= splits * spb
        runs = row_runs(n, splits, spb, q4)
        assert len(runs) == splits and all(len(r) == 8 for r in runs)
        walked = [row for split in runs for first, end in split for row in range(first, end)]
        assert walked == list(range(code_rows))


def test_row_plan_fills_the_card_at_8b():
    """At the 8B shapes and the classifier the plan's blocks fill a wave of
    resident blocks (two an SM on 132 SMs) to ``_ROW_WAVE_SHARE`` with the
    fewest splits that do, unless those would spill into a second wave less
    than half full: then the most splits within one wave."""
    wave = 2 * 132
    for n, d in _8b_shapes() + [_CLASSIFIER]:
        for q4 in (False, True):
            splits, spb = row_plan(n, d, 64, q4, 132, 2)
            blocks, strips = -(-d // 128) * splits, -(-d // 128)
            if blocks <= wave:
                assert blocks >= port_qmm._ROW_WAVE_SHARE * wave or strips * (splits + 1) > wave, (n, d, splits)
            else:
                assert blocks >= 1.5 * wave or strips > wave, (n, d, splits)
                assert splits == 1 or strips * (splits - 1) < port_qmm._ROW_WAVE_SHARE * wave, (n, d, splits)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bf16 bit patterns, rounded to nearest even."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_row_kernel_q4_pairs_are_the_plain_weights():
    """The row kernel's INT4 dequantization, emulated bit for bit: for byte k
    of a packed word w, ``byte_perm(w, w >> 4, k | (k + 4) << 8)`` masked with
    0x000F000F and or-ed with 0x43004300 holds 128 + the low nibble in its low
    half and 128 + the high nibble in its high half; ``(t·1 - 136)`` is the
    code exactly, and ``code·s + (-0)`` rounded once is bf16(code·s), the
    plain version's weight, for every byte value, position and scale."""
    rng = np.random.default_rng(3)
    scales = np.concatenate([rng.uniform(1e-3, 2e-2, 64), 2.0 ** rng.integers(-12, 0, 8)]).astype(np.float32)
    s_bits = _bf16_bits(scales)
    for byte in range(256):
        for k in range(4):
            w = np.uint32(byte) << np.uint32(8 * k) | np.uint32(0x5A000000 if k < 3 else 0x5A)
            wb = w >> np.uint32(4)
            a_bytes = [(int(w) >> (8 * i)) & 0xFF for i in range(4)]
            b_bytes = [(int(wb) >> (8 * i)) & 0xFF for i in range(4)]
            perm = a_bytes[k] | (a_bytes[0] << 8) | (b_bytes[k] << 16) | (a_bytes[0] << 24)
            t = (perm & 0x000F000F) | 0x43004300
            lo, hi = _bf16_value(np.uint32(t & 0xFFFF)), _bf16_value(np.uint32(t >> 16))
            assert lo == 128 + (byte & 15) and hi == 128 + (byte >> 4)
            for half, tv in ((0, lo), (1, hi)):
                code = np.float32(tv) - np.float32(136)  # exact: a small integer
                assert code == ((byte >> (4 * half)) & 15) - 8
                got = _bf16_bits(code * _bf16_value(s_bits))  # the exact product, rounded once
                want = torch.tensor(code).to(torch.bfloat16) * torch.from_numpy(_bf16_value(s_bits)).to(torch.bfloat16)
                assert np.array_equal(got, want.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32))


def test_row_kernel_int8_pairs_are_the_plain_weights():
    """The row kernel's INT8 dequantization, emulated bit for bit: a code
    byte r (two's complement) masked to ``(r & 0x7F) | 0x4300`` is 128 + the
    low 7 bits in bf16, its sign masked to ``(r & 0x80) | 0xC300`` is -128
    (r ≥ 0) or -256 (r < 0), ``t·1 + c`` is the code exactly, and
    ``code·s + (-0)`` rounded once is the plain version's weight, for every
    code and scale; ``byte_perm(wa, wb, k | (k + 4) << 8)`` puts byte k of
    wa in the low half and byte k of wb in the high half."""
    rng = np.random.default_rng(5)
    scales = np.concatenate([rng.uniform(1e-3, 2e-2, 64), 2.0 ** rng.integers(-12, 0, 8)]).astype(np.float32)
    sb = torch.from_numpy(_bf16_value(_bf16_bits(scales))).to(torch.bfloat16)
    for byte in range(256):
        code = byte - 256 if byte >= 128 else byte
        t = _bf16_value(np.uint32((byte & 0x7F) | 0x4300))
        c = _bf16_value(np.uint32((byte & 0x80) | 0xC300))
        assert c == (-256.0 if byte & 0x80 else -128.0)
        assert np.float32(t) + np.float32(c) == code  # exact: a small integer
        got = _bf16_bits(np.float32(code) * sb.float().numpy())  # the exact product, rounded once
        want = torch.tensor(float(code)).to(torch.bfloat16) * sb
        assert np.array_equal(got, want.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32))
    for k in range(4):
        wa, wb = 0x11223344, 0xA5B6C7D8
        perm = ((wa >> (8 * k)) & 0xFF) | ((wa & 0xFF) << 8) | (((wb >> (8 * k)) & 0xFF) << 16) | ((wa & 0xFF) << 24)
        assert perm & 0x00FF00FF == ((wa >> (8 * k)) & 0xFF) | (((wb >> (8 * k)) & 0xFF) << 16)


def _through_the_row_kernel(x, w, g, q4, splits, spb):
    """x · W for one row taken the way the row kernel walks it: per split
    and warp (``row_runs``' order), each 16-slot k-slice through the mma
    maps (the A operand from the codes and scales, the B operand's column 0
    from x, the other columns zero), a warp's slices summed in order, the
    warps of a split in warp order, the splits in split order."""
    n, d = w.shape
    rows_of = mma_slot_rows(n, g, q4)
    k_slots, cols = mma_k_slots(), mma_cols()
    xb = x.to(torch.bfloat16).float()[0]
    per_slice = 8 if q4 else 16
    out = torch.zeros(d)
    for c0 in range(0, d, 128):
        wcols = c0 + cols
        valid = wcols < d
        total = torch.zeros(8, 16)
        for split in row_runs(n, splits, spb, q4):
            part = torch.zeros(8, 16)
            for first, end in split:
                acc = torch.zeros(8, 16)
                for s0 in range(first // per_slice * 16, -(-end // per_slice) * 16, 16):
                    slots = s0 + k_slots
                    ok = slots < n
                    slot = slots.clamp(max=n - 1)
                    if q4:
                        p, half = slot // 2, slot % 2
                        code = ((w.q[p[None, None, :], wcols.clamp(max=d - 1)[..., None]].int() >> (4 * half)) & 15) - 8
                        grp = p // (g // 2)
                    else:
                        code = w.q[slot[None, None, :], wcols.clamp(max=d - 1)[..., None]].int()
                        grp = slot // g
                    sc = w.scales[grp[None, None, :], wcols.clamp(max=d - 1)[..., None]]
                    a = (code.to(torch.bfloat16) * sc).float() * ok
                    acc += torch.einsum("mrk,k->mr", a, xb[rows_of[slot]] * ok)
                part += acc
            total += part
        out[wcols[valid]] = total[valid]
    return out[None]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g", [32, 64, 512])
def test_row_kernel_maps_give_the_plain_product(bits, g):
    """A one-row product taken through the row kernel's walk (its plan's
    splits and warp runs, the mma maps) equals the plain version within f32
    rounding: a wrong run would drop or repeat code rows, a wrong map pair a
    weight with another slot's activation."""
    rng = np.random.default_rng(g + 7 * bits)
    n, d = 2048, 272
    codes = rng.integers(-8 if bits == 4 else -127, 8 if bits == 4 else 128, (n, d)).astype(np.int8)
    scales = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n // g, d)).astype(np.float32)).to(torch.bfloat16)
    w = (Q4Tensor(torch.from_numpy(pack_q4_np(codes, g)), scales) if bits == 4
         else QuantizedTensor(torch.from_numpy(codes), scales))
    x = torch.from_numpy(rng.normal(0, 1, (1, n)).astype(np.float32))
    splits, spb = row_plan(n, d, g, bits == 4, 132, 2)
    assert splits > 1  # the walk crosses splits
    got = _through_the_row_kernel(x, w, g, bits == 4, splits, spb)
    ref = qmatmul_w8a16_plain(x, w)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())

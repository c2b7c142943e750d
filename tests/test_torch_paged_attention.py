"""Paged attention: the plain versions of the port's paged decode (#9) and
paged window (#10) kernels against the JAX package's Pallas kernels in
interpret mode, as ``tests/test_paged_attention.py`` runs them, and against
the XLA ``gqa_attention_split_paged``; and the port's plain paged split
attention against the JAX one.

hd 128 and page 128 (the Pallas kernels' tiling); f32, bf16 and INT8 pools;
positions 0, 1, page - 1, page, page + 1 and ragged ones in one batch; page
tables shuffled over the pool.  Every side computes in f32 and differs only
in summation order: tolerance 1e-5 · max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.attention import gqa_attention_split_paged as jax_split_paged
from qwen3_rs_tpu.ops.pallas.paged_attention import paged_gqa_decode_stacked, paged_gqa_window_stacked
from qwen3_rs_tpu_torch.ops.attention import gqa_attention_split_paged
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_window_attention,
    paged_window_partials,
    window_supported,
)

torch.set_num_threads(2)

PAGE, HD, N_KV, L, LAYER = 128, 128, 2, 2, 1
POS = [0, 1, PAGE - 1, PAGE, PAGE + 1, 300]  # one request each


def _pool(rng, dtype, n_pages, hd=HD):
    """(numpy pools and scales for JAX, torch ones for the port): bf16 values
    rounded alike on both sides, INT8 codes with per-row scales."""
    shape = (L, n_pages, N_KV, PAGE, hd)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32) for _ in range(2))
        jax_args = (jnp.asarray(k), jnp.asarray(v)), dict(k_scale_pool=jnp.asarray(ks), v_scale_pool=jnp.asarray(vs))
        port_args = (torch.from_numpy(k), torch.from_numpy(v)), dict(
            k_scale_pool=torch.from_numpy(ks), v_scale_pool=torch.from_numpy(vs))
        return jax_args, port_args
    k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return ((jnp.asarray(k, jdt), jnp.asarray(v, jdt)), {}), (
        (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)), {})


def _table(rng, b, max_pages, n_pages):
    """Shuffled, disjoint page ids over the pool (0 is the null page)."""
    ids = rng.permutation(np.arange(1, n_pages))[: b * max_pages]
    return ids.reshape(b, max_pages).astype(np.int32)


def _case(seed, dtype, pos, kv_mul, hd=HD):
    rng = np.random.default_rng(seed)
    b = len(pos)
    max_pages = 3
    n_pages = 1 + b * max_pages
    (jpool, jsc), (ppool, psc) = _pool(rng, dtype, n_pages, hd)
    table = _table(rng, b, max_pages, n_pages)
    return rng, b, jpool, jsc, ppool, psc, table, np.asarray(pos, np.int32)


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("kv_mul", [1, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_paged_decode_plain_matches_pallas(dtype, kv_mul):
    rng, b, jpool, jsc, ppool, psc, table, pos = _case(7, dtype, POS, kv_mul)
    q = rng.normal(0, 1, (b, N_KV * kv_mul, HD)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (b, N_KV, HD)).astype(np.float32) for _ in range(2))
    before = dict(LAUNCHES)
    got = paged_decode(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *ppool,
                       torch.from_numpy(table), torch.from_numpy(pos), LAYER, **psc)
    assert LAUNCHES == before  # the plain version launches nothing
    args = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpool, jnp.asarray(table), jnp.asarray(pos))
    ref = paged_gqa_decode_stacked(*args, LAYER, interpret=True, **jsc)
    _close(got.numpy(), ref)
    # The XLA split path on the same layer.
    xla_sc = {k: v[LAYER] for k, v in jsc.items()}
    xla = jax_split_paged(jnp.asarray(q)[:, None], jpool[0][LAYER], jpool[1][LAYER], jnp.asarray(table),
                          jnp.asarray(kn)[:, None], jnp.asarray(vn)[:, None], jnp.asarray(pos), **xla_sc)[:, 0]
    _close(got.numpy(), xla)
    # A request at position 0 sees only its own key: the output is v_self.
    assert torch.equal(got[0], torch.from_numpy(vn[0]).repeat_interleave(kv_mul, 0))


@pytest.mark.parametrize("hd", [384, 640])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_paged_decode_plain_matches_pallas_past_256(dtype, hd):
    """As ``test_paged_decode_plain_matches_pallas`` at head_dims the decode
    kernel past 256 takes (three and five of its 128-column warps), 3 query
    heads a kv head (one head tile there): the plain version against the
    Pallas decode kernel in interpret mode; v_self at pos 0."""
    kv_mul = 3
    rng, b, jpool, jsc, ppool, psc, table, pos = _case(29 + hd, dtype, POS, kv_mul, hd)
    q = rng.normal(0, 1, (b, N_KV * kv_mul, hd)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (b, N_KV, hd)).astype(np.float32) for _ in range(2))
    got = paged_decode(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *ppool,
                       torch.from_numpy(table), torch.from_numpy(pos), LAYER, **psc)
    args = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpool, jnp.asarray(table), jnp.asarray(pos))
    _close(got.numpy(), paged_gqa_decode_stacked(*args, LAYER, interpret=True, **jsc))
    assert torch.equal(got[0], torch.from_numpy(vn[0]).repeat_interleave(kv_mul, 0))


@pytest.mark.parametrize("s,kv_mul", [(4, 2), (32, 4), (2, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_paged_window_plain_matches_pallas(dtype, s, kv_mul):
    assert window_supported(s, kv_mul)
    rng, b, jpool, jsc, ppool, psc, table, pos = _case(11, dtype, POS, kv_mul)
    q = rng.normal(0, 1, (b, s, N_KV * kv_mul, HD)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (b, s, N_KV, HD)).astype(np.float32) for _ in range(2))
    got = paged_window_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *ppool,
                                 torch.from_numpy(table), torch.from_numpy(pos), LAYER, **psc)
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpool, jnp.asarray(table), jnp.asarray(pos))
    _close(got.numpy(), paged_gqa_window_stacked(*jargs, LAYER, interpret=True, **jsc))
    xla_sc = {k: v[LAYER] for k, v in jsc.items()}
    xla = jax_split_paged(jnp.asarray(q), jpool[0][LAYER], jpool[1][LAYER], jnp.asarray(table),
                          jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), **xla_sc)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("hd", [384, 640])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_paged_window_plain_matches_pallas_past_256(dtype, hd):
    """As ``test_paged_window_plain_matches_pallas`` at the head_dims the
    window kernel past 256 takes (two column slices at 384, three at 640):
    the plain partials, merged, against the Pallas window kernel in
    interpret mode."""
    s, kv_mul = 4, 2
    rng, b, jpool, jsc, ppool, psc, table, pos = _case(13 + hd, dtype, POS, kv_mul, hd)
    q = rng.normal(0, 1, (b, s, N_KV * kv_mul, hd)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (b, s, N_KV, hd)).astype(np.float32) for _ in range(2))
    got = paged_window_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), *ppool,
                                 torch.from_numpy(table), torch.from_numpy(pos), LAYER, **psc)
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *jpool, jnp.asarray(table), jnp.asarray(pos))
    _close(got.numpy(), paged_gqa_window_stacked(*jargs, LAYER, interpret=True, **jsc))


def test_window_partials_of_an_empty_prefix():
    """pos 0: m = -inf, l = 0, acc = 0 (the reference's guarded partials)."""
    rng, b, _, _, ppool, psc, table, pos = _case(3, "f32", [0, 5], 2)
    q = torch.from_numpy(rng.normal(0, 1, (b, 3, N_KV * 2, HD)).astype(np.float32))
    m, l, acc = paged_window_partials(q, *ppool, torch.from_numpy(table), torch.from_numpy(pos), LAYER)
    assert m.shape == l.shape == (b, N_KV, 6) and acc.shape == (b, N_KV, 6, HD)
    assert bool(torch.isneginf(m[0]).all()) and bool((l[0] == 0).all()) and bool((acc[0] == 0).all())
    assert bool(torch.isfinite(m[1]).all()) and bool((l[1] > 0).all())


@pytest.mark.parametrize("s", [1, 5, 600])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_split_paged_matches_jax(dtype, s):
    """The plain paged split attention (every paged window no kernel takes,
    and the exact and f32 modes): 600 rows run in two query chunks."""
    rng, b, jpool, jsc, ppool, psc, table, pos = _case(5, dtype, [0, 130, 299], 2)
    q = rng.normal(0, 1, (b, s, N_KV * 2, HD)).astype(np.float32)
    kn, vn = (rng.normal(0, 1, (b, s, N_KV, HD)).astype(np.float32) for _ in range(2))
    got = gqa_attention_split_paged(
        torch.from_numpy(q), ppool[0][LAYER], ppool[1][LAYER], torch.from_numpy(table),
        torch.from_numpy(kn), torch.from_numpy(vn), pos, **{k: v[LAYER] for k, v in psc.items()})
    ref = jax_split_paged(jnp.asarray(q), jpool[0][LAYER], jpool[1][LAYER], jnp.asarray(table),
                          jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
                          **{k: v[LAYER] for k, v in jsc.items()})
    _close(got.numpy(), ref)


PLAN_CASES = [
    ([0, 1, 127, 128, 129, 1000, 2049, 4095], 8, 4, 264),  # 8B's serving batch, two blocks an SM
    ([4095], 8, 4, 264),  # one request at the context's end
    ([0, 0, 0], 2, 3, 132),  # idle slots only: one split each, no rows
    ([5000, 17, 300], 2, 12, 132),  # a position past the table, head tiles of 4
    (list(range(0, 64 * 40, 40)), 8, 1, 512),  # more (request, kv head) pairs than SMs
]


@pytest.mark.parametrize("pos,n_kv,kv_mul,grid", PLAN_CASES)
def test_decode_plan_fits_the_grid_and_covers_every_row(pos, n_kv, kv_mul, grid):
    """The one-launch #9 kernel's plan in Python (a card test holds the
    kernel's own plan to it): splits of a 16-row multiple that cover each
    request's live rows, one split for an idle slot, no more units than the
    grid, and the least such span."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import SPLIT_ROWS, decode_grid, decode_plan, decode_qm

    page, max_pages = 128, 32
    tiles = kv_mul // decode_qm(kv_mul)
    grid = max(grid, decode_grid(len(pos), n_kv, kv_mul, 1, 1))
    span, splits = decode_plan(pos, n_kv, kv_mul, page, max_pages, grid)
    live = [min(p, max_pages * page) for p in pos]
    assert span % SPLIT_ROWS == 0 and span >= SPLIT_ROWS
    assert sum(splits) * n_kv * tiles <= grid
    for p, s in zip(live, splits):
        assert s == max(1, -(-p // span)) and (s - 1) * span < max(p, 1)
    if span > SPLIT_ROWS:  # one box less a split would not fit
        smaller = sum(max(1, -(-p // (span - SPLIT_ROWS))) for p in live)
        assert smaller * n_kv * tiles > grid


@pytest.mark.parametrize("pos,n_kv,kv_mul,grid", PLAN_CASES + [(list(range(0, 200 * 20, 20)), 2, 2, 800)])
def test_decode_units_give_each_block_one_split_of_one_pair(pos, n_kv, kv_mul, grid):
    """``decode_units``, the unit each block of the one-launch #9 kernel
    takes (a card test holds the kernel's own plan to it): no more units than
    blocks; each (request, kv head, head tile) once, with its own counter,
    its splits in order on consecutive workspace slots from its slot, their
    rows covering the live rows exactly."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_grid, decode_plan, decode_qm, decode_units

    page, max_pages = 128, 32
    tiles = kv_mul // decode_qm(kv_mul)
    grid = max(grid, decode_grid(len(pos), n_kv, kv_mul, 1, 1))
    span, splits = decode_plan(pos, n_kv, kv_mul, page, max_pages, grid)
    units = decode_units(pos, n_kv, kv_mul, page, max_pages, grid)
    assert len(units) == sum(splits) * n_kv * tiles <= grid
    pairs = {}
    for u, (b, h, tile, s, n_s, lo, hi, slot, pair) in enumerate(units):
        assert slot == u - s and n_s == splits[b] and 0 <= h < n_kv and 0 <= tile < tiles
        assert pair == (b * n_kv + h) * tiles + tile
        pairs.setdefault(pair, []).append((s, lo, hi))
    assert sorted(pairs) == list(range(len(pos) * n_kv * tiles))
    for pair, parts in pairs.items():
        live = min(pos[pair // (n_kv * tiles)], max_pages * page)
        assert [s for s, _, _ in parts] == list(range(len(parts)))
        assert parts[0][1] == 0 and parts[-1][2] == live
        assert all(lo == s * span and lo <= hi for s, lo, hi in parts)
        assert all(parts[i][2] == parts[i + 1][1] for i in range(len(parts) - 1))


def test_decode_grid_and_workspace():
    """The host's share of a one-launch #9 call: the grid (the card's SMs
    times the blocks an SM holds, at least one a request, kv head and head
    tile), the heads a block takes, and the workspaces."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        decode_grid,
        decode_qm,
        decode_workspace_floats,
        split_kernel_takes,
    )

    assert [decode_qm(m) for m in (1, 2, 3, 4, 5, 6, 8, 12, 16)] == [1, 2, 1, 4, 1, 2, 8, 4, 8]
    # Past 256: every query head of a kv head in one tile up to 8 (each K/V row read once).
    assert [decode_qm(m, 640) for m in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16)] == [1, 2, 3, 4, 5, 6, 7, 8, 3, 6, 8]
    assert decode_grid(8, 8, 4, 132, 2) == 264
    assert decode_grid(64, 8, 12, 132, 2) == 64 * 8 * 3
    assert decode_grid(64, 8, 12, 132, 2, 512) == 64 * 8 * 2 and decode_grid(64, 8, 5, 132, 1, 384) == 64 * 8
    assert decode_workspace_floats(264, 4, 128) == (264 * 4 * 2, 264 * 4 * 128)
    assert decode_workspace_floats(132, 5, 640) == (132 * 5 * 2, 132 * 5 * 640)
    assert split_kernel_takes(128, 128) and split_kernel_takes(256, 16)
    assert split_kernel_takes(384, 128) and split_kernel_takes(1024, 16) and not split_kernel_takes(128, 8)
    assert not split_kernel_takes(640, 8) and not split_kernel_takes(1152, 128) and not split_kernel_takes(192, 128)


def test_stamp_phases_reads_a_launch():
    """The one-launch #9 kernel's phase breakdown from its clock stamps: the
    blocks with rows only, each phase's median, the merge of the last blocks
    alone, and the launch's span."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import stamp_phases

    t = 1_000_000
    rows = [
        [t, t + 2000, t + 3000, t + 6000, t + 9000, t + 10000, t + 10300, t + 12000],  # the last block
        [t + 100, t + 2100, t + 3500, t + 6100, t + 8100, t + 9100, t + 9400, 0],
        [t + 50, t + 1800, 0, 0, 0, 0, 0, 0],  # past the last unit: no rows
    ]
    ph = stamp_phases(rows)
    assert ph["blocks"] == 3 and ph["blocks_with_rows"] == 2
    assert ph["plan"] == 2.0 and ph["first_copy"] == 1.2 and ph["first_stage"] == 4.0
    assert ph["stages"] == 2.5 and ph["partial"] == 1.0 and ph["arrive"] == 0.3 and ph["merge"] == 1.7
    assert ph["span"] == 12.0


WINDOW_PLAN_CASES = [
    ([0, 1, 127, 128, 512, 1000, 2049, 4064], 8, 128, 264),  # 8B, S = 32: two row tiles, two blocks an SM
    ([0, 1, 127, 128, 512, 1000, 2049, 4064], 8, 16, 264),  # 8B, S = 4: one tile of 16 rows
    ([0, 0, 0], 2, 64, 132),  # idle slots only: one split each, no rows
    ([5000, 17, 300], 2, 80, 132),  # a position past the table, a tile of 64 and one of 16
    ([512] * 8, 8, 96, 132),  # the prefix cache's windows: every request at one position
    (list(range(0, 200 * 20, 20)), 2, 100, 800),  # more than 128 requests
]


@pytest.mark.parametrize("pos,n_kv,r,grid", WINDOW_PLAN_CASES)
def test_window_units_cover_every_live_row_once_and_fit_the_grid(pos, n_kv, r, grid):
    """``window_units``, the unit each block of the window kernel takes (a
    card test holds the kernel's own plan to it): no more units than
    blocks; each (request, kv head, row tile) once, with its own counter,
    its splits in order on consecutive workspace slots, their rows covering
    the request's live rows exactly once; splits of a 16-row multiple, the
    least span of at least ``WINDOW_MIN_SPAN`` rows that fits."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        SPLIT_ROWS,
        WINDOW_MIN_SPAN,
        WINDOW_ROW_TILE,
        window_grid,
        window_tiles,
        window_units,
    )

    page, max_pages = 128, 32
    tiles = window_tiles(r)
    assert tiles == -(-r // WINDOW_ROW_TILE) and (tiles - 1) * WINDOW_ROW_TILE < r <= tiles * WINDOW_ROW_TILE
    grid = max(grid, window_grid(len(pos), n_kv, r, 1, 1))
    units = window_units(pos, n_kv, r, page, max_pages, grid)
    assert len(units) <= grid
    rows = {}
    for u, (b, h, tile, s, n_s, lo, hi, slot, pair) in enumerate(units):
        assert slot == u - s and 0 <= h < n_kv and 0 <= tile < tiles
        assert pair == (b * n_kv + h) * tiles + tile
        rows.setdefault(pair, []).append((s, n_s, lo, hi))
    assert sorted(rows) == list(range(len(pos) * n_kv * tiles))
    spans = set()
    for pair, parts in rows.items():
        live = min(pos[pair // (n_kv * tiles)], max_pages * page)
        covered = [t for _, _, lo, hi in parts for t in range(lo, hi)]
        assert covered == list(range(live))  # each live row once, in split order
        assert [s for s, _, _, _ in parts] == list(range(len(parts))) and all(n == len(parts) for _, n, _, _ in parts)
        spans |= {hi - lo for _, _, lo, hi in parts[:-1]}
    assert len(spans) <= 1 and all(x % SPLIT_ROWS == 0 and x >= WINDOW_MIN_SPAN for x in spans)
    if spans and spans != {WINDOW_MIN_SPAN}:  # one box less a split would not fit the grid
        smaller = spans.pop() - SPLIT_ROWS
        n = sum(max(1, -(-min(p, max_pages * page) // smaller)) for p in pos)
        assert n * n_kv * tiles > grid


def test_window_route_grid_and_workspace():
    """The window kernel's route (every head_dim a multiple of 128, past 256
    the kernel past 256; pages of a multiple of 16 rows; f32, bf16 and INT8
    pools; the rest keep the two-pass kernels) beside the decode's, which
    takes head_dims up to 1024; its grid and its workspaces."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        split_kernel_takes,
        window_grid,
        window_q_scratch_bytes,
        window_split_takes,
        window_workspace_floats,
    )

    for hd in (128, 256, 384, 512, 640, 1024):
        for page in (8, 16, 128, 200):
            assert split_kernel_takes(hd, page) == (hd <= 1024 and page % 16 == 0)  # #9's decode
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                assert window_split_takes(hd, page, dt) == (page % 16 == 0)
    assert not window_split_takes(192, 128, torch.bfloat16) and not window_split_takes(640, 128, torch.float16)
    assert window_grid(8, 8, 128, 132, 2) == 264 and window_grid(8, 8, 16, 132, 1) == 132
    assert window_grid(64, 8, 128, 132, 1) == 64 * 8 * 2
    assert window_grid(8, 8, 64, 132, 1, 512) == 264 and window_grid(8, 8, 64, 132, 1, 640) == 264
    assert window_grid(64, 8, 64, 132, 1, 640) == 64 * 8 * 3
    assert window_grid(8, 2, 64, 132, 1, 640) == 132  # 48 units: one wave
    assert window_workspace_floats(264, 128) == (264 * 64 * 2, 264 * 64 * 128)
    assert window_q_scratch_bytes(264, 256) == 0 and window_q_scratch_bytes(132, 640) == 132 * 64 * 640 * 4


@pytest.mark.parametrize("kv_mul", [1, 4])
def test_window_tolerance_separates_two_bf16_terms_of_an_f32_pool_from_one(kv_mul):
    """#10's tolerance (1e-4 of each output's largest value) tells the f32
    pool's stage (K and V as bf16 hi + lo, ~2^-16 of each value) from a
    pool rounded to bf16: the plain window over the two-term pool holds it,
    over the one-term pool it misses it."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import bf16_terms, paged_window_partials_plain

    rng, b, _, _, (k, v), _, table, pos = _case(17, "f32", POS, kv_mul)
    q = torch.from_numpy(rng.normal(0, 1, (b, 4, N_KV * kv_mul, HD)).astype(np.float32))
    args = (torch.from_numpy(table), torch.from_numpy(pos), LAYER)
    ref = paged_window_partials_plain(q, k, v, *args)

    def worst(pool_of):
        got = paged_window_partials_plain(q, pool_of(k), pool_of(v), *args)
        ratios = []
        for a, e in zip(got, ref):
            assert torch.equal(torch.isneginf(a), torch.isneginf(e))
            fin = torch.isfinite(e)
            ratios.append(float((a[fin] - e[fin]).abs().max()) / (1e-4 * float(e[fin].abs().max())))
        return max(ratios)

    assert worst(lambda t: sum(x.float() for x in bf16_terms(t, 2))) <= 1.0
    assert worst(lambda t: t.to(torch.bfloat16).float()) > 1.0


@pytest.mark.parametrize("n", [2, 3])
def test_bf16_terms_rebuild_f32(n):
    """q and P split into bf16 terms as the tensor-core stages split them:
    three terms rebuild every f32 value to within 2^-24·|x| (#4's INT8 cache
    at 1e-5), two to within 2^-16·|x| (bf16 and INT8 pools at 1e-4), over
    random values of every scale and edge values."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import bf16_terms

    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(0, 1, 20000) * np.exp2(rng.integers(-60, 60, 20000)),
        rng.uniform(0, 1, 5000),  # probabilities
        [0.0, -0.0, 1.0, -1.0, 1 + 2.0**-23, 1 - 2.0**-24, 2.0**-126, 3.0e38, -3.0e38, 2.0**-100 * 3],
    ]).astype(np.float32)
    xt = torch.from_numpy(x)
    terms = bf16_terms(xt, n)
    assert len(terms) == n and all(t.dtype == torch.bfloat16 for t in terms)
    back = torch.zeros_like(xt, dtype=torch.float64)
    for t in reversed(terms):
        back += t.double()
    err = (back - xt.double()).abs()
    bound = 2.0 ** (-24 if n == 3 else -16) * xt.double().abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("hd,slices", [(128, 1), (256, 1), (384, 2), (512, 2), (640, 3), (1024, 4), (1152, 5)])
def test_window_slices(hd, slices):
    """The window kernel's column slices: the whole head up to 256, else
    256 columns a slice, the last one 128 wide where 256 does not divide."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import WINDOW_WIDE_COLS, window_slices

    assert window_slices(hd) == slices
    widths = [min(WINDOW_WIDE_COLS, hd - c) for c in range(0, hd, WINDOW_WIDE_COLS)] if hd > 256 else [hd]
    assert len(widths) == slices and sum(widths) == hd and all(w in (128, 256) for w in widths)


@pytest.mark.parametrize("pos,n_kv,r,grid", WINDOW_PLAN_CASES)
def test_window_units_past_256_take_every_slice_of_each_row_tile(pos, n_kv, r, grid):
    """At head_dim 640 the plan's tiles are the row tiles times 3 column
    slices (tile t: row tile t // 3, slice t % 3): each (request, kv head,
    row tile, slice) once, with its own counter, its splits covering the
    request's live rows exactly once."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import window_grid, window_tiles, window_units

    page, max_pages, hd = 128, 32, 640
    tiles = window_tiles(r) * 3
    grid = max(grid, window_grid(len(pos), n_kv, r, 1, 1, hd))
    units = window_units(pos, n_kv, r, page, max_pages, grid, hd)
    assert len(units) <= grid
    rows = {}
    for b, h, tile, s, n_s, lo, hi, slot, pair in units:
        assert pair == (b * n_kv + h) * tiles + tile and 0 <= tile < tiles
        rows.setdefault(pair, []).extend(range(lo, hi))
    assert sorted(rows) == list(range(len(pos) * n_kv * tiles))
    for pair, covered in rows.items():
        assert covered == list(range(min(pos[pair // (n_kv * tiles)], max_pages * page)))


@pytest.mark.parametrize("dtype,layout", [
    (torch.bfloat16, dict(rows=64, slots=6, slot_bytes=24576, vstages=2, vstage_bytes=32768, smem=214272)),
    (torch.int8, dict(rows=64, slots=5, slot_bytes=28672, vstages=2, vstage_bytes=17408, smem=212224)),
    (torch.float32, dict(rows=32, slots=4, slot_bytes=32768, vstages=2, vstage_bytes=32768, smem=230656)),
])
def test_window_wide_layout_hand_worked(dtype, layout):
    """The window kernel's shared memory past 256 (``window_wide_layout``, the
    source's ``WideSmem``; a card test holds them equal), worked by hand: a
    slot is q's two 8 KB term bands and the stage's K band of 64 columns
    (bf16: 64 rows of 128 bytes; INT8: 64 of 64 plus an 8 KB bf16 band; f32:
    32 of 256 plus two 4 KB bf16 bands); a V stage the slice's 256 columns
    (INT8: 16 KB plus 512 bytes of row scales, rounded to 17 KB); INT8 and f32
    add a converted V stage of 32 KB; 1,280 bytes of head and alignment; as
    many slots as keep the block within 232,448 bytes (f32: 4 × 32 KB + 64 KB
    + 32 KB + 1,280 = 230,656)."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import window_wide_layout

    assert window_wide_layout(dtype) == layout


@pytest.mark.parametrize("pos,n_kv,kv_mul,grid", PLAN_CASES + [(list(range(0, 200 * 20, 20)), 2, 5, 800)])
def test_decode_units_past_256_take_every_head_of_a_kv_head_at_once(pos, n_kv, kv_mul, grid):
    """At head_dim 640 the plan's head tiles are the largest divisor of
    kv_mul up to 8 (one tile a kv head wherever kv_mul ≤ 8, so each K/V row
    is read once): each (request, kv head, tile) once, with its own counter,
    its splits covering the request's live rows exactly once."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_grid, decode_qm, decode_units

    page, max_pages, hd = 128, 32, 640
    tiles = kv_mul // decode_qm(kv_mul, hd)
    assert tiles == (1 if kv_mul <= 8 else {12: 2}[kv_mul])
    grid = max(grid, decode_grid(len(pos), n_kv, kv_mul, 1, 1, hd))
    units = decode_units(pos, n_kv, kv_mul, page, max_pages, grid, hd)
    assert len(units) <= grid
    rows = {}
    for b, h, tile, s, n_s, lo, hi, slot, pair in units:
        assert pair == (b * n_kv + h) * tiles + tile and 0 <= tile < tiles
        rows.setdefault(pair, []).extend(range(lo, hi))
    assert sorted(rows) == list(range(len(pos) * n_kv * tiles))
    for pair, covered in rows.items():
        assert covered == list(range(min(pos[pair // (n_kv * tiles)], max_pages * page)))


@pytest.mark.parametrize("dtype,hd,layout", [
    (torch.bfloat16, 384, dict(rows=16, warps=3, slots=8, slot_bytes=12288, smem=103424)),
    (torch.bfloat16, 512, dict(rows=16, warps=4, slots=6, slot_bytes=16384, smem=104448)),
    (torch.bfloat16, 640, dict(rows=16, warps=5, slots=5, slot_bytes=20480, smem=109568)),
    (torch.bfloat16, 1024, dict(rows=16, warps=8, slots=3, slot_bytes=32768, smem=108544)),
    (torch.int8, 512, dict(rows=16, warps=4, slots=12, slot_bytes=8192, smem=105216)),
    (torch.float32, 384, dict(rows=16, warps=3, slots=3, slot_bytes=24576, smem=92672)),
    (torch.float32, 512, dict(rows=16, warps=4, slots=2, slot_bytes=32768, smem=90112)),
    (torch.float32, 1024, dict(rows=16, warps=8, slots=2, slot_bytes=65536, smem=178176)),
])
def test_decode_wide_layout_hand_worked(dtype, hd, layout):
    """The decode kernel's shared memory past 256 (``decode_wide_layout``,
    the source's ``dec_wide``; a card test holds them equal), worked by
    hand: hd / 128 warps; a slot is 16 rows of the head (bf16 512: 16 KB);
    before the ring a 1 KB head, two buffers of 128 partial scores a warp
    (bf16 512: 4 KB), for INT8 12 slots' 16 row scales (768 bytes), for f32
    each warp's 16 × 8 probabilities and q's 8 heads (f32 384: 1,536 +
    12,288 bytes), then 1 KB of alignment; as many slots as keep the block
    within 112 KB, 2 to 12 (bf16 512: (114,688 − 5,120 − 1,024) // 16,384 =
    6; INT8 512: 13, capped at 12; f32 1024: 1, raised to 2, so one block
    an SM)."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_wide_layout

    assert decode_wide_layout(dtype, hd) == layout
    assert layout["smem"] <= 232448


def test_decode_wide_layout_refuses_the_whole_row_head_dims():
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_wide_layout

    for hd in (128, 256, 320, 1152):
        with pytest.raises(ValueError, match="head_dim"):
            decode_wide_layout(torch.bfloat16, hd)

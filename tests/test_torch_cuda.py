"""The port's CUDA kernels against their plain versions, on the card, at
small and ragged shapes (the 8B shapes are ``chip_smoke.py``'s).

Marked ``cuda``: without a card every test skips.  It imports neither JAX
nor the repository's conftest, so on a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.inference.engine import Engine
from qwen3_rs_tpu_torch.models.qwen3 import weights_to
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.flash_attention import flash_decode, flash_decode_plain, flash_decode_two_pass
from qwen3_rs_tpu_torch.ops.kernels.megakernel import decode_stack_megakernel, decode_stack_megakernel_plain
from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_decode_plain,
    paged_window_partials,
    paged_window_partials_plain,
)
from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import (
    causal_prefill_attention,
    causal_prefill_attention_plain,
)
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
    dequant_q4_stacked,
    dequant_q4_stacked_plain,
    dequant_w8_stacked,
    dequant_w8_stacked_plain,
    qmatmul_w8a16,
    qmatmul_w8a16_mma,
    qmatmul_w8a16_plain,
    qmatmul_w8a16_row,
    qmatmul_w8a16_rows,
    qmatmul_w8a16_rows_plain,
    qmatmul_w8a16_tc,
    route,
)
from qwen3_rs_tpu_torch.ops.kernels.probes import (
    A8_DEPTH_RTOL,
    HEAD_A8_RTOL,
    a8_depth,
    a8_depth_plain,
    boundary_onecall,
    boundary_onecall_plain,
    boundary_onecall_walk,
    hbm_stream,
    hbm_stream_plain,
    head_a8,
    head_a8_plain,
    onecall_plan,
    onecall_walk,
)
from qwen3_rs_tpu_torch.ops.kernels.qmatmul_a8 import qmatmul_w8a8_rows, qmatmul_w8a8_rows_plain
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor, QuantizedTensor, quantize_activations
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request
from qwen3_rs_tpu_torch.testing import random_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


ROUTE_KEYS = {"row": "qmatmul_w8a16", "mma": "qmatmul_w8a16_mma", "tc": "qmatmul_w8a16_tc"}


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 9, 37, 256])
@pytest.mark.parametrize(
    "n,d,g,prologue,residual",
    [
        (256, 48, 64, None, None),  # D below one 512-column strip
        (512, 1040, 16, "rms", None),  # ragged last strip, g = 16
        (1024, 512, 64, "swiglu", "bf16"),
        (4096, 4096, 64, None, "f32"),  # split contraction + residual added once
        (256, 512, 2, None, None),  # g = 2: every code row starts a group
        (768, 512, 6, "rms", None),  # g = 6: groups straddle the rows in flight
    ],
)
def test_qmatmul_matches_plain(card, rows, n, d, g, prologue, residual):
    gen = _gen(rows * 7 + d)
    layers = 3
    codes = torch.randint(-127, 128, (layers, n, d), generator=gen, device=card, dtype=torch.int8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=card) * 0.02).to(torch.bfloat16)
    w = QuantizedTensor(codes, scales)
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(rows, width, generator=gen, device=card)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(layers, n, generator=gen, device=card)
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(rows, d, generator=gen, device=card).to(dt)
    key = ROUTE_KEYS[route(rows)]
    before = LAUNCHES[key]
    got = qmatmul_w8a16(x, w, 2, **kw)
    assert LAUNCHES[key] == before + 1
    ref = qmatmul_w8a16_plain(x, w, 2, **kw)
    torch.cuda.synchronize()
    # f32 sums in another order; a prologue may flip a bf16 rounding.
    rel = 2e-3 if prologue else 1e-4
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


ROUTE_SHAPES = [  # (N, D, g, prologue, residual) for the tensor-core route, INT8 and INT4
    (256, 48, 64, None, None),  # D below one tile
    (512, 1040, 64, "rms", "bf16"),  # ragged last tile
    (1024, 512, 2, "swiglu", "f32"),  # g = 2: every code row its own group
    (768, 528, 6, "rms", None),  # g = 6: groups straddle the k-steps; ragged D
    (1024, 512, 512, None, "f32"),  # g = 512: a group spans eight k-tiles
    (4096, 1024, 64, "swiglu", "bf16"),  # a split contraction, the residual added in the reduce
    (520, 256, 8, None, None),  # N not a multiple of 64: a ragged last k-tile
]


@pytest.mark.parametrize("launch", [qmatmul_w8a16_tc], ids=["tc"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [8, 9, 16, 37, 64, 255, 256])
@pytest.mark.parametrize("n,d,g,prologue,residual", ROUTE_SHAPES)
def test_qmatmul_routes_match_plain(card, launch, bits, rows, n, d, g, prologue, residual):
    """The tensor-core route of #3, forced by calling its launcher, at rows on
    both sides of its crossover.  Tolerance: the f32 sums differ in order (and the
    tensor cores' round toward zero), 1e-4 of the largest output; a
    prologue's f32 result may flip a bf16 rounding of an activation, 2e-3."""
    gen = _gen(rows * 13 + d + g + bits)
    w = _q4_weights(gen, card, 2, n, d, g) if bits == 4 else _weights(gen, card, 2, n, d, g)
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(rows, width, generator=gen, device=card).to(torch.bfloat16 if rows % 2 else torch.float32)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(2, n, generator=gen, device=card)
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(rows, d, generator=gen, device=card).to(dt)
    key = "qmatmul_w8a16_tc" + ("_q4" if bits == 4 else "")
    before = dict(LAUNCHES)
    got = launch(x, w, 1, **kw)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {key: 1}
    ref = qmatmul_w8a16_plain(x, w, 1, **kw)
    torch.cuda.synchronize()
    rel = 2e-3 if prologue else 1e-4
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


MMA_SHAPES = [  # (N, D, g, prologue, residual, stacked) for the mma route, INT8 and INT4
    (256, 48, 32, None, None, True),  # D below one warp's 128 columns
    (512, 1040, 64, "rms", "bf16", True),  # ragged last block of columns
    (1024, 528, 128, "swiglu", "f32", True),  # ragged D, g = 128
    (1024, 512, 512, "rms", "f32", True),  # g = 512: a group spans 32 k-slices
    (4096, 1024, 64, "swiglu", "bf16", True),  # a split contraction, the residual added in the reduce
    (520, 256, 40, None, "f32", False),  # N % 16 == 8: a ragged last k-slice; 2-D weights, g = 40
    (8192, 4096, 64, None, None, False),  # 2-D, several k-warps per block and splits
    (768, 64, 6, "rms", None, True),  # g = 6: a thread's four slots straddle two groups
]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", list(range(1, 17)))
@pytest.mark.parametrize("n,d,g,prologue,residual,stacked", MMA_SHAPES)
def test_qmatmul_mma_matches_plain(card, bits, rows, n, d, g, prologue, residual, stacked):
    """#1-#3's mma route at every row count it takes (1-16: one and two n8
    tiles), forced by calling its launcher: ragged N and D, every prologue,
    with and without residual, stacked and 2-D weights, INT8 and INT4, group
    sizes from 6 to 512.  Tolerance as on the other routes: 1e-4 of the
    largest output (the tensor cores' f32 sums in another order), 2e-3 where
    a prologue's f32 result may flip an activation's bf16 rounding."""
    gen = _gen(rows * 19 + d + g + bits)
    w = _q4_weights(gen, card, 2, n, d, g) if bits == 4 else _weights(gen, card, 2, n, d, g)
    layer = 1
    if not stacked:
        w, layer = type(w)(w.q[1].contiguous(), w.scales[1].contiguous()), None
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(rows, width, generator=gen, device=card).to(torch.bfloat16 if rows % 2 else torch.float32)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(2, n, generator=gen, device=card)
        if not stacked:
            kw["norm_w"] = kw["norm_w"][1].contiguous()
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(rows, d, generator=gen, device=card).to(dt)
    key = "qmatmul_w8a16_mma" + ("_q4" if bits == 4 else "")
    before = dict(LAUNCHES)
    got = qmatmul_w8a16_mma(x, w, layer, **kw)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {key: 1}
    ref = qmatmul_w8a16_plain(x, w, layer, **kw)
    torch.cuda.synchronize()
    rel = 2e-3 if prologue else 1e-4
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


ROW_SHAPES = [  # (N, D, g, prologue, residual, stacked) for the row kernel, INT8 and INT4
    (256, 48, 32, None, None, True),  # D below one block's 128 columns
    (512, 1040, 64, "rms", "bf16", True),  # ragged last block of columns
    (1024, 528, 128, "swiglu", "f32", True),  # ragged D, g = 128
    (1024, 512, 512, "rms", "f32", True),  # g = 512: a group spans 32 k-slices
    (4096, 1024, 64, "swiglu", "bf16", True),  # a split contraction, the residual added by the last block
    (520, 256, 40, None, "f32", False),  # N % 16 == 8: a ragged last k-slice; 2-D weights, g = 40
    (12296, 272, 8, "rms", None, True),  # N not a multiple of the split, g = 8: many groups a block
    (768, 64, 6, "rms", None, True),  # g = 6: a thread's four slots straddle two groups
    (8192, 4096, 64, None, "bf16", False),  # 2-D, long runs, splits
    (4096, 512, 2, "rms", "f32", True),  # g = 2: a short split cap, eleven splits
]


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n,d,g,prologue,residual,stacked", ROW_SHAPES)
def test_qmatmul_row_matches_plain(card, bits, xdt, n, d, g, prologue, residual, stacked):
    """#1-#3's one-row route, one launch of the row kernel: ragged N and D,
    every prologue and residual type, stacked and 2-D weights, INT8 and INT4,
    group sizes from 6 to 512, f32 and bf16 activations.  Tolerance as on the
    other routes: 1e-4 of the largest output (the tensor cores' f32 sums in
    another order), 2e-3 where a prologue's f32 result may flip an
    activation's bf16 rounding."""
    gen = _gen(n + d + g + bits + len(xdt))
    w = _q4_weights(gen, card, 2, n, d, g) if bits == 4 else _weights(gen, card, 2, n, d, g)
    layer = 1
    if not stacked:
        w, layer = type(w)(w.q[1].contiguous(), w.scales[1].contiguous()), None
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(1, width, generator=gen, device=card).to(torch.float32 if xdt == "f32" else torch.bfloat16)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(2, n, generator=gen, device=card)
        if not stacked:
            kw["norm_w"] = kw["norm_w"][1].contiguous()
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(1, d, generator=gen, device=card).to(dt)
    key = "qmatmul_w8a16" + ("_q4" if bits == 4 else "")
    before = dict(LAUNCHES)
    got = qmatmul_w8a16(x, w, layer, **kw)  # the route at one row
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {key: 1}
    ref = qmatmul_w8a16_plain(x, w, layer, **kw)
    torch.cuda.synchronize()
    rel = 2e-3 if prologue else 1e-4
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g", [64, 2])
def test_qmatmul_row_repeats_and_leaves_its_counters_zero(card, bits, g):
    """Two launches of the row kernel in a row give the same bytes (the
    splits summed in split order by the strip's last block: the 8B wo's
    eight splits, and more at g = 2), the split counters read zero after
    each, and a CUDA graph's replay gives the same output."""
    from qwen3_rs_tpu_torch.ops.kernels import qmatmul as qm

    gen = _gen(41 + bits + g)
    n, d = 4096, 4096 if g == 64 else 512
    splits, _ = qm.row_plan(n, d, g, bits == 4, qm._sm_count(0),
                            qm._row_blocks_per_sm(0, bits == 4, (g // 2) % 2 == 0 if bits == 4 else g % 4 == 0))
    assert splits >= 8
    w = _q4_weights(gen, card, 2, n, d, g) if bits == 4 else _weights(gen, card, 2, n, d, g)
    x = torch.randn(1, n, generator=gen, device=card)
    res = torch.randn(1, d, generator=gen, device=card)
    outs = []
    for _ in range(2):
        outs.append(qmatmul_w8a16_row(x, w, 1, residual=res))
        torch.cuda.synchronize()
        assert all(int(t.abs().sum()) == 0 for t in qm._MMA_COUNTERS.values())
    assert torch.equal(outs[0], outs[1])
    out = {}
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        qmatmul_w8a16_row(x, w, 1, residual=res)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out["x"] = qmatmul_w8a16_row(x, w, 1, residual=res)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["x"], outs[0])
    assert all(int(t.abs().sum()) == 0 for t in qm._MMA_COUNTERS.values())
    with pytest.raises(ValueError, match="one activation row"):
        qmatmul_w8a16_row(torch.randn(2, n, device=card), w, 1)


@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_routes_are_deterministic(card, bits):
    """Two launches of each route give the same bytes (the split contraction
    is summed in split order, with no atomics), and the row-blocked kernel's
    too."""
    gen = _gen(31 + bits)
    n, d = 4096, 1024
    w = _q4_weights(gen, card, 2, n, d, 64) if bits == 4 else _weights(gen, card, 2, n, d, 64)
    for rows, launch in ((1, qmatmul_w8a16_row), (4, qmatmul_w8a16_mma), (16, qmatmul_w8a16_mma),
                         (37, qmatmul_w8a16_tc), (256, qmatmul_w8a16_tc), (300, qmatmul_w8a16_rows)):
        x = torch.randn(rows, n, generator=gen, device=card).to(torch.bfloat16)
        a, b = launch(x, w, 1), launch(x, w, 1)
        torch.cuda.synchronize()
        assert torch.equal(a, b), (rows, launch.__name__)


def test_qmatmul_unstacked_classifier_shape(card):
    gen = _gen(5)
    n, d = 256, 4096
    w = QuantizedTensor(
        torch.randint(-127, 128, (n, d), generator=gen, device=card, dtype=torch.int8),
        (torch.rand(n // 64, d, generator=gen, device=card) * 0.02).to(torch.bfloat16),
    )
    x = torch.randn(1, n, generator=gen, device=card).to(torch.bfloat16)
    got, ref = qmatmul_w8a16(x, w), qmatmul_w8a16_plain(x, w)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_qmatmul_refuses_what_it_cannot_take(card):
    w = QuantizedTensor(
        torch.zeros(2, 128, 64, dtype=torch.int8, device=card),
        torch.ones(2, 2, 64, dtype=torch.bfloat16, device=card),
    )
    with pytest.raises(ValueError, match="activation rows"):
        qmatmul_w8a16(torch.zeros(257, 128, device=card), w, 0)
    with pytest.raises(ValueError, match="bf16"):
        qmatmul_w8a16(torch.zeros(1, 128, device=card), QuantizedTensor(w.q, w.scales.float()), 0)


def _flash_decode_holds(card, cache, kv_mul, t, seed):
    """#4 against its plain version at 1e-5 over B = 6 rows at pos
    0/1/127/128/129/T of a T-row cache, one launch counted; pos 0 returns
    v_self."""
    gen = _gen(seed)
    layers, n_kv, hd = 2, 2, 128
    pos_list = [0, 1, 127, 128, 129, t]
    b = len(pos_list)
    shape = (layers, b, n_kv, t, hd)
    sc = {}
    if cache == "int8":
        k_all = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        v_all = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        sc = {name: torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005
              for name in ("k_scale_all", "v_scale_all")}
    else:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        k_all = torch.randn(shape, generator=gen, device=card).to(dt)
        v_all = torch.randn(shape, generator=gen, device=card).to(dt)
    q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
    kn = torch.randn(b, n_kv, hd, generator=gen, device=card)
    vn = torch.randn(b, n_kv, hd, generator=gen, device=card)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    before = LAUNCHES["flash_decode"]
    got = flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
    assert LAUNCHES["flash_decode"] == before + 1
    ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0))  # pos 0: v_self


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 3, 4, 5, 6, 8, 16])
def test_flash_decode_matches_plain(card, cache, kv_mul):
    """T = 200, not a multiple of the two-pass kernel's 128-row chunk nor of
    16: the two-pass kernel."""
    _flash_decode_holds(card, cache, kv_mul, 200, kv_mul * 3 + len(cache))


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 3, 4, 5, 6, 8, 16])
def test_flash_decode_one_launch_matches_plain(card, cache, kv_mul):
    """T = 208, a multiple of 16: the one-launch kernel for every cache type
    (an INT8 cache's stage with q and P in three bf16 terms), at 1e-5."""
    _flash_decode_holds(card, cache, kv_mul, 208, kv_mul * 3 + len(cache) + 208)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [128, 256])
def test_flash_decode_is_one_launch_where_it_takes_the_split_kernel(card, monkeypatch, cache, hd):
    """At head_dim 128/256 over an f32, bf16 or INT8 cache of a multiple of 16 rows
    a call is one kernel on the card: one launch of the one-launch decode
    kernel (``_one_launch_spy``) and one count under ``LAUNCHES["flash_decode"]``,
    held at 1e-5 against the plain version and against the two-pass kernel on the
    same inputs, at B = 1 and B = 3 with pos 0/1/127/128/129/T across the rows."""
    gen = _gen(hd + len(cache))
    t, n_kv, kv_mul = 512, 2, 4
    for pos_list in ([t - 1], [0, 1, 127], [128, 129, t]):
        b = len(pos_list)
        k_all, v_all, sc = _dense_cache(gen, card, cache, (2, b, n_kv, t, hd))
        q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
        kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=card)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
        flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)  # built and planned before the count
        torch.cuda.synchronize()
        grids = _one_launch_spy(monkeypatch)
        before = dict(LAUNCHES)
        got = flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        assert len(grids) == 1 and launched == {"flash_decode": 1}, (grids, launched)
        monkeypatch.undo()
        ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
        two = flash_decode_two_pass(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5, pos_list
        assert float((got - two).abs().max()) <= 1e-5, pos_list
        for i, p in enumerate(pos_list):
            if p == 0:
                assert torch.equal(got[i], vn[i].repeat_interleave(kv_mul, dim=0))


def _dense_cache(gen, card, cache, shape):
    """A dense cache [L, B, n_kv, T, hd] of random rows (INT8: codes and row
    scales)."""
    if cache == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8) for _ in range(2))
        return k, v, {name: torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005
                      for name in ("k_scale_all", "v_scale_all")}
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    return (*(torch.randn(shape, generator=gen, device=card).to(dt) for _ in range(2)), {})


def test_flash_decode_counters_stay_zero_and_repeat(card):
    """Two calls of the one-launch route give the same bytes, its arrival
    counters read zero after each, and a CUDA graph's replay gives the
    same output."""
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    gen = _gen(99)
    k_all, v_all, _ = _dense_cache(gen, card, "f32", (2, 1, 8, 4096, 128))
    q = torch.randn(1, 32, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, 1, 8, 128, generator=gen, device=card)
    pos = torch.tensor([4095], dtype=torch.int32, device=card)
    first = flash_decode(q, kn, vn, k_all, v_all, pos, 1)
    torch.cuda.synchronize()
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0
    again = flash_decode(q, kn, vn, k_all, v_all, pos, 1)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0
    out = {}
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        flash_decode(q, kn, vn, k_all, v_all, pos, 1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out["x"] = flash_decode(q, kn, vn, k_all, v_all, pos, 1)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["x"], first)
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0


def _flash_decode_reads_below_pos(card, t):
    """NaN in every cache row at or past pos leaves the output finite."""
    gen = _gen(11)
    shape = (1, 3, 2, t, 128)
    k_all = torch.randn(shape, generator=gen, device=card)
    v_all = torch.randn(shape, generator=gen, device=card)
    pos_list = [0, 5, 260]
    for b, p in enumerate(pos_list):
        k_all[:, b, :, p:] = float("nan")
        v_all[:, b, :, p:] = float("nan")
    q = torch.randn(3, 8, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, 3, 2, 128, generator=gen, device=card)
    out = flash_decode(q, kn, vn, k_all, v_all, torch.tensor(pos_list, dtype=torch.int32, device=card), 0)
    assert bool(torch.isfinite(out).all())


def test_flash_decode_reads_no_row_at_or_past_pos(card):
    _flash_decode_reads_below_pos(card, 300)  # the two-pass kernel


def test_flash_decode_one_launch_reads_no_row_at_or_past_pos(card):
    _flash_decode_reads_below_pos(card, 304)  # the one-launch kernel


def test_small_model_card_matches_cpu(card):
    cfg = ModelConfig(
        architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, seq_len=300, vocab_size=2176, group_size=64, shared_classifier=True,
    )
    weights = random_weights(cfg, seed=3, device=card)
    gpu = Engine(config=cfg, weights=weights, device=card)
    cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 40))
    caches = [gpu.new_cache(), cpu.new_cache()]
    lg, caches[0] = gpu.prefill(caches[0], prompt, [0])
    lc, caches[1] = cpu.prefill(caches[1], prompt, [0])
    for step in range(6):
        a, b = lg.float().cpu(), lc.float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max()), step
        tok = [int(b.argmax())]
        lg, caches[0] = gpu.decode_step(caches[0], tok, [40 + step])
        lc, caches[1] = cpu.decode_step(caches[1], tok, [40 + step])


def _weights(gen, card, layers, n, d, g, scale_dtype=torch.bfloat16):
    codes = torch.randint(-127, 128, (layers, n, d), generator=gen, device=card, dtype=torch.int8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=card) * 0.02 + 1e-3).to(scale_dtype)
    return QuantizedTensor(codes, scales)


@pytest.mark.parametrize("rows", [1, 100, 257, 300, 1000, 2048])
@pytest.mark.parametrize(
    "n,d,g,scale_dtype",
    [(256, 48, 64, torch.bfloat16), (512, 1040, 64, torch.float32), (1024, 384, 32, torch.bfloat16),
     (768, 272, 6, torch.bfloat16)],
)
def test_qmatmul_rows_matches_plain(card, rows, n, d, g, scale_dtype):
    gen = _gen(rows + d)
    w = _weights(gen, card, 2, n, d, g, scale_dtype)
    x = torch.randn(rows, n, generator=gen, device=card).to(torch.bfloat16)
    before = LAUNCHES["qmatmul_w8a16_rows"]
    got = qmatmul_w8a16_rows(x, w, 1)
    assert LAUNCHES["qmatmul_w8a16_rows"] == before + 1
    ref = qmatmul_w8a16_rows_plain(x, w, 1)
    torch.cuda.synchronize()
    # Same bf16 products on both sides; the f32 sums differ in order.
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,g", [(64, 16, 64), (512, 1040, 64), (4096, 96, 32)])
def test_dequant_matches_plain_bit_exact(card, scale_dtype, n, d, g):
    w = _weights(_gen(n + d), card, 3, n, d, g, scale_dtype)
    got = dequant_w8_stacked(w, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, dequant_w8_stacked_plain(w, 2))


# ------------------------------------------------------------------- INT4
def _q4_weights(gen, card, layers, n, d, g, scale_dtype=torch.bfloat16):
    """Random packed bytes (every nibble value, code -8 included) and scales."""
    packed = torch.randint(0, 256, (layers, n // 2, d), generator=gen, device=card, dtype=torch.uint8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=card) * 0.02 + 1e-3).to(scale_dtype)
    return Q4Tensor(packed, scales)


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 9, 37, 256])
@pytest.mark.parametrize(
    "n,d,g,prologue,residual",
    [
        (256, 48, 64, None, None),  # D below one 512-column strip
        (512, 1040, 16, "rms", None),  # ragged last strip, g = 16
        (1024, 512, 64, "swiglu", "bf16"),
        (4096, 4096, 64, None, "f32"),  # split contraction + residual added once
        (768, 512, 128, "rms", "f32"),  # g = 128
        (640, 64, 8, None, None),  # g = 8: 4 packed rows per half-group
        (1024, 512, 512, "rms", "f32"),  # g = 512: a group spans two staged tiles
        (768, 64, 6, None, None),  # g = 6: half-groups straddle the rows in flight
        (512, 256, 2, "swiglu", None),  # g = 2: one packed row per group
    ],
)
def test_qmatmul_q4_matches_plain(card, rows, n, d, g, prologue, residual):
    gen = _gen(rows * 11 + d + g)
    w = _q4_weights(gen, card, 3, n, d, g)
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(rows, width, generator=gen, device=card)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(3, n, generator=gen, device=card)
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(rows, d, generator=gen, device=card).to(dt)
    before = dict(LAUNCHES)
    got = qmatmul_w8a16(x, w, 2, **kw)
    key = ROUTE_KEYS[route(rows)] + "_q4"
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {key: 1}
    ref = qmatmul_w8a16_plain(x, w, 2, **kw)
    torch.cuda.synchronize()
    rel = 2e-3 if prologue else 1e-4  # as for INT8
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


def test_q4_kernels_place_every_nibble(card):
    """One-hot activation rows pick single weight rows: the fused and the
    row-blocked Q4 kernels give each row of the Q4 dequant exactly (sums of
    one nonzero term), over packed bytes that hold every nibble value."""
    gen = _gen(77)
    n, d, g = 512, 160, 64
    w = _q4_weights(gen, card, 2, n, d, g)
    dense = dequant_q4_stacked(w, 1).float()
    assert torch.equal(dense.to(torch.bfloat16), dequant_q4_stacked_plain(w, 1))
    idx = torch.tensor([0, 1, 31, 32, 33, 63, 64, 95, 96, 127, 300, 511], device=card)
    x = torch.zeros(len(idx), n, device=card)
    x[torch.arange(len(idx), device=card), idx] = 1.0
    assert torch.equal(qmatmul_w8a16(x, w, 1), dense[idx])
    for i in range(len(idx)):  # one row at a time: the row kernel
        assert torch.equal(qmatmul_w8a16(x[i : i + 1], w, 1), dense[idx[i : i + 1]])
    xr = torch.zeros(300, n, device=card, dtype=torch.bfloat16)
    rows = torch.arange(300, device=card) % n
    xr[torch.arange(300, device=card), rows] = 1.0
    assert torch.equal(qmatmul_w8a16_rows(xr, w, 1), dense[rows])
    codes = dense / w.scales[1].float().repeat_interleave(g, 0)
    assert set(codes.round().unique().int().tolist()) == set(range(-8, 8))


def test_qmatmul_q4_unstacked(card):
    gen = _gen(6)
    w = _q4_weights(gen, card, 1, 256, 4096, 64)
    w = Q4Tensor(w.q[0], w.scales[0])
    x = torch.randn(1, 256, generator=gen, device=card).to(torch.bfloat16)
    got, ref = qmatmul_w8a16(x, w), qmatmul_w8a16_plain(x, w)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("rows", [1, 100, 257, 300, 1000, 2048])
@pytest.mark.parametrize(
    "n,d,g,scale_dtype",
    [(256, 48, 64, torch.bfloat16), (512, 1040, 64, torch.float32), (1024, 384, 32, torch.bfloat16),
     (512, 256, 16, torch.bfloat16), (1024, 128, 128, torch.float32), (768, 256, 6, torch.bfloat16),
     (512, 128, 2, torch.bfloat16), (1024, 128, 512, torch.float32), (768, 256, 24, torch.bfloat16)],
)
def test_qmatmul_rows_q4_matches_plain(card, rows, n, d, g, scale_dtype):
    gen = _gen(rows + d + 5)
    w = _q4_weights(gen, card, 2, n, d, g, scale_dtype)
    x = torch.randn(rows, n, generator=gen, device=card).to(torch.bfloat16)
    before = LAUNCHES["qmatmul_w8a16_rows_q4"]
    got = qmatmul_w8a16_rows(x, w, 1)
    assert LAUNCHES["qmatmul_w8a16_rows_q4"] == before + 1
    ref = qmatmul_w8a16_rows_plain(x, w, 1)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,g", [(64, 16, 64), (512, 1040, 64), (4096, 96, 32), (128, 48, 2)])
def test_dequant_q4_matches_plain_bit_exact(card, scale_dtype, n, d, g):
    w = _q4_weights(_gen(n + d + 9), card, 3, n, d, g, scale_dtype)
    before = LAUNCHES["dequant_q4_stacked"]
    got = dequant_q4_stacked(w, 2)
    assert LAUNCHES["dequant_q4_stacked"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, dequant_q4_stacked_plain(w, 2))


def test_q4_wrappers_refuse_what_they_cannot_take(card):
    w = _q4_weights(_gen(1), card, 2, 256, 64, 64)
    with pytest.raises(ValueError, match="dequant_q4_stacked"):
        dequant_w8_stacked(w, 0)
    odd = Q4Tensor(w.q[:1, :96], torch.ones(1, 64, 64, dtype=torch.bfloat16, device=card))  # 3-row groups
    with pytest.raises(ValueError, match="INT4 group size 3 must be even"):
        qmatmul_w8a16(torch.zeros(1, 192, device=card), odd, 0)
    with pytest.raises(ValueError, match="codes must be contiguous"):
        qmatmul_w8a16(torch.zeros(1, 256, device=card), Q4Tensor(w.q.to(torch.int8), w.scales), 0)


def test_int4_model_card_matches_cpu(card, monkeypatch):
    """INT4 linear layers: a fresh 600-row window (the Q4 row-blocked kernel;
    w2 through the Q4 dequant, the xdot gate lowered), a 300-row
    continuation, decode steps (the fused Q4 kernel, never the megakernel);
    exact mode raises."""
    monkeypatch.setattr(port_qwen3, "_XDOT_PREFILL_MIN_ROWS", 600)
    monkeypatch.setattr(port_qwen3, "_XDOT_MIN_WEIGHT_ELEMS", 0)
    cfg = ModelConfig(
        architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, seq_len=1024, vocab_size=2176, group_size=64, shared_classifier=True, weight_bits=4,
    )
    weights = random_weights(cfg, seed=5, device=card, bits=4)
    gpu = Engine(config=cfg, weights=weights, device=card)
    cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")
    rng = np.random.default_rng(2)
    caches = [gpu.new_cache(), cpu.new_cache()]
    before = dict(LAUNCHES)
    pos = 0
    for s in (600, 300):
        prompt = rng.integers(0, cfg.vocab_size, (1, s))
        lg, caches[0] = gpu.prefill(caches[0], prompt, [pos])
        lc, caches[1] = cpu.prefill(caches[1], prompt, [pos])
        pos += s
    for step in range(3):
        a, b = lg.float().cpu(), lc.float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max()), step
        tok = [int(b.argmax())]
        lg, caches[0] = gpu.decode_step(caches[0], tok, [pos + step])
        lc, caches[1] = cpu.decode_step(caches[1], tok, [pos + step])
    made = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    n = cfg.n_layers
    assert made == {"qmatmul_w8a16_rows_q4": 4 * n + 3 * n, "dequant_q4_stacked": n,
                    "qmatmul_w8a16_q4": 3 * 4 * n, "qmatmul_w8a16": 2 + 3,
                    "causal_prefill_attention": n, "flash_decode": 3 * n}, made
    with pytest.raises(ValueError, match="INT4 weights have no reference-exact"):
        exact = Engine(config=cfg, weights=weights, mode="exact", device=card)
        exact.prefill(exact.new_cache(), np.zeros((1, 8), np.int64), [0])


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 300, 1000, 2048])
@pytest.mark.parametrize(
    "n,d,g",
    [(256, 48, 64), (512, 1040, 64), (1024, 384, 32), (512, 256, 128), (1024, 1040, 256), (192, 144, 64)],
)
def test_qmatmul_a8_matches_plain_bit_exact(card, rows, n, d, g):
    gen = _gen(rows * 3 + d)
    w = _weights(gen, card, 2, n, d, g, torch.float32)
    xq = quantize_activations(torch.randn(rows, n, generator=gen, device=card), g)
    got = qmatmul_w8a8_rows(xq.q, xq.scales, w, 1)
    ref = qmatmul_w8a8_rows_plain(xq.q, xq.scales, w, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("g", [32, 64, 128, 256])
def test_qmatmul_a8_extreme_codes_bit_exact(card, g):
    """Every code -128 on both sides: each group's dot reaches 128·128·g, its
    largest value (2^21 at g = 128, the conversion for free's edge; 2^22 at
    256 on the int-to-float path)."""
    gen = _gen(g)
    n, d, rows = 1024, 272, 300
    codes = torch.full((2, n, d), -128, dtype=torch.int8, device=card)
    scales = torch.rand(2, n // g, d, generator=gen, device=card) * 0.02 + 1e-3
    w = QuantizedTensor(codes, scales)
    xq = torch.full((rows, n), -128, dtype=torch.int8, device=card)
    xs = torch.rand(rows, n // g, generator=gen, device=card) * 0.05 + 1e-3
    got = qmatmul_w8a8_rows(xq, xs, w, 1)
    ref = qmatmul_w8a8_rows_plain(xq, xs, w, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 200, 257, 1000])
@pytest.mark.parametrize("kv_mul", [1, 2, 3, 4, 5, 6, 8, 12])
def test_prefill_attention_matches_plain(card, s, kv_mul):
    gen = _gen(s * 11 + kv_mul)
    b, n_kv = 2, 2
    q = torch.randn(b, s, n_kv * kv_mul, 128, generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn(b, s, n_kv, 128, generator=gen, device=card).to(torch.bfloat16)
    v = torch.randn(b, s, n_kv, 128, generator=gen, device=card).to(torch.bfloat16)
    before = LAUNCHES["causal_prefill_attention"]
    got = causal_prefill_attention(q, k, v)
    assert LAUNCHES["causal_prefill_attention"] == before + 1
    ref = causal_prefill_attention_plain(q, k, v)
    torch.cuda.synchronize()
    # Both round the f32 output to bf16; f32 sums in another order may flip
    # that rounding: one bf16 step, plus 1e-5 of f32 sums of O(1) values for
    # outputs that cancel to near zero.
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(got[:, 0], v[:, 0].repeat_interleave(kv_mul, dim=1))  # row 0: its own value


def test_long_windows_card_match_cpu(card):
    """A fresh 600-row window, a 300-row continuation and decode steps in fast
    mode; a 200-row exact window and decode steps."""
    cfg = ModelConfig(
        architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, seq_len=1024, vocab_size=2176, group_size=64, shared_classifier=True,
    )
    weights = random_weights(cfg, seed=4, device=card)
    rng = np.random.default_rng(1)
    for mode, windows in (("fast", (600, 300)), ("exact", (200,))):
        gpu = Engine(config=cfg, weights=weights, mode=mode, device=card)
        cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), mode=mode, device="cpu")
        caches = [gpu.new_cache(), cpu.new_cache()]
        pos = 0
        for s in windows:
            prompt = rng.integers(0, cfg.vocab_size, (1, s))
            lg, caches[0] = gpu.prefill(caches[0], prompt, [pos])
            lc, caches[1] = cpu.prefill(caches[1], prompt, [pos])
            pos += s
        for step in range(3):
            a, b = lg.float().cpu(), lc.float()
            assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max()), (mode, step)
            tok = [int(b.argmax())]
            lg, caches[0] = gpu.decode_step(caches[0], tok, [pos + step])
            lc, caches[1] = cpu.decode_step(caches[1], tok, [pos + step])


def _pool(gen, card, pool, page, n_pages, n_kv=2, layers=2):
    """A page pool of ``pool`` type with random rows, and its scales."""
    shape = (layers, n_pages, n_kv, page, 128)
    if pool == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8) for _ in range(2))
        return k, v, {name: torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005
                      for name in ("k_scale_pool", "v_scale_pool")}
    dt = torch.float32 if pool == "f32" else torch.bfloat16
    k, v = (torch.randn(shape, generator=gen, device=card).to(dt) for _ in range(2))
    return k, v, {}


def _tables(gen, card, b, max_pages, n_pages):
    """Shuffled, disjoint page ids over the pool (0 is the null page)."""
    ids = torch.randperm(n_pages - 1, generator=gen, device=card)[: b * max_pages] + 1
    return ids.reshape(b, max_pages).to(torch.int32).contiguous()


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("page", [16, 128])
def test_paged_decode_matches_plain(card, pool, kv_mul, page):
    gen = _gen(kv_mul * 5 + page + len(pool))
    max_pages = -(-300 // page)
    pos_list = [0, 1, page - 1, page, page + 1, 300]  # 300 is not a multiple of the 128-row chunk
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, sc = _pool(gen, card, pool, page, n_pages)
    table = _tables(gen, card, b, max_pages, n_pages)
    q = torch.randn(b, 2 * kv_mul, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, b, 2, 128, generator=gen, device=card)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    before = LAUNCHES["paged_decode"]
    got = paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
    assert LAUNCHES["paged_decode"] == before + 1
    ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0))  # pos 0: v_self


def test_paged_kernels_read_no_row_at_or_past_pos(card):
    """Rows at or past pos, the unused table entries and the null page hold
    NaN: neither kernel may read them."""
    gen = _gen(13)
    page, max_pages = 16, 8
    k, v, _ = _pool(gen, card, "f32", page, 1 + 3 * max_pages, layers=1)
    table = _tables(gen, card, 3, max_pages, 1 + 3 * max_pages)
    pos_list = [0, 5, 40]
    for b, p in enumerate(pos_list):
        for t in range(p, max_pages * page):
            k[0, table[b, t // page], :, t % page] = float("nan")
            v[0, table[b, t // page], :, t % page] = float("nan")
    k[:, 0] = v[:, 0] = float("nan")
    table[0] = 0  # an idle slot: all-null table at pos 0
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(3, 4, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, 3, 2, 128, generator=gen, device=card)
    assert bool(torch.isfinite(paged_decode(q, kn, vn, k, v, table, pos, 0)).all())
    m, l, acc = paged_window_partials(torch.randn(3, 5, 4, 128, generator=gen, device=card), k, v, table, pos, 0)
    assert bool(torch.isfinite(acc).all()) and bool(torch.isneginf(m[0]).all()) and bool(torch.isfinite(m[1:]).all())


def _window_holds(got, ref):
    """#10's partials against the plain version's: the same shapes and -inf
    entries, the finite ones within 1e-4·max|ref|."""
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert torch.equal(torch.isneginf(a), torch.isneginf(r))
        fin = torch.isfinite(r)
        if bool(fin.any()):
            assert float((a[fin] - r[fin]).abs().max()) <= 1e-4 * float(r[fin].abs().max())


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("s,kv_mul", [(2, 1), (3, 2), (32, 4), (16, 8), (5, 4), (4, 3), (3, 5), (8, 16)])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("hd", [128, 256])
def test_paged_window_matches_plain(card, pool, s, kv_mul, page, hd):
    """#10 over f32, bf16 and INT8 pools (the window kernel; an f32 stage as
    bf16 hi + lo, 32 rows a stage at head_dim 256) at R = S·kv_mul from 2 to
    128 rows, pages of 16 and 128 rows, head_dim 128 and 256: one launch,
    within 1e-4·max|ref| with the -inf entries equal; then an all-idle batch
    (every pos 0)."""
    gen = _gen(s * 7 + kv_mul + page + hd + len(pool))
    max_pages = -(-300 // page)
    pos_list = [0, 1, page + 1, 300]
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, sc = _cache_of(gen, card, pool, (2, n_pages, 2, page, hd))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    table = _tables(gen, card, b, max_pages, n_pages)
    q = torch.randn(b, s, 2 * kv_mul, hd, generator=gen, device=card)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    before = LAUNCHES["paged_window_partials"]
    got = paged_window_partials(q, k, v, table, pos, 1, **sc)
    assert LAUNCHES["paged_window_partials"] == before + 1
    ref = paged_window_partials_plain(q, k, v, table, pos, 1, **sc)
    torch.cuda.synchronize()
    _window_holds(got, ref)
    idle = torch.zeros_like(pos)
    m, l, acc = paged_window_partials(q, k, v, table, idle, 1, **sc)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(m).all()) and bool((l == 0).all()) and bool((acc == 0).all())


@pytest.mark.parametrize("pool", ["bf16", "int8", "f32"])
def test_paged_window_kernel_reads_no_row_at_or_past_pos(card, pool):
    """The window kernel's pools: rows at or past pos and the null page hold
    NaN (INT8: their scales too), and the partials stay finite where pos > 0."""
    gen = _gen(17 + len(pool))
    page, max_pages = 16, 8
    k, v, sc = _cache_of(gen, card, pool, (1, 1 + 3 * max_pages, 2, page, 128))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    table = _tables(gen, card, 3, max_pages, 1 + 3 * max_pages)
    pos_list = [0, 5, 40]
    nan_rows = [(table[b, t // page], t % page) for b, p in enumerate(pos_list) for t in range(p, max_pages * page)]
    for pg, r in nan_rows + [(0, r) for r in range(page)]:
        if pool == "int8":
            sc["k_scale_pool"][0, pg, :, r] = float("nan")
            sc["v_scale_pool"][0, pg, :, r] = float("nan")
        else:
            k[0, pg, :, r] = float("nan")
            v[0, pg, :, r] = float("nan")
    table[0] = 0  # an idle slot: all-null table at pos 0
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    m, l, acc = paged_window_partials(torch.randn(3, 5, 4, 128, generator=gen, device=card), k, v, table, pos, 0, **sc)
    assert bool(torch.isfinite(acc).all()) and bool(torch.isfinite(l).all())
    assert bool(torch.isneginf(m[0]).all()) and bool(torch.isfinite(m[1:]).all())


@pytest.mark.parametrize(
    "pos,n_kv,r,grid",
    [
        ([0, 1, 127, 128, 512, 1000, 2049, 4064], 8, 128, 264),  # 8B, S = 32: two row tiles
        ([0, 1, 127, 128, 512, 1000, 2049, 4064], 8, 16, 264),  # 8B, S = 4
        ([0, 0, 0], 2, 64, 132),  # idle slots only
        ([5000, 17, 300], 2, 80, 132),  # a position past the table
        (list(range(0, 200 * 20, 20)), 2, 100, 800),  # more than 128 requests
    ],
)
def test_paged_window_kernel_plan_is_window_units(card, pos, n_kv, r, grid):
    """The plan the window kernel's blocks make from the positions, read
    back block by block, is ``window_units``'s, unit for unit: at the given
    grid and at the grid the wrapper launches over each pool type (f32, bf16,
    INT8: its instance's blocks an SM), at head_dim 128 and at 640 (three
    column slices a row tile)."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import (
        paged_window_kernel_plan,
        window_grid,
        window_split_grid,
        window_units,
    )

    page, max_pages = 128, 32
    pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
    for hd in (128, 640):
        grids = {max(grid, window_grid(len(pos), n_kv, r, 1, 1, hd))}
        grids |= {window_split_grid(card, dt, hd, len(pos), n_kv, r) for dt in (torch.float32, torch.bfloat16, torch.int8)}
        for g in sorted(grids):
            assert paged_window_kernel_plan(pos_t, n_kv, r, page, max_pages, g, hd) == window_units(
                pos, n_kv, r, page, max_pages, g, hd), (hd, g)


@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("hd", [128, 640])
def test_paged_window_counters_stay_zero(card, pool, hd):
    """The window kernel's arrival counters are zero after every launch, two
    launches give the same bytes, one launch a call, and a CUDA graph's
    replay gives the same partials (at head_dim 640 the kernel past 256, its
    column slices and q scratch)."""
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    gen = _gen(78 + hd)
    page, max_pages, pos_list = 128, 32, [4064, 1000, 0, 2049]
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, sc = _cache_of(gen, card, pool, (2, n_pages, 8, page, hd))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    table = _tables(gen, card, b, max_pages, n_pages)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(b, 32, 32, hd, generator=gen, device=card)
    before = LAUNCHES["paged_window_partials"]
    first = paged_window_partials(q, k, v, table, pos, 1, **sc)
    assert LAUNCHES["paged_window_partials"] == before + 1
    again = paged_window_partials(q, k, v, table, pos, 1, **sc)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert int(pa._DECODE_COUNTERS[q.device].abs().sum()) == 0
    out = {}
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        paged_window_partials(q, k, v, table, pos, 1, **sc)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out["x"] = paged_window_partials(q, k, v, table, pos, 1, **sc)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(out["x"], first))
    assert int(pa._DECODE_COUNTERS[q.device].abs().sum()) == 0


def test_paged_serving_card_matches_cpu(card):
    """A short paged serving run (INT8 pool, prefix cache, a continued window
    through #10) on the card and on the CPU: every request completes, the
    kernels ran, and the first tokens agree."""
    cfg = ModelConfig(
        architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, seq_len=512, vocab_size=2176, group_size=64, shared_classifier=True,
    )
    weights = random_weights(cfg, seed=5, device=card)
    rng = np.random.default_rng(2)
    stem = [int(t) for t in rng.integers(3, cfg.vocab_size, 128)]
    # The three later suffixes share the 32-row bucket and fit the pool: one
    # continued window.
    prompts = [stem + [int(t) for t in rng.integers(3, cfg.vocab_size, n)] for n in (5, 20, 25, 30)]
    firsts = []
    for dev, w in ((card, weights), ("cpu", weights_to(weights, "cpu"))):
        engine = ContinuousBatchingEngine(config=cfg, weights=w, n_slots=4, kv_layout="paged", n_pages=16,
                                          cache_dtype="int8", prefix_cache=True, device=dev)
        engine.submit(Request(0, prompts[0], max_new_tokens=8))
        engine.step()  # registers the stem's page
        for i, p in enumerate(prompts[1:], 1):
            engine.submit(Request(i, p, max_new_tokens=8))
        before = dict(LAUNCHES)
        done = engine.run()
        assert len(done) == 4 and engine.stats()["prefix_hits"] == 3
        if dev == card:
            assert LAUNCHES["paged_decode"] > before["paged_decode"]
            assert LAUNCHES["paged_window_partials"] - before["paged_window_partials"] == cfg.n_layers
        firsts.append({r.request_id: r.generated[0] for r in done})
    assert firsts[0] == firsts[1]


def _mega_inputs(gen, card, cfg, b, cache, v_pad, q4=False):
    """Random weights (bf16 scales), stream, RoPE rows and caches for the
    decode megakernel at ``cfg``'s shapes; ``q4``: INT4 layer matrices
    (random packed bytes, every nibble), the classifier INT8."""
    L, g, hd = cfg.n_layers, cfg.group_size, cfg.head_dim

    def qt(*shape):
        scales = (torch.rand(*shape[:-2], shape[-2] // g, shape[-1], generator=gen, device=card) * 0.004 + 1e-3)
        if q4 and len(shape) == 3:
            packed = torch.randint(0, 256, (*shape[:-2], shape[-2] // 2, shape[-1]), generator=gen, device=card,
                                   dtype=torch.uint8)
            return Q4Tensor(packed, (scales * 16).to(torch.bfloat16))
        codes = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        return QuantizedTensor(codes, scales.to(torch.bfloat16))

    def norm(*shape):
        return 1 + 0.1 * torch.randn(*shape, generator=gen, device=card)

    ah, kvd = cfg.all_heads_dim, cfg.kv_dim
    w = dict(rms_att=norm(L, cfg.dim), rms_ffn=norm(L, cfg.dim), q_norm=norm(L, hd), k_norm=norm(L, hd),
             wqkv=qt(L, cfg.dim, ah + 2 * kvd), wo=qt(L, ah, cfg.dim), w13=qt(L, cfg.dim, 2 * cfg.hidden_dim),
             w2=qt(L, cfg.hidden_dim, cfg.dim), rms_final=norm(cfg.dim), lm_head=qt(cfg.dim, v_pad))
    ang = torch.rand(b, hd // 2, generator=gen, device=card) * 6
    shape = (L, b, cfg.n_kv_heads, cfg.seq_len, hd)
    if cache == "int8":
        kv = [torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005 for _ in range(2)]
    else:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        kv = [torch.randn(shape, generator=gen, device=card).to(dt) for _ in range(2)]
        sc = [None, None]
    x = torch.randn(b, cfg.dim, generator=gen, device=card)
    return w, x, torch.cos(ang), torch.sin(ang), kv, sc


def _mega(fn, cfg, w, x, cos, sin, kv, sc, pos, ok, head=True, greedy=False):
    return fn(cfg, x, w["rms_att"], w["rms_ffn"], w["q_norm"], w["k_norm"], cos, sin, w["wqkv"], w["wo"], w["w13"],
              w["w2"], kv[0], kv[1], pos, w["rms_final"] if head else None, w["lm_head"] if head else None, ok,
              k_scale=sc[0], v_scale=sc[1], eps=cfg.norm_eps, greedy=greedy)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("heads,b", [((4, 4), 1), ((4, 2), 3), ((8, 2), 8), ((8, 1), 2), ((5, 1), 2), ((12, 1), 3),
                                     ((16, 1), 1)])
def test_megakernel_matches_plain(card, cache, heads, b):
    """Ragged cache (200 rows: not a multiple of the 128-row chunk), mixed
    positions (0, past the window with its write gate on: clamped to the last
    row), one row's write gate off; logits, greedy, and a run without the
    head.  Tolerances as tests/test_torch_megakernel.py argues them: a row
    within 5e-3 of its largest value (an f32 sum in another order may flip a
    bf16 rounding), logits within 1e-2, INT8 codes within one step."""
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=768, n_layers=2, n_heads=heads[0],
                      n_kv_heads=heads[1], head_dim=128, seq_len=200, vocab_size=1000, group_size=64,
                      shared_classifier=True)
    gen = _gen(b * 31 + heads[0] * 7 + heads[1] + len(cache))
    w, x, cos, sin, kv, sc = _mega_inputs(gen, card, cfg, b, cache, 1024)
    pos = torch.tensor([0, 205, 64, 199, 1, 128, 127, 150][:b], dtype=torch.int32, device=card)
    ok = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1][:b], dtype=torch.int32, device=card)
    copies = [[t.clone() if t is not None else None for t in kv + sc] for _ in range(4)]
    before = LAUNCHES["decode_megakernel"]
    gx, glog = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[0][:2], copies[0][2:], pos, ok)
    assert LAUNCHES["decode_megakernel"] == before + 1
    px, plog = _mega(decode_stack_megakernel_plain, cfg, w, x, cos, sin, copies[1][:2], copies[1][2:], pos, ok)
    _, gtok = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[2][:2], copies[2][2:], pos, ok, greedy=True)
    hx, none = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[3][:2], copies[3][2:], pos, ok, head=False)
    torch.cuda.synchronize()
    assert none is None and torch.equal(hx, gx)  # deterministic; the head does not touch the stream
    for r in range(b):
        assert float((gx[r] - px[r]).abs().max()) <= 5e-3 * float(px[r].abs().max()), r
        assert float((glog[r] - plog[r]).abs().max()) <= 1e-2 * float(plog[r].abs().max()), r
    assert torch.equal(gtok, glog[:, : cfg.vocab_size].argmax(-1).to(torch.int32))  # first max, padding masked
    for i in range(2):
        got, ref, old = copies[0][i].float(), copies[1][i].float(), kv[i].float()
        assert float((got - ref).abs().max()) <= (1 if cache == "int8" else 5e-3 * float(ref.abs().max()))
        for r in range(b):
            row = min(int(pos[r]), cfg.seq_len - 1)
            keep = torch.ones(cfg.seq_len, dtype=torch.bool, device=card)
            if ok[r]:
                keep[row] = False
            assert torch.equal(got[:, r][:, :, keep], old[:, r][:, :, keep]), r  # bit for bit
        for t_ in copies[2][i], copies[3][i]:
            assert torch.equal(t_, copies[0][i])


def test_megakernel_reads_no_row_at_or_past_pos(card):
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=300, vocab_size=512, group_size=64, shared_classifier=True)
    w, x, cos, sin, kv, sc = _mega_inputs(_gen(17), card, cfg, 3, "f32", 512)
    pos_list = [0, 5, 260]
    for r, p in enumerate(pos_list):
        for t_ in kv:
            t_[:, r, :, p:] = float("nan")
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    out, logits = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, kv, sc, pos, None)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(kv[0][:, torch.arange(3), :, pos.long()]).all())  # the rows written


def test_megakernel_engine_decode_chunk_matches_cpu(card):
    """decode_chunk through the kernel on the card and through the plain
    version on the CPU: the same greedy tokens from the same prompt."""
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=256, vocab_size=2048, group_size=64, shared_classifier=True)
    weights = random_weights(cfg, seed=6, device=card)
    weights = weights._replace(rms_final=weights.rms_final * 20)  # peaked: no near-ties
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 20))
    toks = []
    for eng in (Engine(config=cfg, weights=weights, device=card),
                Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")):
        logits, cache = eng.prefill(eng.new_cache(), prompt, [0])
        before = LAUNCHES["decode_megakernel"]
        chunk, _ = eng.decode_chunk(cache, int(logits.float().argmax()), 20, 12)
        toks.append(chunk.tolist())
        if eng.device.type == "cuda":
            assert LAUNCHES["decode_megakernel"] == before + 12
    assert toks[0] == toks[1]


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("g,heads,b", [(64, (4, 2), 1), (32, (4, 4), 3), (128, (8, 2), 8), (64, (8, 1), 5),
                                       (32, (8, 2), 2), (2, (4, 2), 2), (4, (12, 1), 1), (512, (4, 2), 3)])
def test_megakernel_q4_matches_plain(card, cache, g, heads, b):
    """INT4 layers (the Q4 tiles) against the plain version: group sizes 2
    to 512, 1 to 12 query heads per kv head, B = 1..8, a ragged 200-row
    cache, odd positions, a row past the window with its write gate off and
    one with it on (clamped to the last row); logits, greedy and the stream,
    at the INT8 cases' tolerances."""
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024 if g == 512 else 768, n_layers=2,
                      n_heads=heads[0], n_kv_heads=heads[1], head_dim=128, seq_len=200, vocab_size=1000,
                      group_size=g, shared_classifier=True)
    gen = _gen(b * 37 + g + heads[0] * 5 + len(cache))
    w, x, cos, sin, kv, sc = _mega_inputs(gen, card, cfg, b, cache, 1024, q4=True)
    assert isinstance(w["wqkv"], Q4Tensor) and not isinstance(w["lm_head"], Q4Tensor)
    pos = torch.tensor([77, 211, 3, 205, 0, 199, 131, 64][:b], dtype=torch.int32, device=card)
    ok = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1][:b], dtype=torch.int32, device=card)
    copies = [[t.clone() if t is not None else None for t in kv + sc] for _ in range(3)]
    before = dict(LAUNCHES)
    gx, glog = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[0][:2], copies[0][2:], pos, ok)
    assert LAUNCHES["decode_megakernel_q4"] == before["decode_megakernel_q4"] + 1
    assert LAUNCHES["decode_megakernel"] == before["decode_megakernel"]
    px, plog = _mega(decode_stack_megakernel_plain, cfg, w, x, cos, sin, copies[1][:2], copies[1][2:], pos, ok)
    _, gtok = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[2][:2], copies[2][2:], pos, ok, greedy=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(glog).all())
    for r in range(b):
        assert float((gx[r] - px[r]).abs().max()) <= 5e-3 * float(px[r].abs().max()), r
        assert float((glog[r] - plog[r]).abs().max()) <= 1e-2 * float(plog[r].abs().max()), r
    assert torch.equal(gtok, glog[:, : cfg.vocab_size].argmax(-1).to(torch.int32))
    for i in range(2):
        got, ref, old = copies[0][i].float(), copies[1][i].float(), kv[i].float()
        if cache == "int8":
            assert float((got - ref).abs().max()) <= 1
        else:
            # The second layer's rows carry the stream's error, and a bf16 row
            # may then round one step apart (at most 2^-7 of its value).
            lim = 5e-3 * float(ref.abs().max()) + 2.0**-7 * ref.abs()
            assert bool(((got - ref).abs() <= lim).all())
        for r in range(b):
            keep = torch.ones(cfg.seq_len, dtype=torch.bool, device=card)
            if ok[r]:
                keep[min(int(pos[r]), cfg.seq_len - 1)] = False
            assert torch.equal(got[:, r][:, :, keep], old[:, r][:, :, keep]), r
        assert torch.equal(copies[2][i], copies[0][i])


_RING_CASES = [(b, g, q4) for q4 in (False, True) for g in (32, 64, 128) for b in (1, 2, 3, 5, 8)]


@pytest.mark.parametrize("b,g,q4", _RING_CASES)
def test_megakernel_ring_matches_plain(card, b, g, q4):
    """The ring's shapes: dim 640 (wo's and w2's last strip 128 columns, w13's
    1792 columns 3.5 strips, wqkv 896), group sizes 32, 64 and 128 for INT8
    and INT4 layers, B = 1, 2, 3, 5, 8, the three caches in turn, 5 query
    heads on one kv head; the rows written and the cache outside them as in
    test_megakernel_q4_matches_plain, greedy the first max of the logits.

    Each layer is held to the plain version's layer from the same input:
    within 5e-3 of a row's largest value (logits 1e-2), as
    tests/test_torch_megakernel.py argues (an f32 sum in another order may
    flip one bf16 rounding).  Layer 0 from the step's input; layer 1 of a
    two-layer launch against the plain second layer from the one-layer
    launch's output (the launch is repeatable bit for bit and its plans do
    not depend on the depth), so that a rounding flipped in layer 0 is not
    counted again as layer 1's error, while the hand-over between the layers
    (the stream in place, its norm from the strips' sums of squares) is still
    the kernel's own."""
    import dataclasses

    cache = ("f32", "bf16", "int8")[(b + g // 32 + int(q4)) % 3]
    cfg = ModelConfig(architecture_id=1, dim=640, hidden_dim=896, n_layers=2, n_heads=5, n_kv_heads=1,
                      head_dim=128, seq_len=200, vocab_size=1000, group_size=g, shared_classifier=True)
    gen = _gen(b * 41 + g + 7 * int(q4))
    w, x, cos, sin, kv, sc = _mega_inputs(gen, card, cfg, b, cache, 1024, q4=q4)
    pos = torch.tensor([0, 199, 64, 150, 1, 128, 127, 230][:b], dtype=torch.int32, device=card)
    ok = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1][:b], dtype=torch.int32, device=card)
    key = "decode_megakernel_q4" if q4 else "decode_megakernel"

    def layers(lo, hi):
        ws = dict(w)
        for k in ("rms_att", "rms_ffn", "q_norm", "k_norm"):
            ws[k] = w[k][lo:hi]
        for k in ("wqkv", "wo", "w13", "w2"):
            ws[k] = type(w[k])(w[k].q[lo:hi], w[k].scales[lo:hi])
        return dataclasses.replace(cfg, n_layers=hi - lo), ws

    def state(lo, hi):
        return [t[lo:hi].clone() if t is not None else None for t in kv + sc]

    def run(fn, lo, hi, x_in, st, greedy=False):
        c, ws = layers(lo, hi)
        return _mega(fn, c, ws, x_in, cos, sin, st[:2], st[2:], pos, ok, greedy=greedy)

    def rel(a, ref):
        return float((a - ref).abs().max()) / float(ref.abs().max())

    got1, ref1, tok1 = state(0, 1), state(0, 1), state(0, 1)
    before = LAUNCHES[key]
    gx1, glog1 = run(decode_stack_megakernel, 0, 1, x, got1)
    assert LAUNCHES[key] == before + 1
    px1, plog1 = run(decode_stack_megakernel_plain, 0, 1, x, ref1)
    gtok1 = run(decode_stack_megakernel, 0, 1, x, tok1, greedy=True)[1]
    got2, tok2, ref_l1 = state(0, 2), state(0, 2), state(1, 2)
    gx2, glog2 = run(decode_stack_megakernel, 0, 2, x, got2)
    gtok2 = run(decode_stack_megakernel, 0, 2, x, tok2, greedy=True)[1]
    px2, plog2 = run(decode_stack_megakernel_plain, 1, 2, gx1, ref_l1)
    ref2 = [torch.cat([a, b_]) if a is not None else None for a, b_ in zip(ref1, ref_l1)]
    torch.cuda.synchronize()
    for depth, gx, glog, px, plog, gtok, got, ref, tok in (
            (1, gx1, glog1, px1, plog1, gtok1, got1, ref1, tok1),
            (2, gx2, glog2, px2, plog2, gtok2, got2, ref2, tok2)):
        assert bool(torch.isfinite(glog).all())
        for r in range(b):
            assert rel(gx[r], px[r]) <= 5e-3, (depth, r, rel(gx[r], px[r]))
            assert rel(glog[r], plog[r]) <= 1e-2, (depth, r, rel(glog[r], plog[r]))
        assert torch.equal(gtok, glog[:, : cfg.vocab_size].argmax(-1).to(torch.int32))
        for i in range(2):
            g_, r_, old = got[i].float(), ref[i].float(), kv[i][:depth].float()
            if cache == "int8":
                assert float((g_ - r_).abs().max()) <= 1
            else:
                lim = 5e-3 * float(r_.abs().max()) + 2.0**-7 * r_.abs()
                assert bool(((g_ - r_).abs() <= lim).all())
            for r in range(b):
                keep = torch.ones(cfg.seq_len, dtype=torch.bool, device=card)
                if ok[r]:
                    keep[min(int(pos[r]), cfg.seq_len - 1)] = False
                assert torch.equal(g_[:, r][:, :, keep], old[:, r][:, :, keep]), r
            assert torch.equal(tok[i], got[i])


@pytest.mark.parametrize("b,q4,cache", [(1, False, "f32"), (8, False, "bf16"), (1, True, "int8"), (5, True, "f32")])
def test_megakernel_repeats_bit_for_bit(card, b, q4, cache):
    """Launches back to back on one stream from the same inputs are equal bit
    for bit: the barrier and arrival counters are left as the next launch
    expects them, and every sum across blocks is taken in a fixed order."""
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=8, n_kv_heads=2,
                      head_dim=128, seq_len=256, vocab_size=2000, group_size=64, shared_classifier=True)
    w, x, cos, sin, kv, sc = _mega_inputs(_gen(b * 3 + int(q4)), card, cfg, b, cache, 2048, q4=q4)
    pos = torch.tensor([255, 3, 129, 0, 64, 200, 17, 128][:b], dtype=torch.int32, device=card)
    copies = [[t.clone() if t is not None else None for t in kv + sc] for _ in range(3)]
    outs = [_mega(decode_stack_megakernel, cfg, w, x, cos, sin, c[:2], c[2:], pos, None) for c in copies]
    toks = [_mega(decode_stack_megakernel, cfg, w, x, cos, sin, [t.clone() for t in kv],
                  [t.clone() if t is not None else None for t in sc], pos, None, greedy=True)[1] for _ in range(2)]
    torch.cuda.synchronize()
    for o, c in zip(outs[1:], copies[1:]):
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
        assert all(torch.equal(a, b_) for a, b_ in zip(c, copies[0]) if a is not None)
    assert torch.equal(toks[0], toks[1])


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("heads", [(8, 2), (16, 2), (12, 1)])
def test_megakernel_head_groups_match_plain(card, heads, cache):
    """Attention items of 4 or 8 query heads (the kernel takes one head an
    item only where those items fit one round of the grid, so short caches
    never reach the groups): a 1024-row cache with B = 8 rows up to its last
    position, kv_mul 4, 8 and 12 (a group of 8 and one of 4); one layer
    against the plain version at the single-layer tolerances, the rows
    written and the cache outside them as in the other cases."""
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=768, n_layers=1, n_heads=heads[0],
                      n_kv_heads=heads[1], head_dim=128, seq_len=1024, vocab_size=1000, group_size=64,
                      shared_classifier=True)
    b = 8
    w, x, cos, sin, kv, sc = _mega_inputs(_gen(heads[0] * 7 + len(cache)), card, cfg, b, cache, 1024)
    pos = torch.tensor([1023, 900, 512, 0, 7, 300, 1500, 64], dtype=torch.int32, device=card)
    ok = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], dtype=torch.int32, device=card)
    assert b * heads[0] * 8 > 132  # the one-head items would not fit one round
    copies = [[t.clone() if t is not None else None for t in kv + sc] for _ in range(2)]
    gx, glog = _mega(decode_stack_megakernel, cfg, w, x, cos, sin, copies[0][:2], copies[0][2:], pos, ok)
    px, plog = _mega(decode_stack_megakernel_plain, cfg, w, x, cos, sin, copies[1][:2], copies[1][2:], pos, ok)
    torch.cuda.synchronize()
    for r in range(b):
        assert float((gx[r] - px[r]).abs().max()) <= 5e-3 * float(px[r].abs().max()), r
        assert float((glog[r] - plog[r]).abs().max()) <= 1e-2 * float(plog[r].abs().max()), r
    for i in range(2):
        got, ref, old = copies[0][i].float(), copies[1][i].float(), kv[i].float()
        if cache == "int8":
            assert float((got - ref).abs().max()) <= 1
        else:
            assert bool(((got - ref).abs() <= 5e-3 * float(ref.abs().max()) + 2.0**-7 * ref.abs()).all())
        for r in range(b):
            keep = torch.ones(cfg.seq_len, dtype=torch.bool, device=card)
            if ok[r]:
                keep[min(int(pos[r]), cfg.seq_len - 1)] = False
            assert torch.equal(got[:, r][:, :, keep], old[:, r][:, :, keep]), r


@pytest.mark.parametrize("q4", [False, True])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_megakernel_schedule_is_the_kernels_walk(card, b, q4):
    """The wrapper's mirror of #11's schedule (``block_stages``, which the
    CPU tests check for coverage and the ring's budget) lists block for block
    the stages the kernel's producer walks (``decode_megakernel_stages``: the
    same ``item_of`` and ``stage_of`` as ``produce_mat``), at Qwen3-8B on this
    card's grid and at the card tests' dim 640, groups 32 and 128."""
    from qwen3_rs_tpu_torch.ops.kernels import megakernel as mk
    from qwen3_rs_tpu_torch.testing import QWEN3_CONFIGS

    small = dict(architecture_id=1, dim=640, hidden_dim=896, n_layers=2, n_heads=5, n_kv_heads=1, head_dim=128,
                 seq_len=200, vocab_size=1000, shared_classifier=True)
    configs = [(ModelConfig(architecture_id=1, seq_len=4096, group_size=64, shared_classifier=True,
                            **QWEN3_CONFIGS["8b"]), 153600),
               (ModelConfig(group_size=32, **small), 1024), (ModelConfig(group_size=128, **small), None)]
    for cfg, v_pad in configs:
        grid = mk.launch_grid(cfg.group_size, q4)
        s = mk.schedule(cfg, b, grid, v_pad, q4)
        for m in s.mats:
            for blk in range(grid):
                want = mk.block_stages(m, s.ring, grid, blk)
                assert mk.kernel_stages(m, cfg.group_size, s.ring, grid, blk) == want, (cfg.dim, m.name, blk)


def test_megakernel_q4_refuses_what_it_cannot_take(card):
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=768, n_layers=1, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=128, vocab_size=1000, group_size=64, shared_classifier=True)
    w, x, cos, sin, kv, sc = _mega_inputs(_gen(3), card, cfg, 1, "f32", 1024, q4=True)
    pos = torch.tensor([5], dtype=torch.int32, device=card)
    w8, _, _, _, _, _ = _mega_inputs(_gen(4), card, cfg, 1, "f32", 1024)
    with pytest.raises(ValueError, match="mix INT8 and INT4"):
        _mega(decode_stack_megakernel, cfg, dict(w, wo=w8["wo"]), x, cos, sin, kv, sc, pos, None)
    with pytest.raises(ValueError, match="classifier must be INT8"):
        _mega(decode_stack_megakernel, cfg, dict(w, lm_head=w["wqkv"]), x, cos, sin, kv, sc, pos, None)


GATED = {  # case: (config overrides, bits, {wrapper key: launched?}), as the JAX gates route them
    "head_dim 64": (dict(architecture_id=2, dim=256, hidden_dim=512, head_dim=64, shared_classifier=False,
                         use_qk_norm=False), 8, {"flash_decode": False, "causal_prefill_attention": False}),
    "INT4 g512": (dict(group_size=512), 4, {"qmatmul_w8a16_q4": True}),
    "kv_mul 5": (dict(dim=256, n_heads=5, n_kv_heads=1), 8, {"flash_decode": True, "causal_prefill_attention": True}),
}


@pytest.mark.parametrize("case", list(GATED))
def test_gated_shapes_run_on_the_card(card, case):
    """A shape the JAX gates refuse (a head_dim-64 Llama) runs on the card
    through the plain path, with no launch of the refused kernels; shapes
    they admit that the port's kernels once refused (INT4 with 512-row
    groups, 5 query heads per kv head) run through the kernels.  A 300-row
    fresh window, a 20-row window and two decode steps, each within 2e-2 of
    the largest logit of the CPU's."""
    over, bits, launched = GATED[case]
    cfg = ModelConfig(**{**dict(architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                                head_dim=128, seq_len=512, vocab_size=512, group_size=64, shared_classifier=True),
                         **over})
    weights = random_weights(cfg, seed=8, device=card, bits=bits)
    rng = np.random.default_rng(8)
    engines = [Engine(config=cfg, weights=weights, device=card),
               Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")]
    caches = [e.new_cache() for e in engines]
    before = dict(LAUNCHES)
    pos = 0
    for rows in (300, 20, 1, 1):
        toks = rng.integers(0, cfg.vocab_size, (1, rows))
        (lc, caches[0]), (lp, caches[1]) = (e.prefill(c, toks, [pos]) for e, c in zip(engines, caches))
        err = float((lc.float().cpu() - lp.float()).abs().max())
        assert err <= 2e-2 * float(lp.float().abs().max()), (rows, err)
        pos += rows
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] > before[k] for k in launched} == launched, {k: LAUNCHES[k] - before[k] for k in launched}


# ------------------------------------------------- head_dim past 128, out_cols
def _cache_of(gen, card, kind, shape):
    """K and V of ``kind`` (f32, bf16 or int8 with row scales) and the scales
    under the names ``_all``/``_pool`` callers give them."""
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8) for _ in range(2))
        return k, v, [torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005 for _ in range(2)]
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    k, v = (torch.randn(shape, generator=gen, device=card).to(dt) for _ in range(2))
    return k, v, None


def _one_launch_spy(monkeypatch) -> list:
    """The grids of the one-launch decode kernel's launches from now on (``paged_attention.one_launch``,
    which #9 and #4 both call; past head_dim 256 its C entry point takes the kernel past 256)."""
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    grids, real = [], pa.one_launch

    def spy(*args, **kwargs):
        grids.append(real(*args, **kwargs))
        return grids[-1]

    monkeypatch.setattr(pa, "one_launch", spy)
    return grids


@pytest.mark.parametrize("hd", [256, 384, 512, 640, 1024])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_mul", [1, 3, 4, 8])
def test_flash_decode_head_dims_match_plain(card, monkeypatch, hd, cache, kv_mul):
    """#4 past head_dim 128 over caches of T = 300 rows (the two-pass kernel) and T = 304 (a multiple
    of 16: one launch of the one-launch kernel, past 256 its kernel past 256), at 1e-5, v_self at
    pos 0."""
    gen = _gen(hd + kv_mul * 3 + len(cache))
    n_kv = 2
    grids = _one_launch_spy(monkeypatch)
    for t in (300, 304):
        pos_list = [0, 1, 129, t]
        b = len(pos_list)
        k_all, v_all, sc = _cache_of(gen, card, cache, (2, b, n_kv, t, hd))
        sc = {} if sc is None else dict(zip(("k_scale_all", "v_scale_all"), sc))
        q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
        kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=card)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
        before, ran = LAUNCHES["flash_decode"], len(grids)
        got = flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
        assert LAUNCHES["flash_decode"] == before + 1
        assert len(grids) == ran + (t % 16 == 0), t  # the one-launch kernel exactly where T is a multiple of 16
        ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max())), t
        assert torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0)), t  # pos 0: v_self


@pytest.mark.parametrize("hd", [256, 384, 512, 640, 1024])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("kv_mul,s", [(1, 3), (4, 8), (5, 2), (4, 32)])
def test_paged_kernels_head_dims_match_plain(card, monkeypatch, hd, pool, page, kv_mul, s):
    """#9 and #10 at head_dims past 128 (pages of 16 and 128 rows, shuffled
    tables, up to R = 128 window rows a kv head: two row tiles), each one
    launch a call, #9's of the one-launch kernel (past 256 its kernel past
    256), v_self at pos 0."""
    gen = _gen(hd + kv_mul + s + len(pool) + page)
    max_pages, pos_list = -(-300 // page), [0, 1, 129, 300]
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, sc = _cache_of(gen, card, pool, (2, n_pages, 2, page, hd))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    table = _tables(gen, card, b, max_pages, n_pages)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(b, 2 * kv_mul, hd, generator=gen, device=card)
    kn, vn = torch.randn(2, b, 2, hd, generator=gen, device=card)
    grids = _one_launch_spy(monkeypatch)
    before = LAUNCHES["paged_decode"]
    got = paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
    assert LAUNCHES["paged_decode"] == before + 1 and len(grids) == 1  # one launch of the one-launch kernel
    ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0))  # pos 0: v_self
    qw = torch.randn(b, s, 2 * kv_mul, hd, generator=gen, device=card)
    before = LAUNCHES["paged_window_partials"]
    got = paged_window_partials(qw, k, v, table, pos, 1, **sc)
    assert LAUNCHES["paged_window_partials"] == before + 1
    ref = paged_window_partials_plain(qw, k, v, table, pos, 1, **sc)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert a.shape == r.shape and torch.equal(torch.isneginf(a), torch.isneginf(r))
        fin = torch.isfinite(r)
        assert float((a[fin] - r[fin]).abs().max()) <= 1e-4 * float(r[fin].abs().max())


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 300, 1000, 2048])
@pytest.mark.parametrize("kv_mul", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("hd", [128, 256])
def test_prefill_attention_wgmma_matches_plain(card, s, kv_mul, hd):
    """#5's TMA and wgmma kernel (head_dim 128 and 256) at windows on both
    sides of its 64-row key tiles and 128-row query tiles, every packing of
    query heads per block (kv_mul 1, 3, 5: one head; 4: four; 8: eight),
    two batch rows, with the tolerance of the kernel it replaced."""
    gen = _gen(s * 23 + kv_mul + hd)
    q = torch.randn(2, s, 2 * kv_mul, hd, generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn(2, s, 2, hd, generator=gen, device=card).to(torch.bfloat16) for _ in range(2))
    before = LAUNCHES["causal_prefill_attention"]
    got = causal_prefill_attention(q, k, v)
    assert LAUNCHES["causal_prefill_attention"] == before + 1
    ref = causal_prefill_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(got[:, 0], v[:, 0].repeat_interleave(kv_mul, dim=1))  # row 0: its own value


@pytest.mark.parametrize("s", [1, 65, 300])
@pytest.mark.parametrize("kv_mul", [1, 4, 5])
def test_prefill_attention_head_dim_256_matches_plain(card, s, kv_mul):
    gen = _gen(s * 13 + kv_mul)
    q = torch.randn(2, s, 2 * kv_mul, 256, generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn(2, s, 2, 256, generator=gen, device=card).to(torch.bfloat16) for _ in range(2))
    got = causal_prefill_attention(q, k, v)
    ref = causal_prefill_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=1e-5)  # as at head_dim 128


@pytest.mark.parametrize("s", [1, 65, 300, 1000, 2048])
@pytest.mark.parametrize("hd", [384, 512, 640, 1024])
@pytest.mark.parametrize("kv_mul", [1, 4, 5, 8])
def test_prefill_attention_wide_head_dims_match_plain(card, s, hd, kv_mul):
    """#5 past head_dim 256 (one S warpgroup, P shared with the P.V
    warpgroups of a column slice; 1, 2 and 3 slices) at ragged windows up to
    S = 2048 and every packing of query heads (kv_mul 8: eight a block), one
    launch a call, with the tolerance of head_dim 128."""
    gen = _gen(s * 17 + hd + kv_mul)
    q = torch.randn(2, s, 2 * kv_mul, hd, generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn(2, s, 2, hd, generator=gen, device=card).to(torch.bfloat16) for _ in range(2))
    before = LAUNCHES["causal_prefill_attention"]
    got = causal_prefill_attention(q, k, v)
    assert LAUNCHES["causal_prefill_attention"] == before + 1
    ref = causal_prefill_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(got[:, 0], v[:, 0].repeat_interleave(kv_mul, dim=1))  # row 0: its own value


def test_prefill_wide_plan_is_the_kernels(card):
    """#5's block past head_dim 256, as its source makes it, is
    ``wide_plan``'s at every head_dim up to 2048 (q resident up to 1280,
    then band by band)."""
    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import wide_kernel_plan, wide_plan

    for hd in range(384, 2049, 128):
        assert wide_kernel_plan(hd) == wide_plan(hd), hd


def test_decode_wide_layout_is_the_kernels(card):
    """The decode kernel's shared memory past head_dim 256, as its source lays it out, is
    ``decode_wide_layout``'s for each pool type at every head_dim it takes; and it fits a block."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_wide_kernel_layout, decode_wide_layout

    for dt in (torch.float32, torch.bfloat16, torch.int8):
        for hd in range(384, 1025, 128):
            got = decode_wide_kernel_layout(dt, hd)
            assert got == decode_wide_layout(dt, hd), (dt, hd)
            assert got["smem"] <= 232448


@pytest.mark.parametrize(
    "pos,n_kv,kv_mul,grid",
    [
        ([0, 1, 127, 128, 129, 1000, 2049, 4095], 8, 4, 264),
        ([0, 0, 0], 2, 3, 132),
        ([5000, 17, 300], 2, 12, 132),  # head tiles of 6
        (list(range(0, 200 * 20, 20)), 2, 5, 800),  # more than 128 requests, 5 heads a tile
    ],
)
def test_paged_decode_wide_plan_is_decode_units(card, pos, n_kv, kv_mul, grid):
    """Past head_dim 256 the kernel's blocks plan with head tiles of the largest divisor of kv_mul
    up to 8 (``decode_qm(kv_mul, hd)``): the plan read back is ``decode_units``' at head_dim 640."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_grid, decode_units, paged_decode_kernel_plan

    page, max_pages, hd = 128, 32, 640
    grid = max(grid, decode_grid(len(pos), n_kv, kv_mul, 1, 1, hd))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
    assert paged_decode_kernel_plan(pos_t, n_kv, kv_mul, page, max_pages, grid, hd) == decode_units(
        pos, n_kv, kv_mul, page, max_pages, grid, hd)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_decode_past_256_replays_from_a_graph(card, kind, cache):
    """#9 (a page-128 pool) and #4 (a dense cache) at head_dim 640 on the kernel past 256: two calls
    equal bit for bit, the arrival counters zero after each, and a CUDA graph's replay of the launch
    gives the same output, the counters still zero (positions that take several splits)."""
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    gen = _gen(640 + len(kind) + len(cache))
    hd, n_kv, kv_mul, pos_list = 640, 2, 4, [4095, 1000, 0, 2049]
    b = len(pos_list)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
    kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=card)
    if kind == "paged":
        page, max_pages = 128, 32
        n_pages = 1 + b * max_pages
        k, v, sc = _cache_of(gen, card, cache, (2, n_pages, n_kv, page, hd))
        sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
        table = _tables(gen, card, b, max_pages, n_pages)
        call = lambda: paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
        ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
        tol = 1e-4 * float(ref.abs().max())
    else:
        k, v, sc = _cache_of(gen, card, cache, (2, b, n_kv, 4096, hd))
        sc = {} if sc is None else dict(zip(("k_scale_all", "v_scale_all"), sc))
        call = lambda: flash_decode(q, kn, vn, k, v, pos, 1, **sc)
        ref = flash_decode_plain(q, kn, vn, k, v, pos, 1, **sc)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
    first = call()
    torch.cuda.synchronize()
    assert float((first - ref).abs().max()) <= tol
    assert torch.equal(first[2], vn[2].repeat_interleave(kv_mul, dim=0))  # pos 0: v_self
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0
    out = {}
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        call()  # warm-up on the capture stream
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out["x"] = call()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["x"], first)
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0


@pytest.mark.parametrize("pool,hd", [("int8", 512), ("int8", 640), ("bf16", 640), ("f32", 512)])
def test_decode_past_256_repeats_with_a_full_ring(card, pool, hd):
    """#9 past head_dim 256 at the 8B's 8 kv heads and 32 query heads over splits of ~17 stages, where
    the producer refills each slot as soon as it is released (an INT8 pool's stages are consumed
    slower than they load): 20 launches equal bit for bit and within 1e-4·max|ref|.  Without the
    proxy fence before each slot's release, 8 of 40 INT8 launches at 512 and 36 of 40 at 640 read
    a later lap's rows in some stage."""
    gen = _gen(hd + len(pool) + 4095)
    page, max_pages, n_kv, kv_mul = 128, 32, 8, 4
    pos_list = [0, 1, 127, 128, 129, 1000, 2049, 4095]
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, sc = _cache_of(gen, card, pool, (2, n_pages, n_kv, page, hd))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    table = _tables(gen, card, b, max_pages, n_pages)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
    kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=card)
    ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
    outs = [paged_decode(q, kn, vn, k, v, table, pos, 1, **sc) for _ in range(20)]
    torch.cuda.synchronize()
    assert float((outs[0] - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_window_wide_layout_is_the_kernels(card):
    """#10's shared memory past head_dim 256, as its source lays it out, is
    ``window_wide_layout``'s for each pool type."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import window_wide_kernel_layout, window_wide_layout

    for dt in (torch.float32, torch.bfloat16, torch.int8):
        assert window_wide_kernel_layout(dt) == window_wide_layout(dt), dt


def test_attention_kernels_refuse_head_dims_they_are_not_built_for(card):
    q = torch.zeros(1, 4, 2, 576, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 576"):
        causal_prefill_attention(q, q[:, :, :1], q[:, :, :1])
    k = torch.zeros(1, 1, 1, 8, 192, device=card)
    with pytest.raises(ValueError, match="head_dim 192"):
        flash_decode(torch.zeros(1, 1, 192, device=card), k[:, 0, :, 0], k[:, 0, :, 0], k, k,
                     torch.zeros(1, dtype=torch.int32, device=card), 0)


@pytest.mark.parametrize("n,d,g", [(2048, 4096, 64), (512, 1040, 64), (256, 512, 32)])
def test_qmatmul_rows_out_cols_match_full_and_plain(card, n, d, g):
    """Column windows of #6: bit for bit the same columns of the full launch
    (each element's k order does not depend on the window), and the plain
    version within its tolerance; counted under their own key."""
    gen = _gen(n + d + g)
    w = _weights(gen, card, 2, n, d, g)
    x = torch.randn(520, n, generator=gen, device=card).to(torch.bfloat16)
    full = qmatmul_w8a16_rows(x, w, 1)
    for c0, dc in ((0, 128), (128, 256), (d - d % 128 - 128, 128 + d % 128), (0, d)):
        before = LAUNCHES["qmatmul_w8a16_rows_cols"]
        got = qmatmul_w8a16_rows(x, w, 1, out_cols=(c0, dc))
        assert LAUNCHES["qmatmul_w8a16_rows_cols"] == before + 1
        ref = qmatmul_w8a16_rows_plain(x, w, 1, out_cols=(c0, dc))
        torch.cuda.synchronize()
        assert got.shape == (520, dc) and torch.equal(got, full[:, c0 : c0 + dc])
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    for bad in ((64, 128), (0, d + 16), (d, 16), (128, 8)):
        with pytest.raises(ValueError, match="out_cols"):
            qmatmul_w8a16_rows(x, w, 1, out_cols=bad)


def test_head_dim_256_model_card_matches_cpu(card):
    _head_dim_model_card_matches_cpu(card, 256)


def test_head_dim_512_model_card_matches_cpu(card):
    _head_dim_model_card_matches_cpu(card, 512)


@pytest.mark.parametrize("hd", [640, 1024])
def test_head_dim_past_512_model_card_matches_cpu(card, hd):
    _head_dim_model_card_matches_cpu(card, hd)


def _head_dim_model_card_matches_cpu(card, hd):
    """A 2-layer model of head_dim ``hd``, card against CPU within 2e-2 of the
    largest logit: a 300-row fresh window (#5), decode steps on the dense
    cache (#4), and on a page pool a group prefill, a continued window (#10)
    and decode steps (#9)."""
    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, qwen3_forward
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache

    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=hd, seq_len=512, vocab_size=1024, group_size=64, shared_classifier=True)
    weights = random_weights(cfg, seed=9, device=card)
    rng = np.random.default_rng(9)
    before = dict(LAUNCHES)
    engines = [Engine(config=cfg, weights=weights, device=card),
               Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")]
    caches = [e.new_cache() for e in engines]
    pos = 0
    for rows in (300, 1, 1):
        toks = rng.integers(0, cfg.vocab_size, (1, rows))
        (lc, caches[0]), (lp, caches[1]) = (e.prefill(c, toks, [pos]) for e, c in zip(engines, caches))
        assert float((lc.float().cpu() - lp.float()).abs().max()) <= 2e-2 * float(lp.float().abs().max()), rows
        pos += rows
    ws = [cast_weight_scales(weights), cast_weight_scales(weights_to(weights, "cpu"))]
    pools = [init_paged_cache(cfg, 9, 128, device=d) for d in (card, "cpu")]
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    pos = np.array([0, 0])
    for rows, fresh in ((40, True), (8, False), (1, False), (1, False)):
        toks = rng.integers(0, cfg.vocab_size, (2, rows))
        outs = [qwen3_forward(cfg, w, toks, pool, pos, page_table=table, fresh_prefill=fresh)[0]
                for w, pool in zip(ws, pools)]
        assert float((outs[0].float().cpu() - outs[1]).abs().max()) <= 2e-2 * float(outs[1].abs().max()), rows
        pos = pos + rows
    torch.cuda.synchronize()
    made = {k: LAUNCHES[k] - before[k] for k in ("flash_decode", "causal_prefill_attention", "paged_decode",
                                                 "paged_window_partials")}
    assert all(made.values()), made


# ------------------------------------------------------- measurement probes
@pytest.mark.parametrize("reps", [1, 2, 5])
@pytest.mark.parametrize("layers,n,d,g", [(3, 512, 4096, 64), (2, 256, 384, 64), (8, 1024, 24576, 64),
                                          (1, 4096, 4096, 64), (8, 4096, 4096, 64), (1, 768, 288, 6),
                                          (2, 40960, 256, 64)])
def test_boundary_onecall_matches_plain_and_qmatmul(card, layers, n, d, g, reps):
    """P1: every layer against its plain version and against #2, each rep
    overwriting the same values; the split counters end at zero and a
    repeated call is equal bit for bit."""
    import qwen3_rs_tpu_torch.ops.kernels.qmatmul as qm

    gen = _gen(layers + n + d)
    w = _weights(gen, card, layers, n, d, g)
    x = torch.randn(1, n, generator=gen, device=card)
    before = LAUNCHES["boundary_onecall"]
    got = boundary_onecall(x, w, reps)
    assert LAUNCHES["boundary_onecall"] == before + 1
    ref = boundary_onecall_plain(x, w)
    kern = torch.cat([qmatmul_w8a16(x, w, l) for l in range(layers)])
    torch.cuda.synchronize()
    tol = 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol and float((got - kern).abs().max()) <= tol
    assert all(int(t.abs().sum()) == 0 for t in qm._MMA_COUNTERS.values())
    assert torch.equal(boundary_onecall(x, w, reps), got) and torch.equal(boundary_onecall(x, w, 1), got)


@pytest.mark.parametrize("layers", [1, 3, 8])
@pytest.mark.parametrize("mat", ["wqkv", "wo", "w13", "w2"])
def test_boundary_onecall_walk_is_the_plan(card, mat, layers):
    """P1's kernel records the units of its first rep: the same as the
    Python mirror of its plan (``onecall_walk``), at the 8B matrices."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import _onecall_per_sm, _sm_count
    from qwen3_rs_tpu_torch.scripts.boundary_probe import matrices

    n, d = matrices("8b")[mat]
    gen = _gen(n + d + layers)
    w = _weights(gen, card, layers, n, d, 64)
    x = torch.randn(1, n, generator=gen, device=card)
    y, walk = boundary_onecall_walk(x, w)
    plan = onecall_plan(n, d, 64, layers, _sm_count(0), _onecall_per_sm(0, True))
    want = torch.tensor(onecall_walk(n, d, layers, *plan), dtype=torch.int32)
    assert torch.equal(walk.cpu(), want)
    assert torch.equal(y, boundary_onecall(x, w, 1))


@pytest.mark.parametrize("nbytes,span", [(16, 16), (4096 * 33, 4096), (3 << 20, 1 << 20), (40 << 20, 16 << 20),
                                         (1 << 20, (1 << 20) - 16)])
def test_hbm_stream_is_the_exact_sum(card, nbytes, span):
    gen = _gen(nbytes % 1000 + span % 777)
    x = torch.empty(nbytes, dtype=torch.int8, device=card).random_(-128, 128, generator=gen)
    x[: nbytes // 3] = -128  # long runs of the extreme code
    before = LAUNCHES["hbm_stream"]
    got = hbm_stream(x, span)
    assert LAUNCHES["hbm_stream"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, hbm_stream_plain(x, span))


@pytest.mark.parametrize("variant", ["deq-dot", "i8-seg", "i8-seg2"])
@pytest.mark.parametrize("b,tn,td", [(8, 4096, 1536), (1, 512, 48), (5, 1024, 64)]
                         + [(b, tn, td) for b in (1, 3, 8) for tn in (512, 4096) for td in (16, 1536)])
def test_head_a8_matches_plain(card, variant, b, tn, td):
    """P3 against its plain version at 1, 2, 33 and the default 32 sweeps
    (an odd count sweeps one tile once more), one launch each; a second
    launch gives the same bits (the split sums merge in a fixed order) and
    the column tiles' counters end at zero; the C grid is ``head_a8_grid``'s."""
    from qwen3_rs_tpu_torch.ops.kernels.probes import _lib, _sm_count, head_a8_grid
    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import _mma_counters
    from qwen3_rs_tpu_torch.scripts.head_a8_probe import inputs

    ops = inputs(b, tn, td, card, seed=b + tn + td)
    for sweeps in (None, 1, 2, 33):
        before = LAUNCHES["head_a8"]
        got = head_a8(variant, **ops, sweeps=sweeps)
        assert LAUNCHES["head_a8"] == before + 1
        again = head_a8(variant, **ops, sweeps=sweeps)
        ref = head_a8_plain(variant, **ops, sweeps=sweeps)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= HEAD_A8_RTOL[variant] * float(ref.abs().max()), (variant, sweeps)
        assert torch.equal(got, again), (variant, sweeps)
    assert not _mma_counters(card, td // 16)[: td // 16].any()
    sms = _sm_count(torch.cuda.current_device())
    assert _lib("head_a8_probe").head_a8_grid(["deq-dot", "i8-seg", "i8-seg2"].index(variant), tn, td, 2, sms) \
        == head_a8_grid(variant, tn, td, 2, sms)


@pytest.mark.parametrize("variant", ["bf16-full", "i8-seg64", "i8-full"])
@pytest.mark.parametrize("m,k,d", [(128, 64, 128), (256, 1024, 384), (384, 4096, 256), (128, 576, 128),
                                   (384, 576, 640)])
def test_a8_depth_matches_plain(card, variant, m, k, d):
    """P4: the int arms bit for bit (every partial sum is an integer below
    2^24), bf16-full within 1e-4 of the largest output (the tensor cores'
    f32 accumulation rounds toward zero)."""
    from qwen3_rs_tpu_torch.scripts.a8_depth_probe import inputs

    x, wt = inputs(m, k, d, card, seed=m + k + d)["bf16" if variant == "bf16-full" else "int8"]
    before = LAUNCHES["a8_depth"]
    got = a8_depth(variant, x, wt)
    assert LAUNCHES["a8_depth"] == before + 1
    ref = a8_depth_plain(variant, x, wt)
    torch.cuda.synchronize()
    if variant == "bf16-full":
        assert float((got - ref).abs().max()) <= A8_DEPTH_RTOL[variant] * float(ref.abs().max())
    else:
        assert torch.equal(got, ref)


def test_probe_wrappers_refuse_what_they_cannot_take(card):
    x = torch.zeros(128, 64, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="contiguous torch.bfloat16"):
        a8_depth("bf16-full", x, x)
    with pytest.raises(ValueError, match="multiples of 128"):
        a8_depth("i8-full", x[:64], x)
    with pytest.raises(ValueError, match="int8"):
        hbm_stream(torch.zeros(64, device=card), 16)
    w = _weights(_gen(3), card, 2, 256, 48, 64)
    with pytest.raises(ValueError, match="D=48 of 32"):
        boundary_onecall(torch.zeros(1, 256, device=card), w)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [128, 256, 384, 512, 640])
@pytest.mark.parametrize("page", [8, 16, 128])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
def test_paged_decode_batches_match_plain(card, pool, hd, page, kv_mul):
    """#9 at every B from 1 to 8 over positions 0, 1, 127, 128, 129, a page
    boundary and max_pages·page (the one-launch kernel at every head_dim here,
    past 256 its kernel past 256, on the CUDA cores for f32 pools and mma.sync
    for bf16 and INT8; pages of 8 rows: the two-pass kernels): within 1e-4·max|ref|
    of the plain version, exactly v_self at pos 0, each call one launch, two
    launches equal bit for bit."""
    gen = _gen(hd + 7 * kv_mul + page + len(pool))
    max_pages = -(-600 // page)
    full = max_pages * page
    positions = [full, 0, 1, 127, 128, 129, 3 * page, full - 1]
    n_kv = 2
    n_pages = 1 + 8 * max_pages
    k, v, sc = _cache_of(gen, card, pool, (2, n_pages, n_kv, page, hd))
    sc = {} if sc is None else dict(zip(("k_scale_pool", "v_scale_pool"), sc))
    for b in range(1, 9):
        pos_list = positions[:b]
        table = _tables(gen, card, b, max_pages, n_pages)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
        q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
        kn, vn = torch.randn(2, b, n_kv, hd, generator=gen, device=card)
        ref = paged_decode_plain(q, kn, vn, k, v, table, pos, 1, **sc)
        before = LAUNCHES["paged_decode"]
        got = paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
        again = paged_decode(q, kn, vn, k, v, table, pos, 1, **sc)
        torch.cuda.synchronize()
        assert LAUNCHES["paged_decode"] == before + 2
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), b
        assert torch.equal(got, again), b
        for i, p in enumerate(pos_list):
            if p == 0:
                assert torch.equal(got[i], vn[i].repeat_interleave(kv_mul, dim=0)), b


@pytest.mark.parametrize(
    "pos,n_kv,kv_mul,grid",
    [
        ([0, 1, 127, 128, 129, 1000, 2049, 4095], 8, 4, 264),
        ([4095], 8, 4, 264),
        ([0, 0, 0], 2, 3, 132),
        ([5000, 17, 300], 2, 12, 132),
        (list(range(0, 64 * 40, 40)), 8, 1, 512),
        (list(range(0, 200 * 20, 20)), 2, 2, 800),  # more than 128 requests: read past the lanes' registers
    ],
)
def test_paged_decode_kernel_plan_is_decode_units(card, pos, n_kv, kv_mul, grid):
    """The plan the one-launch #9 kernel's blocks make from the positions on
    the card, read back block by block, is ``decode_units``'s, unit for unit
    (the CPU tests' cases of ``decode_plan``, and one past 128 requests)."""
    from qwen3_rs_tpu_torch.ops.kernels.paged_attention import decode_grid, decode_units, paged_decode_kernel_plan

    page, max_pages = 128, 32
    grid = max(grid, decode_grid(len(pos), n_kv, kv_mul, 1, 1))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
    assert paged_decode_kernel_plan(pos_t, n_kv, kv_mul, page, max_pages, grid) == decode_units(
        pos, n_kv, kv_mul, page, max_pages, grid)


def test_paged_decode_counters_stay_zero(card):
    """The one-launch kernel's arrival counters are zero after every launch
    (a CUDA graph can replay it), and a replay in a graph gives the same
    output bit for bit."""
    from qwen3_rs_tpu_torch.ops.kernels import paged_attention as pa

    gen = _gen(77)
    page, max_pages, pos_list = 128, 32, [4095, 1000, 0, 2049]
    b = len(pos_list)
    n_pages = 1 + b * max_pages
    k, v, _ = _cache_of(gen, card, "bf16", (2, n_pages, 8, page, 128))
    table = _tables(gen, card, b, max_pages, n_pages)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn(b, 32, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, b, 8, 128, generator=gen, device=card)
    first = paged_decode(q, kn, vn, k, v, table, pos, 1)
    torch.cuda.synchronize()
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0
    out = {}
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        paged_decode(q, kn, vn, k, v, table, pos, 1)  # warm-up on the capture stream
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out["x"] = paged_decode(q, kn, vn, k, v, table, pos, 1)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["x"], first)
    assert int(pa._DECODE_COUNTERS[first.device].abs().sum()) == 0


# ------------------------------------------------------ speculative decoding
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_spec_round_batched_card_matches_cpu(card, pool, monkeypatch):
    """One batched speculative round (k = 3, 4 slots, one idle) over a page
    pool (pages of 128 rows) after a fresh prefill, on the card and on the CPU: the verify
    window's #10 partials within #10's tolerance of the plain version on the
    same inputs, its logits within 2e-2·max|cpu|, and the same tokens,
    counts, next tokens, positions and histories.  The window of 16 rows
    takes #3's tensor-core route and #10, each layer."""
    import qwen3_rs_tpu_torch.ops.kernels.paged_attention as pa
    from qwen3_rs_tpu_torch.inference import speculative
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache

    cfg = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=512, vocab_size=2176, group_size=64, shared_classifier=True)
    weights = port_qwen3.cast_weight_scales(random_weights(cfg, seed=9, device=card))
    weights = weights._replace(rms_final=weights.rms_final * 20)  # peaked: no near-ties
    k, b, page, plen = 3, 4, 128, 24  # #10 takes pages of a multiple of 128 (the reference's gate)
    rng = np.random.default_rng(9)
    prompts = rng.integers(3, cfg.vocab_size, (b, plen))
    table = np.arange(1, 1 + b * 2, dtype=np.int32).reshape(b, 2)
    active = np.array([True, True, False, True])
    seen, real = [], pa.paged_window_partials

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out))
        return out

    monkeypatch.setattr(pa, "paged_window_partials", spy)
    dtype = "int8" if pool == "int8" else torch.bfloat16
    results = []
    for dev, w in ((card, weights), ("cpu", weights_to(weights, "cpu"))):
        cache = init_paged_cache(cfg, 1 + b * 2, page, dtype=dtype, device=dev)
        logits, cache = port_qwen3.qwen3_forward(cfg, w, prompts, cache, np.zeros(b, np.int64), page_table=table,
                                                 fresh_prefill=True)
        cur = logits.float().cpu().argmax(-1).to(torch.int32)
        if dev == card:
            first = cur
        hist = torch.zeros(b, cfg.seq_len, dtype=torch.int32)
        hist[:, :plen] = torch.as_tensor(prompts)
        hist[:, plen] = first
        got = {}

        def forward(window, cache, pos, **kw):
            lg, cache = port_qwen3.qwen3_forward(cfg, w, window, cache, pos, **kw)
            got["logits"] = lg.float().cpu()
            return lg, cache

        carry = (first.to(dev), cache, np.full(b, plen, np.int64), hist.to(dev),
                 torch.full((b,), plen + 1, dtype=torch.int32, device=dev), np.zeros(b, np.float32),
                 np.ones(b, np.float32), torch.Generator(device=dev))
        before = dict(LAUNCHES)
        n_seen = len(seen)
        (nxt, cache, pos, hist, hlen, *_), (toks, counts) = speculative.spec_round_batched(
            forward, carry, k, table, active)
        if dev == card:
            assert LAUNCHES["paged_window_partials"] - before["paged_window_partials"] == cfg.n_layers
            assert LAUNCHES["qmatmul_w8a16_tc"] - before["qmatmul_w8a16_tc"] == 4 * cfg.n_layers + 1
            for args, kw, out in seen[n_seen:]:
                cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
                ref = pa.paged_window_partials_plain(*cpu, **{n: None if t is None else t.cpu() for n, t in kw.items()})
                _window_holds([t.cpu() for t in out], ref)
        results.append((got["logits"], toks.cpu(), counts, nxt.cpu(), pos, hist.cpu(), hlen.cpu()))
    (lg, *a), (lc, *c) = results
    assert float((lg - lc).abs().max()) <= 2e-2 * float(lc.abs().max())
    for x, y in zip(a, c):
        x, y = np.asarray(x), np.asarray(y)
        if x.ndim == 2 and x.shape == (b, k + 1):  # the idle slot's row is not emitted
            x, y = x[active], y[active]
        np.testing.assert_array_equal(x, y)


def test_decode_chunk_spec_8b_widths_is_the_greedy_stream(card):
    """decode_chunk_spec on a 2-layer model with the 8B's widths: each round
    one window of k + 1 = 5 rows through #3's mma route (4·L + 1 launches)
    and the plain split attention; the stream is plain greedy's (the
    megakernel's ``decode_chunk``), a parting allowed only at a near-tie of
    2e-2·max|logits| on the shared history."""
    from qwen3_rs_tpu_torch.testing import qwen3_config

    cfg = qwen3_config("8b", seq_len=512, n_layers=2)
    weights = random_weights(cfg, seed=11, device=card)
    eng = Engine(config=cfg, weights=weights, device=card)
    prompt = [int(t) for t in np.random.default_rng(11).integers(3, 1000, 12)] * 3
    logits, cache = eng.prefill(eng.new_cache(), np.asarray([prompt]), [0])
    cur = int(logits.float().argmax())
    n_rounds, k = 8, 4
    before = dict(LAUNCHES)
    toks, counts, _ = eng.decode_chunk_spec(cache, cur, len(prompt), n_rounds, k, prompt + [cur])
    assert LAUNCHES["qmatmul_w8a16_mma"] - before["qmatmul_w8a16_mma"] == n_rounds * (4 * cfg.n_layers + 1)
    spec = [cur] + [int(t) for r in range(n_rounds) for t in toks[r, : counts[r]]]
    logits, cache = eng.prefill(eng.new_cache(), np.asarray([prompt]), [0])
    plain, _ = eng.decode_chunk(cache, cur, len(prompt), len(spec) - 1)
    plain = [cur] + [int(t) for t in plain]
    if spec != plain:
        i = next(j for j, (x, y) in enumerate(zip(spec, plain)) if x != y)
        lg, _ = eng.prefill(eng.new_cache(), np.asarray([prompt + plain[:i]]), [0])
        lg = lg[0].float()
        assert float((lg[spec[i]] - lg[plain[i]]).abs()) <= 2e-2 * float(lg.abs().max()), i
        assert spec[:i] == plain[:i]


# ------------------------------------------------- sequence and pipeline ranks
@pytest.mark.parametrize("n_heads,n_kv", [(6, 2), (5, 1)])
def test_ring_on_two_ranks_of_the_card_matches_the_plain_attention(card, n_heads, n_kv):
    """Ring attention on 2 ranks sharing the card (gloo, the K/V blocks
    staged through the host) at ragged head counts and a length of 96 rows,
    whole and inner form, against the dense causal attention on the CPU at
    1e-4; every block's product ran on the card."""
    from torch_tp_ranks import Ranks, ring

    from qwen3_rs_tpu_torch.ops.attention import gqa_attention

    gen = torch.Generator().manual_seed(n_heads)
    b, s, hd = 2, 96, 128
    q = torch.randn(b, s, n_heads, hd, generator=gen)
    k, v = torch.randn(2, b, s, n_kv, hd, generator=gen)
    group = Ranks([str(card) + ":0"] * 2, "sp")
    try:
        assert group.mesh.backend == "gloo"
        got, inner = group.run(ring, q, k, v)
    finally:
        group.close()
    ref = gqa_attention(q, k.transpose(1, 2), v.transpose(1, 2), torch.arange(s)[None].expand(b, s))
    assert float((got - ref).abs().max()) <= 1e-4
    assert float((inner - ref[:, : s // 2]).abs().max()) <= 1e-4


def test_pipeline_on_two_ranks_of_the_card_matches_one_rank(card):
    """``pipelined_forward`` on 2 ranks sharing the card (0.6B widths, 4
    layers, B = 4, 2 microbatches): a 16-row prefill and 2 decode steps
    equal the one-rank pipeline's on the same weights (same microbatches,
    same routes), and each rank's #1-#3 launches are the schedule's: 3 ticks
    (bubbles included) × 2 layers × 4 projections at the microbatch's rows,
    and the classifier at B rows, a call."""
    from torch_tp_ranks import Ranks, pipeline_on_card

    from qwen3_rs_tpu_torch.ops.kernels.qmatmul import route
    from qwen3_rs_tpu_torch.parallel import create_pp_mesh
    from qwen3_rs_tpu_torch.testing import qwen3_config

    cfg = qwen3_config("0.6b", seq_len=64, n_layers=4)
    rng = np.random.default_rng(2)
    calls = [(rng.integers(3, 1000, (4, 16)), np.zeros(4, np.int64))]
    calls += [(rng.integers(3, 1000, (4, 1)), np.full(4, 16 + i, np.int64)) for i in range(2)]
    group = Ranks([str(card) + ":0"] * 2, "pp")
    try:
        got, counts = group.run(pipeline_on_card, cfg, 5, calls, 2)
    finally:
        group.close()
    one, _ = pipeline_on_card(create_pp_mesh(1, [card]), cfg, 5, calls, 2)
    for g, o in zip(got, one):
        assert g.shape == (4, cfg.vocab_size)
        assert float((g - o).abs().max()) <= 1e-5 * float(o.abs().max())
    keys = {"row": "qmatmul_w8a16", "mma": "qmatmul_w8a16_mma", "tc": "qmatmul_w8a16_tc"}
    want = {}
    for tokens, _ in calls:
        mb_rows = tokens.shape[1] * 2
        want[keys[route(mb_rows)]] = want.get(keys[route(mb_rows)], 0) + 3 * 2 * 4
        want[keys[route(4)]] = want.get(keys[route(4)], 0) + 1
    for c in counts:
        assert {k: v for k, v in c.items() if v} == want, c

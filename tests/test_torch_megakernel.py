"""Whole-step decode megakernel: the port's plain version against the JAX
package's ``decode_stack_megakernel`` in interpret mode, and its gate against
the JAX gate.

Inputs come from a numpy seed; weight scales are powers of two (``code ·
scale`` is exact in bf16, which XLA on the CPU would not round).  The
configuration (dim 512, hidden 1024, 4/2 heads, head_dim 128, g 64, 256 cache
rows, 2 layers) passes the JAX gate; the classifier is padded to 2048 columns
past its 2000-entry vocabulary, as the loader pads one, and its padded
columns are not zero here, so that the greedy head must mask them.

Tolerances.  Both sides take the same bf16 roundings (activations at each
dot, weights as ``bf16(code) · bf16(scale)``) and f32 everywhere else, and
agree to ~5e-7 of the largest value; but an f32 sum in another order now and
then flips one bf16 rounding of an activation, which moves a row of the
stream by ~1e-3 of its largest value here (seen on about one row in three at
position 255).  So every row is held within 5e-3 of the largest value, and
the logits within 1e-2 of theirs; an error of the algorithm (a missing
residual, a norm, RoPE, a row attended or not) moves them by O(1).  A row
written into an INT8 cache may differ by one code where its value sits on a
rounding boundary.  Rows that must not change are compared bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights

from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.ops.pallas.megakernel import decode_stack_megakernel as jax_megakernel
from qwen3_rs_tpu.ops.pallas.megakernel import head_phase_supported as jax_head_gate
from qwen3_rs_tpu.ops.pallas.megakernel import megakernel_supported as jax_gate
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels import megakernel as mk
from qwen3_rs_tpu_torch.ops.kernels.megakernel import (
    barrier_wait_share,
    barriers_per_step,
    decode_stack_megakernel,
    decode_stack_megakernel_plain,
    head_phase_supported,
    megakernel_supported,
    phase_breakdown,
    phase_names,
    schedule,
)
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
from qwen3_rs_tpu_torch.testing import QWEN3_CONFIGS

torch.set_num_threads(2)

CFG = ModelConfig(
    architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
    seq_len=256, vocab_size=2000, group_size=64, shared_classifier=True,
)
V_PAD = 2048
T = CFG.seq_len
X_TOL, LOGIT_TOL = 5e-3, 1e-2


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.cache
def _weights():
    tree = jax_numpy_weights(CFG, 11)
    return tree, weights_from_jax_numpy(tree)


def _head(tree, plant=None):
    """The classifier padded to V_PAD columns (f32 codes → int8, scales);
    the padded columns hold random codes with unit scales, so that their
    logits are far from 0.  ``plant`` = (row k, sign, columns, pad column):
    each column gets the one code 127·sign at row k with scale 8, the pad
    column the same with scale 16; nothing else in those columns."""
    rng = np.random.default_rng(5)
    q = np.concatenate([np.asarray(tree.lm_head.q), rng.integers(-127, 128, (CFG.dim, V_PAD - CFG.vocab_size))], 1)
    s = np.concatenate([np.asarray(tree.lm_head.scales.astype(jnp.float32)),
                        np.ones((CFG.dim // 64, V_PAD - CFG.vocab_size), np.float32)], 1)
    q = q.astype(np.int8)
    if plant is not None:
        k, sign, cols, pad_col = plant
        for c, sc in [(c, 8.0) for c in cols] + [(pad_col, 16.0)]:
            q[:, c] = 0
            q[k, c] = 127 * sign
            s[:, c] = sc
    return q, s


def _inputs(cache, b, seed):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, b, CFG.n_kv_heads, T, CFG.head_dim)
    x = rng.normal(0, 1, (b, CFG.dim)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, CFG.head_dim // 2)).astype(np.float32)
    if cache == "int8":
        kv = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        sc = [rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        kv = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(2)]
        if cache == "bf16":
            kv = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in kv]
        sc = [None, None]
    return x, np.cos(ang), np.sin(ang), kv, sc


def _torch(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _run_both(cache, pos, write_ok, head, greedy, seed):
    """One step on each side from the same inputs: (JAX out, port out, the
    caches before)."""
    tree, pw = _weights()
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    x, cos, sin, (k, v), (ks, vs) = _inputs(cache, len(pos), seed)
    hq, hs = head
    lw = jax.tree.map(jnp.asarray, tree.layers)
    jhead = JaxQT(jnp.asarray(hq), jnp.asarray(hs).astype(jnp.bfloat16))
    jout = jax_megakernel(
        jcfg, jnp.asarray(x), lw.rms_att, lw.rms_ffn, lw.q_norm, lw.k_norm, jnp.asarray(cos), jnp.asarray(sin),
        lw.wqkv, lw.wo, lw.w13, lw.w2, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32),
        jnp.asarray(tree.rms_final), jhead, jnp.asarray(write_ok, jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs),
        eps=CFG.norm_eps, interpret=True, greedy=greedy,
    )
    jout = jax.tree.map(np.asarray, jout)
    caches = [_torch(a) for a in (k, v, ks, vs)]
    plw = pw.layers
    before = LAUNCHES["decode_megakernel"]
    px, phead = decode_stack_megakernel(
        CFG, _torch(x), plw.rms_att, plw.rms_ffn, plw.q_norm, plw.k_norm, _torch(cos), _torch(sin),
        plw.wqkv, plw.wo, plw.w13, plw.w2, caches[0], caches[1], torch.tensor(pos, dtype=torch.int32),
        pw.rms_final, QuantizedTensor(_torch(hq), _torch(hs).to(torch.bfloat16)),
        torch.tensor(write_ok, dtype=torch.int32), k_scale=caches[2], v_scale=caches[3],
        eps=CFG.norm_eps, greedy=greedy,
    )
    assert LAUNCHES["decode_megakernel"] == before  # a CPU tensor takes the plain version
    return jout, (px, caches, phead), (k, v, ks, vs)


CACHES = ["f32", "bf16", "int8"]


@pytest.mark.parametrize("cache", CACHES)
def test_plain_matches_jax_interpret_mixed_batch(cache):
    """B = 3 at positions 0, 100 and 255 (the last row), the middle row's
    write gate off; the fused head's logits."""
    pos, write_ok = [0, 100, T - 1], [1, 0, 1]
    tree, _ = _weights()
    (jx, jcache, jlogits), (px, pcache, plogits), before = _run_both(
        cache, pos, write_ok, _head(tree), False, seed=len(cache))
    for b in range(3):
        assert _rel(px[b].numpy(), jx[b]) <= X_TOL, b
        assert _rel(plogits[b].numpy(), jlogits[b]) <= LOGIT_TOL, b
    assert plogits.shape == (3, V_PAD)
    quant = cache == "int8"
    for part in range(2):
        out, ref, old = _f32(pcache[part]), _f32(jcache[part]), _f32(before[part])
        # Row 1 writes nothing, nor does any other position: bit for bit.
        keep = np.ones(out.shape[:-1], bool)
        keep[:, 0, :, pos[0]] = keep[:, 2, :, pos[2]] = False
        assert np.array_equal(out[keep], old[keep]) and np.array_equal(ref[keep], old[keep])
        new, new_ref = out[~keep], ref[~keep]
        if quant:
            assert np.abs(new - new_ref).max() <= 1  # one code at a rounding boundary
            s_out, s_ref, s_old = _f32(pcache[2 + part]), _f32(jcache[2 + part]), before[2 + part]
            assert np.array_equal(s_out[keep], s_old[keep]) and np.array_equal(s_ref[keep], s_old[keep])
            assert _rel(s_out[~keep], s_ref[~keep]) <= X_TOL
        else:
            assert _rel(new, new_ref) <= X_TOL
            assert not np.array_equal(new, old[~keep])  # the rows were written


@pytest.mark.parametrize("cache", CACHES)
def test_greedy_head_takes_the_first_max_and_masks_the_padding(cache):
    """B = 1 at position 77, greedy.  Two real columns (123 and 1500) carry
    the same single code at the row of the largest normalized activation, so
    their logits tie exactly and are the largest; a padded column carries it
    at twice the scale.  The token is 123 on both sides (the last maximum
    would be 1500, an unmasked head 2010)."""
    tree, pw = _weights()
    x, cos, sin, (k, v), (ks, vs) = _inputs(cache, 1, seed=7)
    # The final stream of this step does not depend on the classifier.
    plw = pw.layers
    xs, _ = decode_stack_megakernel_plain(
        CFG, _torch(x), plw.rms_att, plw.rms_ffn, plw.q_norm, plw.k_norm, _torch(cos), _torch(sin),
        plw.wqkv, plw.wo, plw.w13, plw.w2, _torch(k), _torch(v), torch.tensor([77], dtype=torch.int32),
        k_scale=_torch(ks), v_scale=_torch(vs), eps=CFG.norm_eps,
    )
    xn = (xs * torch.rsqrt((xs * xs).mean(-1, keepdim=True) + CFG.norm_eps) * pw.rms_final)[0]
    kmax = int(xn.abs().argmax())
    head = _head(tree, plant=(kmax, 1 if xn[kmax] > 0 else -1, (123, 1500), 2010))
    (jx, jcache, jtok), (px, pcache, ptok), _ = _run_both(cache, [77], [1], head, True, seed=7)
    assert int(jtok[0]) == int(ptok[0]) == 123
    assert ptok.dtype == torch.int32
    assert _rel(px[0].numpy(), jx[0]) <= X_TOL
    out, ref = _f32(pcache[0])[:, 0, :, 77], _f32(jcache[0])[:, 0, :, 77]
    assert (np.abs(out - ref).max() <= 1) if cache == "int8" else _rel(out, ref) <= X_TOL


def test_logits_of_the_plain_greedy_and_full_head_agree():
    """The plain greedy token is the first maximum of the plain logits over
    the real vocabulary."""
    tree, pw = _weights()
    x, cos, sin, (k, v), _ = _inputs("f32", 2, seed=3)
    hq, hs = _head(tree)
    plw = pw.layers
    args = (CFG, _torch(x), plw.rms_att, plw.rms_ffn, plw.q_norm, plw.k_norm, _torch(cos), _torch(sin),
            plw.wqkv, plw.wo, plw.w13, plw.w2)
    head = QuantizedTensor(_torch(hq), _torch(hs).to(torch.bfloat16))
    pos = torch.tensor([5, 9], dtype=torch.int32)
    _, logits = decode_stack_megakernel_plain(*args, _torch(k), _torch(v), pos, pw.rms_final, head)
    _, tok = decode_stack_megakernel_plain(*args, _torch(k), _torch(v), pos, pw.rms_final, head, greedy=True)
    assert torch.equal(tok, logits[:, : CFG.vocab_size].argmax(-1).to(torch.int32))
    with pytest.raises(ValueError, match="fused head"):
        decode_stack_megakernel_plain(*args, _torch(k), _torch(v), pos, greedy=True)


def _gate_grid():
    """(config, cache rows, cache dtype, batch): the configurations of the
    port's tests, Qwen3 0.6B/4B/8B widths, 8B at ctx 4096 with B 1, 8 and 9,
    INT8 caches, and windows the INT8 scale block or the block sizes refuse."""
    tiny = dict(architecture_id=1, n_layers=2, head_dim=128, group_size=64, shared_classifier=True)
    configs = [
        ModelConfig(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, seq_len=256, vocab_size=2176, **tiny),
        ModelConfig(dim=256, hidden_dim=384, n_heads=2, n_kv_heads=1, seq_len=128, vocab_size=512, **tiny),
        ModelConfig(dim=256, hidden_dim=512, n_heads=2, n_kv_heads=1, seq_len=128, vocab_size=512, **tiny),
        CFG,
        dataclasses.replace(CFG, group_size=32),
    ]
    for name in ("0.6b", "4b", "8b"):
        spec = dict(QWEN3_CONFIGS[name], n_layers=2)
        configs.append(ModelConfig(architecture_id=1, seq_len=4096, group_size=64, shared_classifier=True, **spec))
    cases = []
    for c in configs:
        for t in sorted({c.seq_len, 200, 384, 4096}):
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                for b in (1, 3, 8, 9):
                    cases.append((c, t, dt, b))
    return cases


def test_gate_agrees_with_the_jax_gate(monkeypatch):
    monkeypatch.delenv("QWEN3_TPU_DISABLE_MEGAKERNEL", raising=False)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}
    seen, heads = set(), set()
    monkeypatch.delenv("QWEN3_TPU_MEGA_Q4", raising=False)  # the JAX default: Q4 stays off
    for c, t, dt, b in _gate_grid():
        jc = JaxConfig(**dataclasses.asdict(c))
        got = megakernel_supported(c, t, dt, b)
        assert got == jax_gate(jc, t, jdt[dt], b), (c, t, dt, b)
        # INT4 weights: both gates refuse every shape.
        assert megakernel_supported(c, t, dt, b, q4=True) == jax_gate(jc, t, jdt[dt], b, q4=True) is False
        seen.add((c.dim, got))
        if c not in heads:
            heads.add(c)
            for v_pad in (c.vocab_size, 2048, 153600):
                assert head_phase_supported(c, v_pad) == jax_head_gate(jc, v_pad), (c.dim, v_pad)
    assert (256, False) in seen and (4096, True) in seen and (512, True) in seen
    big = ModelConfig(architecture_id=1, seq_len=4096, group_size=64, shared_classifier=True,
                      **QWEN3_CONFIGS["8b"])
    assert megakernel_supported(big, 4096, torch.float32, 1) and megakernel_supported(big, 4096, "int8", 8)
    assert not megakernel_supported(big, 4096, torch.float32, 9)
    assert not megakernel_supported(big, 4096, torch.float32, 1, q4=True)
    assert head_phase_supported(big, 153600)


# ------------------------------------------------- the kernel's schedule (mirror)
def _schedule_configs():
    """(config, classifier columns, grid): Qwen3-8B on the H100's 132 SMs and
    the card tests' small widths (a dim that is not a multiple of 512)."""
    spec = dict(QWEN3_CONFIGS["8b"])
    big = ModelConfig(architecture_id=1, seq_len=4096, group_size=64, shared_classifier=True, **spec)
    small = dict(architecture_id=1, n_layers=2, head_dim=128, seq_len=200, vocab_size=1000,
                 shared_classifier=True)
    return [
        (big, 153600, 132),
        (ModelConfig(dim=512, hidden_dim=768, n_heads=12, n_kv_heads=1, group_size=64, **small), 1024, 132),
        (ModelConfig(dim=640, hidden_dim=896, n_heads=5, n_kv_heads=1, group_size=128, **small), 1024, 132),
        (ModelConfig(dim=640, hidden_dim=896, n_heads=5, n_kv_heads=1, group_size=32, **small), None, 7),
    ]


@pytest.mark.parametrize("q4", [False, True])
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("which", range(4))
def test_schedule_streams_every_item_once(which, b, q4):
    """Every (strip, split) of every matmul phase is one block's, its code
    rows streamed once in stages of at most ``chunk_rows`` rows whose scale
    groups fit the stage's slots; the ring fits the shared memory; the
    plans' splits are whole 64-row (INT4: 128) multiples."""
    cfg, v_pad, grid = _schedule_configs()[which]
    s = schedule(cfg, b, grid, v_pad, q4)
    ring = s.ring
    assert ring.smem_bytes <= mk.SMEM_BYTES and 2 <= ring.n_stages <= mk.MAX_STAGES
    assert ring.stage_bytes >= 4 * ring.chunk_rows * mk.BOX_COLS + ring.scale_slots * mk.SCALE_STRIDE
    assert ring.stage_bytes % mk.ALIGN == 0 and ring.chunk_rows % 16 == 0
    assert [m.name for m in s.mats] == ["wqkv", "wo", "w13", "w2"] + (["lm_head"] if v_pad else [])
    assert len(s.phases) == s.barriers + 1
    for m in s.mats:
        n, d, splits, kc, mq4 = m.n, m.d, m.splits, m.kc, m.q4
        assert kc % (128 if mq4 else 64) == 0 and (splits - 1) * kc < n <= splits * kc, m.name
        assert m.strips == -(-d // 512)  # w13's strips pair 256 gate and 256 up columns
        assert m.group_rows == (cfg.group_size // 2 if mq4 else cfg.group_size)
        rows = {}
        for blk in range(grid):
            stages = mk.block_stages(m, ring, grid, blk)
            for si, ki, r0, nrows, nscale in stages:
                assert (ki * m.strips + si) % grid == blk  # item it = ki * strips + si, dealt round robin
                assert 0 < nrows <= ring.chunk_rows and r0 % ring.chunk_rows == 0
                assert 1 <= nscale <= ring.scale_slots, (m.name, nscale)
                rows.setdefault((si, ki), []).append((r0, nrows))
            # The consumers walk each item in staged pieces of PIECE slots (INT4: PIECE / 2 packed
            # rows) and each piece in stages: the producer's stages, one for one.
            piece = mk.PIECE // 2 if mq4 else mk.PIECE
            walk = []
            for it in range(blk, m.strips * splits, grid):
                si, ki, _, c0, c1 = mk.item_of(n, d, splits, kc, mq4, it, m.paired)
                for p0 in range(c0, c1, piece):
                    p1 = min(c1, p0 + piece)
                    walk += [(si, ki, r0, min(ring.chunk_rows, p1 - r0)) for r0 in range(p0, p1, ring.chunk_rows)]
            assert walk == [st[:4] for st in stages], (m.name, blk)
        assert set(rows) == {(si, ki) for si in range(m.strips) for ki in range(splits)}, m.name
        for (si, ki), runs in rows.items():
            c0, c1 = (ki * kc, min(n, ki * kc + kc))
            c0, c1 = (c0 // 2, c1 // 2) if mq4 else (c0, c1)
            got = [r for r0, nr in runs for r in range(r0, r0 + nr)]
            assert got == list(range(c0, c1)), (m.name, si, ki)  # in order, each row once


@pytest.mark.parametrize("n_layers", [1, 2, 36])
def test_barriers_stay_within_six_a_layer(n_layers):
    for head, greedy in ((False, False), (True, False), (True, True)):
        bars = barriers_per_step(n_layers, head, greedy)
        names = phase_names(n_layers, head, greedy)
        assert bars == len(names) - 1
        assert bars <= 6 * n_layers
    assert barriers_per_step(36, True, True) == 181  # 325 before the ring


def test_phase_breakdown_reads_the_stamps():
    """Two blocks, two layers of one phase each: work is the last finish
    minus the first release, barrier the first leave minus the last
    finish, spread the finishes' range, wait each block's own time at the
    barrier, meaned; medians over the layers."""
    names = ["wqkv", "wqkv", "head"]
    st = torch.zeros(2, 4, 2, dtype=torch.int64)
    # (finish, leave) in ns per block and slot; slot 0 the start.
    st[:, 0] = torch.tensor([[1000, 1000], [1500, 1500]])
    st[:, 1] = torch.tensor([[4000, 6000], [5000, 6500]])
    st[:, 2] = torch.tensor([[8000, 11000], [10000, 11200]])
    st[:, 3] = torch.tensor([[20000, 20000], [21000, 21000]])
    out = phase_breakdown(st, names)
    # layer 0: work 5000 - 1000, barrier 6000 - 5000, spread 1000; layer 1: work 10000 - 6000,
    # barrier 11000 - 10000, spread 2000 (the median of two takes the lower)
    # wait: the blocks' own (leave - finish), meaned: layer 0 (2000 + 1500) / 2, layer 1 (3000 + 1200) / 2
    assert out["wqkv"] == {"work": 4.0, "barrier": 1.0, "spread": 1.0, "wait": 1.75, "count": 2}
    assert out["head"] == {"work": 10.0, "barrier": 0.0, "spread": 1.0, "wait": 0.0, "count": 1}
    # The mean block waits (5000 + 2700) / 2 ns of the 20000 from the first start to the last end.
    assert barrier_wait_share(st, names) == pytest.approx(3850 / 20000)
    with pytest.raises(ValueError, match="stamp slots"):
        phase_breakdown(st, names[:2])

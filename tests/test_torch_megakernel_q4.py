"""The whole-step decode megakernel on INT4 layers (the reference's Q4
tiles): the port's plain version against the JAX package's
``decode_stack_megakernel`` in interpret mode on the same packed codes, the
Q4 gate and tile plan against the JAX ones with and without
``QWEN3_TPU_MEGA_Q4=1``, and both forwards routing an INT4 decode step
through the megakernel under that opt-in.

The configuration is ``test_torch_megakernel.py``'s (dim 512, the smallest
width the gate admits); its four layer matrices are nibble-packed INT4 with
power-of-two scales (``bf16(code · scale)`` exact), the classifier INT8.

Tolerance: logits and written K/V rows within 2e-2 of the largest reference
magnitude, and the same argmax.  Both sides take the same bf16 roundings and
f32 sums in another order, which now and then flips one bf16 rounding of an
activation (~1e-3 of a row here); an error of the algorithm (a wrong nibble,
a group's scale, a missing residual) moves the logits by O(1).  Rows that
must not change are compared bit for bit; an INT8 cache row may differ by
one code at a rounding boundary.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_megakernel import CFG, T, V_PAD, _f32, _head, _inputs, _rel, _torch
from torch_parity import jax_numpy_weights, route_jax_through_interpret_megakernel

import qwen3_rs_tpu.ops.pallas.megakernel as jax_mega
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.megakernel import (
    _mk_tiles,
    decode_stack_megakernel,
    megakernel_supported,
    split_plan,
)
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor, QuantizedTensor
from qwen3_rs_tpu_torch.testing import QWEN3_CONFIGS

torch.set_num_threads(2)

TOL = 2e-2


@pytest.fixture(autouse=True)
def _opt_in(monkeypatch):
    monkeypatch.setenv("QWEN3_TPU_MEGA_Q4", "1")
    monkeypatch.delenv("QWEN3_TPU_DISABLE_MEGAKERNEL", raising=False)


@functools.cache
def _weights():
    tree = jax_numpy_weights(CFG, 13, bits=4)
    return tree, weights_from_jax_numpy(tree)


def _run_both(cache, pos, write_ok, greedy, seed, head=None):
    """One INT4 step on each side from the same inputs: (JAX out, port out,
    the caches before)."""
    tree, pw = _weights()
    assert isinstance(pw.layers.wqkv, Q4Tensor)
    x, cos, sin, (k, v), (ks, vs) = _inputs(cache, len(pos), seed)
    hq, hs = head if head is not None else _head(tree)
    lw = jax.tree.map(jnp.asarray, tree.layers)
    jout = jax_mega.decode_stack_megakernel(
        JaxConfig(**dataclasses.asdict(CFG)), jnp.asarray(x), lw.rms_att, lw.rms_ffn, lw.q_norm, lw.k_norm,
        jnp.asarray(cos), jnp.asarray(sin), lw.wqkv, lw.wo, lw.w13, lw.w2, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos, jnp.int32), jnp.asarray(tree.rms_final),
        JaxQT(jnp.asarray(hq), jnp.asarray(hs).astype(jnp.bfloat16)), jnp.asarray(write_ok, jnp.int32),
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs),
        eps=CFG.norm_eps, interpret=True, greedy=greedy,
    )
    jout = jax.tree.map(np.asarray, jout)
    caches = [_torch(a) for a in (k, v, ks, vs)]
    plw = pw.layers
    before = dict(LAUNCHES)
    px, phead = decode_stack_megakernel(
        CFG, _torch(x), plw.rms_att, plw.rms_ffn, plw.q_norm, plw.k_norm, _torch(cos), _torch(sin),
        plw.wqkv, plw.wo, plw.w13, plw.w2, caches[0], caches[1], torch.tensor(pos, dtype=torch.int32),
        pw.rms_final, QuantizedTensor(_torch(hq), _torch(hs).to(torch.bfloat16)),
        torch.tensor(write_ok, dtype=torch.int32), k_scale=caches[2], v_scale=caches[3],
        eps=CFG.norm_eps, greedy=greedy,
    )
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    return jout, (px, caches, phead), (k, v, ks, vs)


def _check_rows(cache, pcache, jcache, before, written):
    """Cache rows: the written (layer-independent) (row, position) pairs
    within TOL of the JAX kernel's, every other row bit for bit unchanged."""
    quant = cache == "int8"
    for part in range(2):
        out, ref, old = _f32(pcache[part]), _f32(jcache[part]), _f32(before[part])
        keep = np.ones(out.shape[:-1], bool)
        for b, p in written:
            keep[:, b, :, p] = False
        assert np.array_equal(out[keep], old[keep]) and np.array_equal(ref[keep], old[keep])
        new, new_ref = out[~keep], ref[~keep]
        if quant:
            assert np.abs(new - new_ref).max() <= 1  # one code at a rounding boundary
            s_out, s_ref = _f32(pcache[2 + part]), _f32(jcache[2 + part])
            assert np.array_equal(s_out[keep], _f32(before[2 + part])[keep])
            assert _rel(s_out[~keep], s_ref[~keep]) <= TOL
        else:
            assert _rel(new, new_ref) <= TOL
            assert not np.array_equal(new, old[~keep])  # the rows were written


@pytest.mark.parametrize("cache,pos,write_ok", [
    ("f32", [200], [1]),
    ("bf16", [T + 7, 100], [0, 1]),  # row 0 gated off, its position past the window
    ("int8", [131], [1]),
])
def test_plain_matches_jax_interpret(cache, pos, write_ok):
    (jx, jcache, jlogits), (px, pcache, plogits), before = _run_both(cache, pos, write_ok, False, seed=len(cache))
    assert plogits.shape == (len(pos), V_PAD)
    for b in range(len(pos)):
        assert np.isfinite(plogits[b].numpy()).all()
        assert _rel(px[b].numpy(), jx[b]) <= TOL, b
        assert _rel(plogits[b].numpy(), jlogits[b]) <= TOL, b
        assert int(plogits[b].argmax()) == int(np.argmax(jlogits[b])), b
    _check_rows(cache, pcache, jcache, before, [(b, p) for b, (p, ok) in enumerate(zip(pos, write_ok)) if ok])


def test_greedy_head_matches_jax_interpret():
    """B = 1 greedy at position 77 on an f32 cache, the classifier's real
    columns peaked by scale 8 on one planted column: the same token on both
    sides, the first max of the port's logits."""
    tree, _ = _weights()
    hq, hs = _head(tree)
    hs = hs.copy()
    hs[:, 321] *= 8.0  # a peaked fixture: one column well above the rest
    (jx, jcache, jtok), (px, pcache, ptok), before = _run_both("f32", [77], [1], True, seed=7, head=(hq, hs))
    assert ptok.dtype == torch.int32 and int(ptok[0]) == int(jtok[0])
    assert _rel(px[0].numpy(), jx[0]) <= TOL
    _check_rows("f32", pcache, jcache, before, [(0, 77)])


def _tile_cases():
    dims = [(4096, 6144), (4096, 4096), (4096, 24576), (12288, 4096),
            (1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024),
            (2560, 6144), (9728, 2560), (512, 1024), (1024, 512)]
    return [(n, d, g, fd) for n, d in dims for g in (32, 64, 128) for fd in (False, True)]


def test_q4_tile_plan_matches_jax(monkeypatch):
    monkeypatch.delenv("QWEN3_TPU_MEGA_Q4_ELEMS", raising=False)
    for n, d, g, fd in _tile_cases():
        for tb in (2 * 1024 * 1024, 6 * 1024 * 1024):
            for q4 in (False, True):
                want = jax_mega._mk_tiles(n, d, g, q4=q4, tile_bytes=tb, full_depth=fd)
                assert _mk_tiles(n, d, g, tb, full_depth=fd, q4=q4) == want, (n, d, g, fd, tb, q4)


def _gate_configs():
    out = []
    for name in ("0.6b", "4b", "8b"):
        for g in (32, 64, 128, 63):
            out.append(ModelConfig(architecture_id=1, seq_len=1024, group_size=g, shared_classifier=True,
                                   **dict(QWEN3_CONFIGS[name], n_layers=2)))
    out += [CFG, dataclasses.replace(CFG, group_size=32), dataclasses.replace(CFG, group_size=512)]
    return out


@pytest.mark.parametrize("opted_in", [False, True])
def test_q4_gate_matches_jax(monkeypatch, opted_in):
    """With and without the opt-in, over the 0.6B/4B/8B widths, the test
    configuration and an odd group size.  Where the port's kernel cannot take
    the group size (512: a staged 256-row tile would split the group), the
    port refuses what the JAX gate admits: it takes the per-layer path."""
    if not opted_in:
        monkeypatch.delenv("QWEN3_TPU_MEGA_Q4")
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}
    admitted = 0
    for c in _gate_configs():
        jc = JaxConfig(**dataclasses.asdict(c))
        for t in (256, 1024, 4096):
            for dt in jdt:
                for b in (1, 8, 9):
                    got = megakernel_supported(c, t, dt, b, q4=True)
                    want = jax_mega.megakernel_supported(jc, t, jdt[dt], b, q4=True)
                    if c.group_size == 512:
                        assert not got
                        continue
                    assert got == want, (c.dim, c.group_size, t, dt, b)
                    admitted += got
    assert (admitted > 0) == opted_in


def test_q4_split_plan_covers_the_contraction():
    """Splits of 64-row multiples (the kernel stages packed rows in order,
    so a split need not hold whole groups), over every row once."""
    for n, d in ((4096, 6144), (12288, 4096), (512, 1024), (1024, 512), (40, 256)):
        for g in (2, 6, 8, 32, 64, 128, 256, 512):
            for grid in (132, 264):
                splits, kc = split_plan(n, d, 1, grid, g, True)
                assert kc % 8 == 0 and (kc % 64 == 0 or kc >= n)
                assert splits == -(-n // kc) and (splits - 1) * kc < n <= splits * kc


class _Taken(Exception):
    pass


def test_both_forwards_take_the_megakernel_on_an_int4_step(monkeypatch):
    """An INT4 decode step over a dense f32 cache: with the opt-in, the JAX
    forward calls its megakernel and the port's forward calls its own (each
    stopped at the call); without it, the port's forward does not."""
    tree, pw = _weights()
    jw = jax.tree.map(jnp.asarray, tree)
    route_jax_through_interpret_megakernel(monkeypatch, min_seq_len=T)

    def stop(*a, **k):
        raise _Taken

    monkeypatch.setattr(jax_mega, "decode_stack_megakernel", stop)
    monkeypatch.setattr(port_qwen3, "decode_stack_megakernel", stop)
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    tok, pos = np.array([[5]]), np.array([3])
    with pytest.raises(_Taken):
        jax_forward(jcfg, jw, jnp.asarray(tok, jnp.int32), jax_init_cache(jcfg, 1, dtype=jnp.float32),
                    jnp.asarray(pos, jnp.int32), mode="fast")
    with pytest.raises(_Taken):
        qwen3_forward(CFG, pw, tok, init_kv_cache(CFG, 1, device="cpu"), pos)
    monkeypatch.setenv("QWEN3_TPU_MEGA_Q4", "0")
    logits, _ = qwen3_forward(CFG, pw, tok, init_kv_cache(CFG, 1, device="cpu"), pos)
    assert logits.shape == (1, CFG.vocab_size)

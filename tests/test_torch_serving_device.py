"""Serving with device sampling (the default of ``cli.py batch`` and
``serve``): the port's ``ContinuousBatchingEngine(sampling="device")``
against the JAX package's, and against itself.

* **Greedy streams equal the JAX engine's** on the dense slots and the page
  pool, at ``decode_chunk_steps=4`` with more requests than slots, the JAX
  engine through its Pallas kernels in interpret mode (``torch_parity``), its
  decode chunks a ``lax.scan`` on its key; the same ``stats()``.  A stream
  may part once per configuration, only at a near-tie: the two tokens'
  logits, on the history they share, within 2e-2 of the largest (the forwards
  agree but for an occasional flipped bf16 rounding; ROADMAP.md §3, note 5).
* **Sampled streams** (``-t 0.8``) repeat per seed, and every sampled token
  lies in its row's top-p nucleus.  They are not compared with ``jax.random``
  draws (note 9).
* An INT4 checkpoint on the dense slots with ``QWEN3_TPU_MEGA_Q4=1``: every
  decode step of every chunk goes through the megakernel's Q4 plain version,
  and its greedy streams equal host sampling's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, CONFIG, JCONFIG, PAGE, TOL, _drive, _prompts, _schedule, weights  # noqa: F401
from torch_parity import jax_numpy_weights, route_jax_through_interpret_kernels

import qwen3_rs_tpu_torch.serving.scheduler as port_scheduler
from qwen3_rs_tpu.serving import ContinuousBatchingEngine as JaxEngine
from qwen3_rs_tpu.serving import Request as JaxRequest
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

CHUNK = 4
LAYOUTS = {
    "dense": (dict(kv_layout="dense", n_slots=2), _schedule(_prompts(41, [5, 17, 9]), max_new=9)),
    "paged": (dict(kv_layout="paged", page_size=PAGE, n_slots=4),
              _schedule(_prompts(42, [6, 150, 3, 20]), max_new=10, at=[0, 0, 1, 3])),
}


def _near_tie(pw, history, a, b) -> bool:
    """Whether tokens ``a`` and ``b`` have logits within the tolerance after
    ``history`` (the port's forward on a fresh dense cache)."""
    logits, _ = qwen3_forward(CONFIG, pw, np.asarray([history]), init_kv_cache(CONFIG, 1, device="cpu"), [0])
    lg = logits[0].float()
    return float((lg[a] - lg[b]).abs()) <= TOL * float(lg.abs().max())


def _match(jax_done, port_done, pw, prompts):
    ref = {r.request_id: r for r in jax_done}
    got = {r.request_id: r for r in port_done}
    assert got.keys() == ref.keys()
    parted = []
    for rid, r in ref.items():
        g = got[rid]
        if (g.generated, g.finish_reason) == (r.generated, r.finish_reason):
            continue
        diff = [i for i, (a, b) in enumerate(zip(r.generated, g.generated)) if a != b]
        assert diff, f"request {rid}: {g.generated} {g.finish_reason} against {r.generated} {r.finish_reason}"
        i = diff[0]
        assert _near_tie(pw, list(prompts[rid]) + r.generated[:i], r.generated[i], g.generated[i]), (rid, i)
        parted.append((rid, i))
    assert len(parted) <= 1, f"streams part at {parted}"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_device_streams_match_jax(weights, layout, monkeypatch):  # noqa: F811
    calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    kw, schedule = LAYOUTS[layout]
    jw, pw, _ = weights
    common = dict(mode="fast", prefill_buckets=BUCKETS, sampling="device", decode_chunk_steps=CHUNK, seed=3, **kw)
    jax_engine = JaxEngine(config=JCONFIG, weights=jw, cache_dtype=jnp.bfloat16, **common)
    engine = ContinuousBatchingEngine(config=CONFIG, weights=pw, cache_dtype=torch.bfloat16, device="cpu", **common)
    _, ref_stats = _drive(jax_engine, schedule, JaxRequest)
    streams, stats = _drive(engine, schedule, Request)
    assert stats == ref_stats and set(stats) == set(ref_stats)
    prompts = {rid: p for reqs in schedule.values() for rid, p, *_ in reqs}
    _match(jax_engine.completed, engine.completed, pw, prompts)
    assert len(streams) == len(prompts) and all(len(t) > 0 for t, _ in streams.values())
    assert calls["fused"] and (calls["paged"] or layout == "dense")
    if engine.allocator is not None:
        assert stats["kv_pages_free"] == stats["kv_pages_total"]


def _recording_sampler(monkeypatch):
    """Every device draw of the port's engine: (logits, temperatures, top-p,
    tokens)."""
    seen = []
    real = port_scheduler.sample_tokens

    def sample(logits, generator, temperature, topp):
        out = real(logits, generator, temperature, topp)
        seen.append((logits.float().clone(), torch.as_tensor(temperature).clone(), torch.as_tensor(topp).clone(),
                     out.clone()))
        return out

    monkeypatch.setattr(port_scheduler, "sample_tokens", sample)
    return seen


def _in_nucleus(logits, t, p, tok) -> bool:
    probs = torch.softmax(logits / t, dim=-1)
    sp = torch.sort(probs, descending=True).values
    kept = sp[(torch.cumsum(sp, 0) - sp) <= p]
    return bool(probs[tok] >= kept.min())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_streams_repeat_per_seed_within_the_nucleus(weights, layout, monkeypatch):  # noqa: F811
    kw, schedule = LAYOUTS[layout]
    schedule = {k: [(rid, p, n, 0.8, s) for rid, p, n, _, s in v] for k, v in schedule.items()}
    runs = []
    for seed in (5, 5, 6):
        seen = _recording_sampler(monkeypatch)
        engine = ContinuousBatchingEngine(config=CONFIG, weights=weights[1], device="cpu", prefill_buckets=BUCKETS,
                                          sampling="device", decode_chunk_steps=CHUNK, seed=seed, **kw)
        runs.append(_drive(engine, schedule, Request)[0])
        drawn = 0
        for logits, temps, topps, toks in seen:
            for r in range(logits.shape[0]):
                t = float(temps.reshape(-1)[r]) if temps.dim() else float(temps)
                if t > 0:
                    p = float(topps.reshape(-1)[r]) if topps.dim() else float(topps)
                    assert _in_nucleus(logits[r], t, p, int(toks[r]))
                    drawn += 1
        assert drawn > 10
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_int4_dense_device_chunks_take_the_q4_megakernel(monkeypatch):
    """Dim 512 (the gate admits it) with INT4 layers and the opt-in: each
    chunk step is one megakernel step on Q4 stacks; greedy streams equal
    host sampling's on the same route."""
    monkeypatch.setenv("QWEN3_TPU_MEGA_Q4", "1")
    cfg = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024, n_layers=1, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=256, vocab_size=2000, group_size=64, shared_classifier=True)
    tree = jax_numpy_weights(cfg, 17, fast_scales=False, bits=4)
    tree = tree._replace(rms_final=tree.rms_final * 20.0)
    pw = weights_from_jax_numpy(tree)
    assert isinstance(pw.layers.wqkv, Q4Tensor)
    steps = []
    real = port_scheduler.megakernel_step

    def step(config, weights, *a, **k):
        steps.append(isinstance(weights.layers.wqkv, Q4Tensor))
        return real(config, weights, *a, **k)

    monkeypatch.setattr(port_scheduler, "megakernel_step", step)
    rng = np.random.default_rng(4)
    schedule = _schedule([list(rng.integers(3, 2000, n)) for n in (4, 11, 6)], max_new=6)
    out = {}
    for sampling in ("device", "host"):
        engine = ContinuousBatchingEngine(config=cfg, weights=pw, device="cpu", n_slots=2, prefill_buckets=(8, 16),
                                          sampling=sampling, decode_chunk_steps=CHUNK)
        out[sampling] = _drive(engine, schedule, Request)
    assert steps and all(steps) and len(steps) == out["device"][1]["decode_steps"]
    assert out["device"][0] == out["host"][0]
    assert all(len(t) == 6 for t, _ in out["device"][0].values())

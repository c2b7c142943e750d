"""Tensor parallelism: the port's ``parallel/`` and ``serve --tp`` against
the JAX package's tp code on its virtual CPU mesh.

* The helpers bit for bit: ``validate_tp``, ``local_config``,
  ``_tp_overlap_chunks`` at its defaults, ``interleave_for_tp`` (INT8 and
  INT4), and each rank's ``shard_weights_tp`` shard equal to the JAX shard
  on device r (the weight carry-over for tp).
* #6's column window: the plain version against the Pallas kernel in
  interpret mode at the windows of the JAX package's own test, and against
  the columns of the full plain product.
* The tp forward on 2 ranks (gloo on the CPU; rank 0 this process, rank 1
  spawned) against JAX ``make_tp_forward`` on a 2-device mesh, the JAX
  forward through its interpret-mode kernels, within 2e-2 of the largest
  logit, and against the port's own tp=1 forward: a fresh 512-row window
  (wo and w2 in 2 column chunks of 128 through #6's window), a 32-row
  window, a dense decode step, a paged group window and decode steps with a
  slot masked, and exact mode.
* The tp serving engine (paged pool, device sampling, greedy) on 2 ranks:
  its streams equal the JAX tp=2 engine's and the port's tp=1 engine's, a
  parting allowed only at a near-tie as in ``test_torch_serving_device``,
  and every rank emitted the same streams; an INT4 checkpoint too.
* ``cli.py serve --tp 2 --device cpu,cpu`` in a process of its own: its
  completion equals the API's, and SIGTERM leaves no rank behind.
"""

import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, CONFIG as SERVE_CONFIG, JCONFIG as SERVE_JCONFIG, _drive, _prompts, _schedule
from test_torch_serving import weights  # noqa: F401  (the serving fixture's weights)
from test_torch_serving_device import _match
from torch_parity import jax_numpy_weights, route_jax_q4_through_interpret_kernels, route_jax_through_interpret_kernels
from torch_tp_ranks import mesh_report, model, run_calls
from utils import make_hf_model_dir

import qwen3_rs_tpu.models.qwen3 as jax_qwen3
import qwen3_rs_tpu.ops.pallas.qmatmul as jax_qmm
import qwen3_rs_tpu.parallel.sharding as jax_sharding
import qwen3_rs_tpu.parallel.tp as jax_tp
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.ops.pallas.qmatmul import qmatmul_pallas_stacked_rows
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu.parallel.mesh import create_mesh as jax_create_mesh
from qwen3_rs_tpu.serving import ContinuousBatchingEngine as JaxEngine
from qwen3_rs_tpu.serving import Request as JaxRequest
from qwen3_rs_tpu.serving.paged_cache import init_paged_cache as jax_init_paged_cache
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.export import export_model
from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16_rows_plain
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
from qwen3_rs_tpu_torch.parallel import Mesh, interleave_for_tp, launch, local_config, shard_weights_tp, validate_tp
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request
from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache
from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
    seq_len=1024, vocab_size=256, group_size=16, shared_classifier=True,
)
JCONFIG = JaxConfig(**dataclasses.asdict(CONFIG))
TOL = 2e-2  # of max |ref|: an f32 sum in another order can flip a bf16 rounding of the stream


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_mesh(rank: int, tp: int = 2) -> Mesh:
    """A rank's mesh for the sharding functions, which need no process group."""
    return Mesh(tuple(torch.device("cpu") for _ in range(tp)), {"dp": 1, "tp": tp}, rank=rank)


def _jax_mesh(tp: int = 2):
    return jax_create_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_validate_tp_and_local_config_match_jax(tp):
    for cfg in (CONFIG, dataclasses.replace(CONFIG, n_kv_heads=1), dataclasses.replace(CONFIG, group_size=256),
                dataclasses.replace(CONFIG, n_heads=6, n_kv_heads=3, hidden_dim=768)):
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        outcomes = []
        for fn, c in ((jax_sharding.validate_tp, jcfg), (validate_tp, cfg)):
            try:
                fn(c, tp)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (cfg, tp)
        if outcomes[0] is None:
            assert dataclasses.asdict(local_config(cfg, tp)) == dataclasses.asdict(jax_tp.local_config(jcfg, tp))


def test_overlap_chunks_match_jax(monkeypatch):
    for name in ("QWEN3_TPU_TP_OVERLAP_CHUNKS", "QWEN3_TPU_TP_OVERLAP_MIN_ROWS"):
        monkeypatch.delenv(name, raising=False)
    for rows in (1, 8, 256, 511, 512, 600, 1024, 4096):
        for d_out in (128, 256, 384, 512, 1000, 1024, 4096, 6144):
            assert port_qwen3._tp_overlap_chunks(rows, d_out) == jax_qwen3._tp_overlap_chunks(rows, d_out)


@pytest.fixture(scope="module")
def trees():
    """JAX weight trees of CONFIG with numpy leaves: INT8 with the fast
    engine's bf16 scales, INT8 with f32 scales (exact mode), INT4."""
    return {"fast": jax_numpy_weights(CONFIG, 31), "exact": jax_numpy_weights(CONFIG, 31, fast_scales=False),
            "int4": jax_numpy_weights(CONFIG, 32, bits=4)}


@pytest.mark.parametrize("kind", ["fast", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_interleave_for_tp_matches_jax(trees, kind, tp):
    tree = trees[kind]
    want = jax_tp.interleave_for_tp(jax.tree.map(jnp.asarray, tree), JCONFIG, tp)
    got = interleave_for_tp(weights_from_jax_numpy(tree), CONFIG, tp)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
        assert np.array_equal(_np(a), _np(b))


def _equal_shards(jax_tree, port_fn):
    for rank in range(2):
        mine = jax.tree.leaves(port_fn(_port_mesh(rank)))
        for leaf, got in zip(jax.tree.leaves(jax_tree), mine, strict=True):
            shard = sorted(leaf.addressable_shards, key=lambda s: s.device.id)[rank]
            assert np.array_equal(_np(shard.data), _np(got)), leaf.shape


@pytest.mark.parametrize("kind", ["fast", "int4"])
def test_shards_equal_the_jax_shards(trees, kind):
    """Each rank's ``shard_weights_tp`` part equals the shard JAX places on
    device r, bit for bit, for every tensor."""
    tree = trees[kind]
    sharded = jax_tp.shard_weights_tp(jax.tree.map(jnp.asarray, tree), _jax_mesh(), JCONFIG)
    full = weights_from_jax_numpy(tree)
    _equal_shards(sharded, lambda mesh: shard_weights_tp(full, mesh, CONFIG))


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_cache_shards_equal_the_jax_shards(pool):
    """``shard_cache_tp`` of a page pool (and its INT8 scales) and
    ``shard_cache`` of a dense cache: each rank's kv heads, as JAX places
    them."""
    from qwen3_rs_tpu_torch.parallel import shard_cache, shard_cache_tp
    from qwen3_rs_tpu_torch.serving import paged_cache_from_jax_numpy

    rng = np.random.default_rng(6)
    jpool = jax_init_paged_cache(JCONFIG, 5, 128, dtype=jnp.bfloat16 if pool == "bf16" else "int8")
    jpool = jax.tree.map(lambda a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype), jpool)
    full = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, jpool))
    _equal_shards(jax_tp.shard_cache_tp(jpool, _jax_mesh()), lambda mesh: shard_cache_tp(full, mesh))
    dense = jax_qwen3.init_kv_cache(JCONFIG, 2, dtype=jnp.float32)
    dense = jax.tree.map(lambda a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype), dense)
    port_dense = type(init_kv_cache(CONFIG, 1, device="cpu"))(*(torch.from_numpy(np.array(a)) for a in dense))
    _equal_shards(jax_tp.shard_cache_tp(dense, _jax_mesh()), lambda mesh: shard_cache(port_dense, mesh))


# --------------------------------------------------------- #6's out_cols
def test_out_cols_plain_matches_the_jax_kernel():
    """The windows of the JAX package's ``test_pallas_rows_out_cols_matches_full``:
    the plain version against the Pallas kernel in interpret mode, and
    equal to the same columns of the full plain product."""
    rng = np.random.default_rng(5)
    n, d, g, b, layers = 256, 512, 64, 256, 2
    codes = rng.integers(-127, 128, (layers, n, d)).astype(np.int8)
    scales = (2.0 ** rng.integers(-9, -5, (layers, n // g, d))).astype(np.float32)
    x = rng.normal(0, 1, (b, n)).astype(np.float32)
    w = QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales))
    full = qmatmul_w8a16_rows_plain(torch.from_numpy(x), w, 1)
    for c0, dc in ((0, 256), (256, 256), (128, 128)):
        want = np.asarray(qmatmul_pallas_stacked_rows(jnp.asarray(x), JaxQT(jnp.asarray(codes), jnp.asarray(scales)),
                                                       1, interpret=True, impl="scale_w", out_cols=(c0, dc)))
        got = qmatmul_w8a16_rows_plain(torch.from_numpy(x), w, 1, out_cols=(c0, dc))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, full[:, c0 : c0 + dc])
    for bad in ((64, 128), (384, 256), (0, 8)):
        with pytest.raises(ValueError, match="out_cols"):
            qmatmul_w8a16_rows_plain(torch.from_numpy(x), w, 1, out_cols=bad)


# ------------------------------------------------------------ the tp forward
def _sequences():
    """The calls of the forward test: (mode, weights, cache, calls)."""
    rng = np.random.default_rng(7)
    toks = lambda b, s: rng.integers(0, CONFIG.vocab_size, (b, s))
    table = np.arange(1, 9, dtype=np.int64).reshape(2, 4)
    return [
        {"mode": "fast", "weights": "fast", "cache": ("dense", 1), "calls": [
            (toks(1, 512), [0], dict(fresh_prefill=True)),  # 512 reference rows: wo, w2 in column chunks
            (toks(1, 32), [512], {}),  # ≤ 256 rows: the fused path
            (toks(1, 1), [544], {}),  # a dense decode step
        ]},
        {"mode": "fast", "weights": "fast", "cache": ("paged", 9, 128), "calls": [
            (toks(2, 32), [0, 0], dict(fresh_prefill=True, page_table=table, out_idx=[31, 20])),
            (toks(2, 1), [32, 21], dict(page_table=table, write_mask=[True, False])),
            (toks(2, 1), [33, 21], dict(page_table=table, write_mask=[True, False])),
        ]},
        {"mode": "exact", "weights": "exact", "cache": ("dense", 1), "calls": [
            (toks(1, 128), [0], {}),
            (toks(1, 1), [128], {}),
        ]},
    ]


def _jax_run(trees, sequences):
    mesh = _jax_mesh()
    out = []
    for seq in sequences:
        w = jax_tp.shard_weights_tp(jax.tree.map(jnp.asarray, trees[seq["weights"]]), mesh, JCONFIG)
        kind, *size = seq["cache"]
        cache = (jax_qwen3.init_kv_cache(JCONFIG, size[0], dtype=jnp.bfloat16) if kind == "dense"
                 else jax_init_paged_cache(JCONFIG, size[0], size[1], dtype=jnp.bfloat16))
        cache = jax_tp.shard_cache_tp(cache, mesh)
        fwd = jax.jit(jax_tp.make_tp_forward(JCONFIG, mesh, mode=seq["mode"]), static_argnames=("fresh_prefill",))
        logits = []
        for tokens, pos, kw in seq["calls"]:
            kw = {k: (jnp.asarray(v, jnp.int32 if k != "write_mask" else bool) if k != "fresh_prefill" else v)
                  for k, v in kw.items()}
            lg, cache = fwd(w, jnp.asarray(tokens, jnp.int32), cache, jnp.asarray(pos, jnp.int32), **kw)
            logits.append(np.asarray(lg))
        out.append(logits)
    return out


def _tp1_run(weights, sequences):
    out = []
    for seq in sequences:
        w = weights[seq["weights"]]
        w = cast_weight_scales(w) if seq["mode"] == "fast" else w
        kind, *size = seq["cache"]
        cache = (init_kv_cache(CONFIG, size[0], dtype=torch.bfloat16, device="cpu") if kind == "dense"
                 else init_paged_cache(CONFIG, size[0], size[1], device="cpu"))
        logits = []
        for tokens, pos, kw in seq["calls"]:
            lg, cache = qwen3_forward(CONFIG, w, tokens, cache, pos, mode=seq["mode"], **kw)
            logits.append(lg)
        out.append(logits)
    return out


def _close(got, ref) -> bool:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return got.shape == ref.shape and float(np.abs(got - ref).max()) <= TOL * float(np.abs(ref).max())


def test_tp_forward_matches_jax_and_tp1(trees, monkeypatch):
    calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    # The tp overlap's column windows call the rows kernel by its module name.
    real_rows = jax_qmm.qmatmul_pallas_stacked_rows

    def rows_interpret(*a, **kw):
        calls["rows_cols"] += 1
        return real_rows(*a, interpret=True, **kw)

    monkeypatch.setattr(jax_qmm, "qmatmul_pallas_stacked_rows", rows_interpret)
    sequences = _sequences()
    want = _jax_run(trees, sequences)
    assert calls["rows_cols"] and calls["fused"] and calls["paged"] and calls["a8"]


    windows = []
    real = port_qwen3.qmatmul_w8a16_rows

    def spy(x, w, layer=None, *, out_cols=None):
        windows.append(out_cols)
        return real(x, w, layer, out_cols=out_cols)

    monkeypatch.setattr(port_qwen3, "qmatmul_w8a16_rows", spy)
    # The exact sequence keeps the checkpoint's f32 scales (the fast engine casts them).
    full = weights_from_jax_numpy(trees["exact"])
    weights = {"fast": full, "exact": full}
    mesh = launch(["cpu", "cpu"], run_calls, CONFIG, weights, sequences)
    try:
        got = run_calls(mesh, CONFIG, weights, sequences)
    finally:
        mesh.close()
    # The 512-row window: 2 layers × (wo, w2) × 2 column chunks of 128 through #6's window.
    assert sorted(w for w in windows if w is not None) == sorted([(0, 128), (128, 128)] * 4)
    tp1 = _tp1_run(weights, sequences)
    for seq, g, j, one in zip(sequences, got, want, tp1):
        for i, (a, b, c) in enumerate(zip(g, j, one)):
            assert a.shape == (len(seq["calls"][i][0]), CONFIG.vocab_size)
            assert _close(a.numpy(), b), (seq["mode"], seq["cache"], i)
            assert _close(a.numpy(), c.numpy()), (seq["mode"], seq["cache"], i)


# ------------------------------------------------------------ the tp engine
def _port_tp(config, weights, kw):
    return start_tp_engine(functools.partial(model, config, weights), ["cpu", "cpu"], **kw)


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_engine_streams_match_jax_tp_and_tp1(weights, bits, monkeypatch):  # noqa: F811
    """Paged pool, device sampling, greedy: the port's tp=2 engine (2 ranks)
    against the JAX tp=2 engine and the port's tp=1 engine; every rank
    emits the same streams."""
    if bits == 4:
        tree = jax_numpy_weights(SERVE_CONFIG, 23, fast_scales=False, bits=4)
        tree = tree._replace(rms_final=tree.rms_final * 20.0)
        jw, pw = jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree)
        route_jax_q4_through_interpret_kernels(monkeypatch, min_seq_len=128)
    else:
        jw, pw, _ = weights
        route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    kw = dict(n_slots=4, mode="fast", prefill_buckets=BUCKETS, kv_layout="paged", page_size=128,
              sampling="device", decode_chunk_steps=4, seed=3)
    schedule = _schedule(_prompts(43, [6, 150, 3, 20, 9]), max_new=8, at=[0, 0, 1, 3, 3])
    jax_engine = JaxEngine(config=SERVE_JCONFIG, weights=jw, cache_dtype=jnp.bfloat16, mesh=_jax_mesh(), **kw)
    _, ref_stats = _drive(jax_engine, schedule, JaxRequest)
    one = ContinuousBatchingEngine(config=SERVE_CONFIG, weights=pw, device="cpu", **kw)
    _drive(one, schedule, Request)
    engine = _port_tp(SERVE_CONFIG, pw, kw)
    try:
        engine.reset_counters()
        streams, stats = _drive(engine, schedule, Request)
        reports = engine.rank_reports()
    finally:
        engine.close()
    assert stats == ref_stats
    prompts = {rid: p for reqs in schedule.values() for rid, p, *_ in reqs}
    _match(jax_engine.completed, engine.completed, pw, prompts)
    _match(one.completed, engine.completed, pw, prompts)
    assert [r["rank"] for r in reports] == [0, 1]
    assert reports[0]["streams"] == reports[1]["streams"] == {rid: t for rid, (t, _) in streams.items()}
    assert reports[1]["collectives"]["all_reduce"] == reports[0]["collectives"]["all_reduce"] > 0


def test_tp_engine_refuses_what_jax_refuses():
    """``create_mesh(tp=1, dp=2)`` builds, as JAX's does (in a group of two
    ranks, which a mesh of two devices needs); the serving engine refuses a
    dp > 1 mesh with JAX's message."""
    with pytest.raises(ValueError, match="dp replica"):
        ContinuousBatchingEngine(config=CONFIG, weights=None,
                                 mesh=Mesh((torch.device("cpu"),) * 2, {"dp": 2, "tp": 1}), device="cpu")
    assert dict(jax_create_mesh(tp=1, dp=2, devices=jax.devices()[:2]).shape) == {"dp": 2, "tp": 1}
    mesh = launch(["cpu", "cpu"], mesh_report, dp=2)
    try:
        assert mesh.shape == {"dp": 2, "tp": 1} and (mesh.dp_index, mesh.tp_index) == (0, 0)
        assert [r["dp"] for r in mesh_report(mesh)] == [0, 1]
        with pytest.raises(ValueError, match="dp replica"):
            ContinuousBatchingEngine(config=CONFIG, weights=None, mesh=mesh, device="cpu")
    finally:
        mesh.close()
    from qwen3_rs_tpu_torch.parallel.mesh import backend_for

    assert backend_for(["cpu", "cpu"]) == backend_for(["cuda:0", "cuda:0"]) == backend_for(["cuda", "cuda"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_greedy_head_under_tp_raises_as_jax():
    w = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 3))
    with pytest.raises(ValueError, match="greedy_head requires the full head"):
        qwen3_forward(CONFIG, w, [[1]], init_kv_cache(CONFIG, 1, device="cpu"), [0], greedy_head=True, tp_group=object())


# -------------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def tp_checkpoint(tmp_path_factory):
    """A dim-256 model with 2 kv heads (so that tp=2 splits them), exported
    by the port; its final norm scaled for peaked logits."""
    import contextlib
    import io

    from utils import TINY_CONFIG

    tmp = tmp_path_factory.mktemp("tp")
    cfg = dataclasses.replace(TINY_CONFIG, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=128,
                              seq_len=128, group_size=64)
    hf = make_hf_model_dir(tmp, config=cfg, rng=np.random.default_rng(12), min_vocab=256)
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(hf, tmp / "m.qtpu", 64, fmt="native")
    return tmp / "m.qtpu"


def _children(pid: int) -> list[int]:
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if int((d / "stat").read_text().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(d.name))
            except (OSError, IndexError, ValueError):
                pass
    return out


def test_serve_tp_cli_answers_as_the_api_and_stops_cleanly(tp_checkpoint):
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.configuration import read_config
    from qwen3_rs_tpu_torch.inference.tokenizer import Tokenizer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(tp_checkpoint), "--tp", "2",
                             "--device", "cpu,cpu", "--slots", "2", "--port", str(port)], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        for _ in range(600):
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5).read()
                break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                     data=json.dumps({"prompt": "hello world", "max_tokens": 6}).encode())
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
        ranks = _children(proc.pid)
        assert ranks, "serve --tp 2 started no worker rank"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    for _ in range(50):
        if not any(Path(f"/proc/{pid}").exists() for pid in ranks):
            break
        time.sleep(0.1)
    assert not any(Path(f"/proc/{pid}").exists() for pid in ranks), "a rank outlived the server"
    # The API's counterpart: the same tp engine through the library.
    tok = Tokenizer(tp_checkpoint, read_config(tp_checkpoint).vocab_size)
    engine = start_tp_engine(functools.partial(load_checkpoint, tp_checkpoint), ["cpu", "cpu"], n_slots=2,
                             kv_layout="paged", sampling="device")
    try:
        engine.submit(Request(0, tok.encode("hello world"), max_new_tokens=6,
                              eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
        want = engine.run()[0].generated
    finally:
        engine.close()
    assert body["text"] == tok.decode(want) and body["tokens"] == len(want)


def test_serve_tp_needs_a_device_per_rank(tp_checkpoint):
    with pytest.raises(SystemExit, match="--replicas 1 x --tp 2 needs 2 devices, have 1"):
        port_main(["serve", str(tp_checkpoint), "--tp", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--replicas 2 x --tp 1 needs 2 devices, have 1"):
        port_main(["serve", str(tp_checkpoint), "--replicas", "2", "--device", "cpu"])


@pytest.mark.parametrize("mode,bits", [("fast", 8), ("fast", 4), ("exact", 8), ("f32", 8)])
def test_column_windows_equal_the_full_projection(trees, mode, bits):
    """``_project_layer_cols`` in every mode and code format (#6's window in
    INT8 fast mode; the sliced (codes, scales) and the plain projection
    otherwise) gives the same columns as the whole projection."""
    from qwen3_rs_tpu_torch.ops.matmul import f32_matmul, qmatmul_exact
    from qwen3_rs_tpu_torch.ops.quant import quantize_activations

    tree = trees["int4" if bits == 4 else ("fast" if mode == "fast" else "exact")]
    w = weights_from_jax_numpy(tree).layers.w2
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 512, CONFIG.hidden_dim)).astype(np.float32))
    xq = quantize_activations(x, CONFIG.group_size) if mode == "exact" else None
    full = {"fast": lambda: qmatmul_w8a16_rows_plain(x, w, 1), "exact": lambda: qmatmul_exact(xq, w, 1),
            "f32": lambda: f32_matmul(x, w, 1)}[mode]()
    for c0, dc in ((0, 128), (128, 128)):
        got = port_qwen3._project_layer_cols(x, xq, w, 1, mode, c0, dc, 1024)
        assert got.shape == (2, 512, dc)
        torch.testing.assert_close(got, full[..., c0 : c0 + dc], rtol=1e-6, atol=1e-6)

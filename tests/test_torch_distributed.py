"""(dp, tp) meshes on process subgroups and the scaling harness: the port's
``parallel/mesh.py`` and ``parallel/distributed.py`` on gloo CPU ranks
(rank 0 this process, the others spawned), against the JAX package on its
virtual CPU mesh.

* A (dp, tp) mesh's coordinates and subgroups at (2, 1), (1, 2) and (2, 2):
  tp varies fastest, as the JAX mesh's ``reshape(dp, tp)``; each subgroup
  reduces over its own ranks only.
* Greedy decode on a (2, 2) mesh of 4 ranks, and on a (2, 1) mesh at dim 512
  (each replica's decode step through the megakernel's plain version: the
  port's own gate routes it there), against JAX ``qwen3_forward`` jitted on
  the same mesh of virtual devices with JAX's ``shard_weights`` and
  ``shard_cache``: the greedy tokens of 4 steps equal and the first step's
  logits within 2e-2 of the largest (an f32 sum in another order can flip a
  bf16 rounding of the stream), 2 rows a replica, each row its own first
  token; the final norm scaled by 20, so that no pick is a near-tie.
* ``scaling_report`` at device counts [1, 2] (tp 1), [2] (tp 2) and [4] (tp
  2): JAX's keys, efficiency 1 at the first count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_parity import jax_numpy_weights
from torch_tp_ranks import mesh_report

import qwen3_rs_tpu.parallel.sharding as jax_sharding
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu.parallel.mesh import create_mesh as jax_create_mesh
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, megakernel_route, weights_from_jax_numpy
from qwen3_rs_tpu_torch.parallel import create_mesh, launch, logits_spec, scaling_report, token_spec
from qwen3_rs_tpu_torch.parallel.distributed import decode_run

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
    seq_len=64, vocab_size=256, group_size=16, shared_classifier=True,
)
# Passes the megakernel gate in both packages (dim 512), as in test_torch_decode_chunk.
MEGA = dataclasses.replace(CONFIG, dim=512, hidden_dim=1024, seq_len=256, vocab_size=2048, group_size=64)
TOL = 2e-2


@pytest.fixture(autouse=True)
def no_group_left():
    """No process group is up before a test or after it."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_mesh_coordinates_and_subgroups(dp, tp, monkeypatch, tmp_path):
    """The coordinates and subgroups, and rank 0's build directory
    (``utils.enable_compile_cache``) passed on to every rank."""
    from qwen3_rs_tpu_torch.ops.kernels import build

    n = dp * tp
    assert dict(jax_create_mesh(tp=tp, dp=dp, devices=jax.devices()[:n]).shape) == {"dp": dp, "tp": tp}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    mesh = launch(["cpu"] * n, mesh_report, dp=dp)
    try:
        assert mesh.shape == {"dp": dp, "tp": tp} and mesh.backend == "gloo"
        got = mesh_report(mesh)
    finally:
        mesh.close()
    jax_grid = np.arange(n).reshape(dp, tp)  # JAX's device order: tp fastest
    for r, rep in enumerate(got):
        d, t = np.argwhere(jax_grid == r)[0]
        assert (rep["rank"], rep["dp"], rep["tp"]) == (r, d, t)
        assert rep["parts"] == {"dp": (dp, d), "tp": (tp, t)}
        tp_ranks, dp_ranks = jax_grid[d].tolist(), jax_grid[:, t].tolist()
        assert rep["tp_group"] == ((tp_ranks, sum(tp_ranks)) if tp > 1 else (None, r))
        assert rep["dp_group"] == ((dp_ranks, sum(dp_ranks)) if dp > 1 else (None, r))
        assert rep["build_dir"] == str(tmp_path)


def test_create_mesh_checks_as_jax():
    with pytest.raises(ValueError, match="must equal device count"):
        create_mesh(tp=2, dp=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="must equal device count"):
        jax_create_mesh(tp=2, dp=2, devices=jax.devices()[:2])
    one = create_mesh(tp=1, dp=1, devices=["cpu"])
    assert one.parts() == {"dp": (1, 0), "tp": (1, 0)} and one.tp_group is None and one.dp_group is None
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        create_mesh(tp=1, dp=2, devices=["cpu"] * 2)  # builds, in a group of 2 ranks
    assert token_spec() == logits_spec() and token_spec().axis == 0 and token_spec().over == "dp"
    assert jax_sharding.token_spec() == jax_sharding.logits_spec() == P("dp", None)


def _jax_decode(cfg, tree, first, dp, tp, steps):
    """JAX ``qwen3_forward`` in fast mode on a (dp, tp) mesh of virtual
    devices, placed as ``_throughput_on`` places it: greedy tokens
    ``[batch, steps]`` and the first step's logits."""
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    mesh = jax_create_mesh(tp=tp, dp=dp, devices=jax.devices()[: dp * tp])
    w = jax_sharding.shard_weights(tree, mesh, jcfg)
    batch = len(first)
    cache = jax_sharding.shard_cache(jax_init_cache(jcfg, batch, dtype=jnp.bfloat16), mesh)

    def decode_n(weights, token, cache, pos):
        def body(carry, _):
            token, cache, pos = carry
            logits, cache = jax_forward(jcfg, weights, token, cache, pos, mode="fast")
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            return (nxt, cache, pos + 1), (nxt[:, 0], logits)

        _, (toks, logits) = jax.lax.scan(body, (token, cache, pos), None, length=steps)
        return toks.T, logits[0]

    tok = jax.device_put(jnp.asarray(first, jnp.int32)[:, None], NamedSharding(mesh, P("dp", None)))
    pos = jax.device_put(jnp.zeros(batch, jnp.int32), NamedSharding(mesh, P("dp")))
    toks, logits = jax.jit(decode_n)(w, tok, cache, pos)
    return np.asarray(toks), np.asarray(logits)


@pytest.mark.parametrize("cfg,dp,tp", [(CONFIG, 2, 2), (MEGA, 2, 1)], ids=["dp2-tp2", "dp2-tp1-megakernel"])
def test_dp_tp_greedy_decode_matches_jax(cfg, dp, tp, monkeypatch):
    import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3

    steps, per_dp = 4, 2
    tree = jax_numpy_weights(cfg, 11)
    tree = tree._replace(rms_final=tree.rms_final * 20.0)
    first = [3, 17, 40, 77][: per_dp * dp]
    want_toks, want_logits = _jax_decode(cfg, tree, first, dp, tp, steps)
    # Which route a replica's decode step takes on this rank (the spawned
    # ranks run the same code): the megakernel at tp 1 where the gate admits.
    routes = []
    real = port_qwen3.decode_stack_megakernel
    monkeypatch.setattr(port_qwen3, "decode_stack_megakernel", lambda *a, **k: routes.append(1) or real(*a, **k))
    cache = init_kv_cache(cfg, per_dp, dtype=torch.bfloat16, device="cpu")
    assert megakernel_route(cfg, cache, per_dp, 1) == (cfg is MEGA)
    got = decode_run(cfg, weights_from_jax_numpy(tree), ["cpu"] * (dp * tp), tp=tp, batch_per_dp=per_dp,
                     steps=steps, first_tokens=first)
    assert bool(routes) == (tp == 1)
    assert len(got["tokens"]) == dp * tp and got["throughput"] > 0
    for r, (toks, logits) in enumerate(zip(got["tokens"], got["logits"])):
        rows = slice(r // tp * per_dp, (r // tp + 1) * per_dp)
        np.testing.assert_array_equal(toks, want_toks[rows], err_msg=f"rank {r}")
        ref = want_logits[rows]
        err = float(np.abs(logits - ref).max() / np.abs(ref).max())
        assert err <= TOL, (r, err)
    # Every replica equals one rank decoding the whole batch: bit for bit at
    # tp 1 (the same route on the same rows), within TOL at tp 2.
    one = decode_run(cfg, weights_from_jax_numpy(tree), ["cpu"], tp=1, batch_per_dp=per_dp * dp, steps=steps,
                     first_tokens=first)
    np.testing.assert_array_equal(np.concatenate(got["tokens"][::tp]), one["tokens"][0])
    lg = np.concatenate(got["logits"][::tp])
    if tp == 1:
        np.testing.assert_array_equal(lg, one["logits"][0])
    else:
        assert float(np.abs(lg - one["logits"][0]).max() / np.abs(one["logits"][0]).max()) <= TOL


@pytest.mark.parametrize("counts,tp,per_dp,steps", [([1, 2], 1, 1, 8), ([2], 2, 2, 4), ([4], 2, 1, 4)],
                         ids=["dp", "tp", "dp2-tp2"])
def test_scaling_report_on_cpu_ranks(counts, tp, per_dp, steps):
    w = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 5))
    report = scaling_report(CONFIG, w, device_counts=counts, tp_per_group=tp, batch_per_dp=per_dp, steps=steps,
                            devices=["cpu"] * max(counts))
    assert set(report) == {"throughput", "efficiency"}
    assert set(report["throughput"]) == set(report["efficiency"]) == set(counts)
    assert report["efficiency"][counts[0]] == pytest.approx(1.0)
    assert all(v > 0 for v in report["throughput"].values())  # CPU numbers say only that the path ran


def test_scaling_report_weights_from_a_source_and_the_card_by_default(monkeypatch):
    """Each rank may draw its weights (a zero-argument callable); without
    ``devices`` the report takes the cards, and there are none here."""
    from functools import partial

    from qwen3_rs_tpu_torch.testing import random_weights

    got = decode_run(CONFIG, partial(random_weights, CONFIG, 3, "cpu"), ["cpu"] * 2, tp=2, batch_per_dp=1, steps=2)
    one = decode_run(CONFIG, random_weights(CONFIG, 3, "cpu"), ["cpu"], tp=1, batch_per_dp=1, steps=2)
    assert got["tokens"][0].shape == one["tokens"][0].shape == (1, 2)
    np.testing.assert_array_equal(got["tokens"][0], got["tokens"][1])  # one replica: its ranks agree
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling_report(CONFIG, None, device_counts=[1])

"""The price of a launch boundary on the card: the same weight bytes streamed
three ways.

    python -m qwen3_rs_tpu_torch.scripts.boundary_probe [model] [mat]

The port's counterpart of ``scripts/boundary_probe.py`` (defaults 8b, w13).
L = 8 layers of one matrix of the model (INT8-g64: codes uniform in
[-127, 127), scales 0.01, as the reference probe; x from a seeded generator)
are streamed reps·L times:

  percall-eager  reps·L launches of #2 (``qmatmul_w8a16(x, w, l)``) issued
                 from Python: how the port's per-layer step runs today
  percall-graph  the same launches captured once in a ``torch.cuda.CUDAGraph``
                 and replayed: the counterpart of the reference's jitted scan
  onecall        one launch of ``boundary_onecall`` that streams all reps·L
                 layers: #2's row kernel with the boundary taken out (a
                 persistent grid walking every layer's units)

Timing: the slope between 48 and 12 reps of CUDA-event medians (each over
``repeat`` calls after warm-up), so a call's fixed cost cancels; printed as ms
per layer and the layer's bytes (codes and bf16 scales) per second, then the
price of a boundary: each per-call arm's ms a layer less the one-call arm's.
The one-call kernel's layers are held against #2's before any timing.
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernels.probes import boundary_onecall
from ..ops.kernels.qmatmul import qmatmul_w8a16
from ..ops.quant import QuantizedTensor
from ..testing import qwen3_config
from . import card, card_line, generator, slope_ms

LAYERS = 8
ARMS = ("percall-eager", "percall-graph", "onecall")
RTOL = 1e-4  # #2's tolerance: the same bf16 products, f32 sums in another order


def matrices(model: str) -> dict[str, tuple[int, int]]:
    """(N, D) of each stacked matrix of ``model``, as the reference probe names them."""
    c = qwen3_config(model, seq_len=1024)
    return {
        "wqkv": (c.dim, c.all_heads_dim + 2 * c.kv_dim),
        "wo": (c.all_heads_dim, c.dim),
        "w13": (c.dim, 2 * c.hidden_dim),
        "w2": (c.hidden_dim, c.dim),
    }


def _graph(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured once (after a warm-up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def run(model: str = "8b", mat: str = "w13", reps_hi: int = 48, repeat: int = 5, device="cuda",
        seed: int = 0) -> dict:
    dev = card(device)
    n, d = matrices(model)[mat]
    g = qwen3_config(model).group_size
    gen = generator(dev, seed)
    codes = torch.empty(LAYERS, n, d, dtype=torch.int8, device=dev).random_(-127, 127, generator=gen)
    w = QuantizedTensor(codes, torch.full((LAYERS, n // g, d), 0.01, dtype=torch.bfloat16, device=dev))
    x = torch.randn(1, n, generator=gen, device=dev)

    ref = torch.cat([qmatmul_w8a16(x, w, l) for l in range(LAYERS)])
    got = boundary_onecall(x, w, 1)
    torch.cuda.synchronize()
    err, tol = float((got - ref).abs().max()), RTOL * float(ref.abs().max())
    if not err <= tol:
        raise RuntimeError(f"boundary_onecall {mat}: max_abs_err {err} > {tol} against #2")

    lo = max(reps_hi // 4, 1)

    def eager(reps):
        for i in range(reps * LAYERS):
            qmatmul_w8a16(x, w, i % LAYERS)

    graphs = {r: _graph(lambda r=r: eager(r)) for r in (lo, reps_hi)}
    calls = {
        "percall-eager": eager,
        "percall-graph": lambda reps: graphs[reps].replay(),
        "onecall": lambda reps: boundary_onecall(x, w, reps),
    }
    layer_bytes = n * d + (n // g) * d * 2
    arms = {}
    for name in ARMS:
        per_rep = slope_ms(calls[name], lo, reps_hi, repeat)
        ms = per_rep / LAYERS
        arms[name] = {"ms_per_layer": ms, "gb_per_s": layer_bytes / (ms * 1e-3) / 1e9}
    del graphs
    one = arms["onecall"]["ms_per_layer"]
    price = {arm: arms[arm]["ms_per_layer"] - one for arm in ("percall-eager", "percall-graph")}
    return {"probe": "boundary_probe", "card": card_line(), "model": model, "mat": mat, "N": n, "D": d, "g": g,
            "layers": LAYERS, "reps": [lo, reps_hi], "bytes_per_layer": layer_bytes,
            "onecall_max_abs_err": err, "tol": tol, "timing": "slope of CUDA-event medians", "arms": arms,
            "boundary_ms_per_layer": price}


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    model = args[0] if len(args) > 0 else "8b"
    mat = args[1] if len(args) > 1 else "w13"
    out = run(model, mat)
    print(out["card"], flush=True)
    for name, arm in out["arms"].items():
        print(f"{mat} {name}: {arm['ms_per_layer']:7.4f} ms/layer  {arm['gb_per_s']:6.1f} GB/s", flush=True)
    for name, ms in out["boundary_ms_per_layer"].items():
        print(f"{mat} boundary ({name} - onecall): {ms:7.4f} ms/layer", flush=True)


if __name__ == "__main__":
    main()

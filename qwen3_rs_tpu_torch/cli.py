"""Command-line interface: the ``export``, ``inference``, ``eval-ppl``,
``batch`` and ``serve`` subcommands.

The same flags, defaults and output as the reference package's subcommands,
plus ``--device`` (default: the card).  ``--device-sampling`` runs the
decode loop in on-device chunks (``Engine.decode_chunk``); ``batch`` and
``serve`` sample on the device by default (``--sampling device``), as the
reference's do.  ``serve --tp N`` shards the engine over N ranks, one
process each (``--device`` lists one device per rank; ``cuda:0,cuda:0`` puts
two ranks on one card, ``cpu,cpu`` runs them on the CPU).  ``serve
--replicas R`` routes requests over R engines on disjoint slices of the
device list (least-loaded, with prefix affinity under ``--prefix-cache``):
at ``--tp 1`` engines of this process, each on its device; at ``--tp K``
each replica is a ``serve --tp K`` process of its own on a free local port,
reached over HTTP.  ``serve --gateway URL,URL`` routes over worker servers
and loads no weights.  ``inference --sp N`` prefills prompts of at least
``--sp-threshold`` rows over N ranks (ring attention; one device per rank).
``--spec K`` decodes with n-gram speculative rounds (``inference``: greedy,
generate mode; ``batch`` and ``serve``: the page pool with device sampling).

    python -m qwen3_rs_tpu_torch.cli export HF_DIR m.qtpu -g 64 --bits 4
    python -m qwen3_rs_tpu_torch.cli export HF_DIR m.bin --format legacy
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" -t 0
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" -t 0.8 --device-sampling
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" --engine-mode exact
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" -t 0 --spec 4
    python -m qwen3_rs_tpu_torch.cli eval-ppl CKPT -f text.txt --modes fast,exact,f32 -w 4096
    python -m qwen3_rs_tpu_torch.cli batch CKPT -f prompts.txt --sampling host --kv paged
    python -m qwen3_rs_tpu_torch.cli serve CKPT --kv-int8 --prefix-cache
    python -m qwen3_rs_tpu_torch.cli serve CKPT --spec 3 --spec-min-accept 1.35
    python -m qwen3_rs_tpu_torch.cli serve CKPT --tp 2 --device cuda:0,cuda:0
    python -m qwen3_rs_tpu_torch.cli serve CKPT --replicas 2 --device cuda:0,cuda:1
    python -m qwen3_rs_tpu_torch.cli serve CKPT --gateway http://host1:8000,http://host2:8000
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "..." --sp 2 --device cuda:0,cuda:1
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

_DEVICE_HELP = "torch device (default: cuda; cpu runs the kernels' plain PyTorch versions)"
_SAMPLING_HELP = (
    "host = reference-parity xorshift; device = on-device sampling in decode chunks "
    "(reproducible per --seed, not the host stream's bits)"
)
_SPEC_HELP = (
    "n-gram speculative decoding: every slot verifies K drafts per round, distribution-exact at any "
    "temperature (paged + device sampling only; sync scheduling)"
)
_PREFIX_HELP = (
    "reuse KV pages across requests sharing a prompt prefix "
    "(paged layout; prefills run only the unmatched suffix)"
)
_CHUNK_HELP = (
    "chunked prefill: long prompts prefill N rows per scheduler step, interleaved "
    "with decode (paged layout; bounds inter-token latency under long-prompt admissions)"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qwen3-torch", description="Qwen3 INT8/INT4 export and inference on an NVIDIA GPU (PyTorch + CUDA)"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    exp = sub.add_parser("export", help="Export HF model to quantized checkpoint")
    exp.add_argument("model_path", help="Path to the HF model directory")
    exp.add_argument("output_path", help="Output checkpoint path")
    exp.add_argument("-g", "--group-size", type=int, default=64, help="Quantization group size (default 64)")
    exp.add_argument(
        "--format", choices=["native", "legacy"], default="native",
        help="native = checkpoint directory (.qtpu, default); legacy = reference .bin",
    )
    exp.add_argument(
        "--bits", type=int, choices=[8, 4], default=8,
        help="linear-layer code width: 8 = Q8_0 (default); 4 = nibble-packed INT4 (native format only: "
        "halves the decode weight stream; embeddings/classifier stay INT8)",
    )
    inf = sub.add_parser("inference", help="Run inference on a checkpoint")
    inf.add_argument("checkpoint", help="Checkpoint (native directory or legacy .bin)")
    inf.add_argument("-t", "--temperature", type=float, default=1.0)
    inf.add_argument("-p", "--topp", type=float, default=0.9, help="top-p (nucleus) threshold")
    inf.add_argument("-s", "--seed", type=int, default=None)
    inf.add_argument("-c", "--context", type=int, default=None, help="context window override")
    inf.add_argument("-m", "--mode", choices=["generate", "chat"], default="chat")
    inf.add_argument("-i", "--input", default=None, help="input prompt")
    inf.add_argument("-y", "--system", default=None, help="system prompt (chat mode)")
    inf.add_argument(
        "-r", "--reasoning", type=int, choices=[0, 1], default=0,
        help="reasoning mode: 0=no thinking, 1=thinking",
    )
    inf.add_argument(
        "--engine-mode", choices=["fast", "exact"], default="fast",
        help="fast = W8A16 with the CUDA kernels; exact = W8A8 with the reference's rounding",
    )
    inf.add_argument(
        "--device-sampling", action="store_true",
        help="sample on the device, in chunks of decode steps that stay on the device "
        "(the host xorshift sampler is the default)",
    )
    inf.add_argument(
        "--kv-int8", action="store_true", help="INT8 KV cache with per-row scales"
    )
    inf.add_argument(
        "--spec", type=int, default=0, metavar="K",
        help="n-gram speculative decoding with K-token drafts (greedy-exact; "
        "requires -t 0, generate mode; device sampling is auto-enabled)",
    )
    inf.add_argument(
        "--sp", type=int, default=1, metavar="N",
        help="sequence-parallel prefill over N devices (ring attention), one process each",
    )
    inf.add_argument(
        "--sp-threshold", type=int, default=4096, metavar="ROWS",
        help="minimum prompt rows to engage the sequence-parallel prefill",
    )
    inf.add_argument(
        "--device", default=None,
        help=_DEVICE_HELP + "; with --sp, one device per rank, comma-separated (default: the first --sp cards)",
    )

    # eval-ppl: perplexity and the int8-vs-f32 delta (the accuracy bar).
    ev = sub.add_parser("eval-ppl", help="Evaluate perplexity of a checkpoint")
    ev.add_argument("checkpoint")
    ev.add_argument("-f", "--file", required=True, help="UTF-8 text file to evaluate")
    ev.add_argument(
        "--modes", default="fast,f32",
        help="comma-separated engine modes (fast, exact, f32); default fast,f32",
    )
    ev.add_argument("-w", "--window", type=int, default=None, help="evaluation window")
    ev.add_argument("--device", default=None, help=_DEVICE_HELP)

    # batch: continuous-batching throughput runner (serving surface).
    bt = sub.add_parser("batch", help="Serve a batch of prompts with continuous batching")
    bt.add_argument("checkpoint")
    bt.add_argument("-f", "--file", required=True, help="text file: one prompt per line")
    bt.add_argument("-n", "--max-new-tokens", type=int, default=128)
    bt.add_argument("-t", "--temperature", type=float, default=0.0)
    bt.add_argument("-p", "--topp", type=float, default=0.9)
    bt.add_argument("-s", "--seed", type=int, default=0)
    bt.add_argument("--slots", type=int, default=8, help="concurrent decode slots")
    bt.add_argument("--sampling", choices=["host", "device"], default="device", help=_SAMPLING_HELP)
    bt.add_argument("--no-warmup", action="store_true", help="skip the kernel build and warm-up step")
    bt.add_argument(
        "--kv", choices=["dense", "paged"], default="dense",
        help="KV cache layout: dense slots or a shared page pool",
    )
    bt.add_argument("--page-size", type=int, default=128, help="rows per KV page (paged only)")
    bt.add_argument(
        "--pages", type=int, default=None,
        help="KV pool size in pages (paged only; default: half the dense footprint)",
    )
    bt.add_argument("--spec", type=int, default=0, metavar="K", help=_SPEC_HELP)
    bt.add_argument("--prefix-cache", action="store_true", help=_PREFIX_HELP)
    bt.add_argument("--prefill-chunk", type=int, default=None, metavar="N", help=_CHUNK_HELP)
    bt.add_argument("--device", default=None, help=_DEVICE_HELP)

    # serve: HTTP front end over the continuous-batching engine.
    sv = sub.add_parser("serve", help="Serve a checkpoint over HTTP")
    sv.add_argument("checkpoint")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--slots", type=int, default=8)
    sv.add_argument("--sampling", choices=["host", "device"], default="device", help=_SAMPLING_HELP)
    sv.add_argument("--kv", choices=["dense", "paged"], default="paged")
    sv.add_argument(
        "--kv-int8", action="store_true",
        help="INT8 page pool (per-row scales): halves KV traffic and doubles pool capacity; "
        "paged layout only",
    )
    sv.add_argument("--page-size", type=int, default=128)
    sv.add_argument("--pages", type=int, default=None)
    sv.add_argument("--no-warmup", action="store_true")
    sv.add_argument("--spec", type=int, default=0, metavar="K", help=_SPEC_HELP)
    sv.add_argument(
        "--spec-min-accept", type=float, default=1.35, metavar="T",
        help="acceptance-adaptive floor: fall back to plain decode chunks while the measured tokens/round "
        "EWMA sits below T (speculation re-probes periodically) — --spec never underperforms plain "
        "decoding on low-acceptance traffic",
    )
    sv.add_argument("--prefix-cache", action="store_true", help=_PREFIX_HELP)
    sv.add_argument("--prefill-chunk", type=int, default=None, metavar="N", help=_CHUNK_HELP)
    sv.add_argument(
        "--gateway", default=None, metavar="URL,URL",
        help="cross-host gateway: route requests over these worker servers (no weights, no device work)",
    )
    sv.add_argument(
        "--tp", type=int, default=1,
        help="tensor-shard the engine's weights and KV over this many devices, one process each",
    )
    sv.add_argument(
        "--replicas", type=int, default=1,
        help="engine replicas behind one least-loaded router, each on --tp devices of its own",
    )
    sv.add_argument(
        "--device", default=None,
        help=_DEVICE_HELP + "; with --tp or --replicas, one device per rank, comma-separated (default: the "
        "first --replicas x --tp cards; cuda:0,cuda:0 puts two ranks on one card, cpu,cpu runs them on the CPU)",
    )
    return parser


def _tp_devices(args) -> list[str]:
    """One device per rank of every replica (``--replicas`` × ``--tp``, the
    replicas' slices in order): the ``--device`` list, or the first cards."""
    import torch

    have = args.device.split(",") if args.device else [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if args.replicas * args.tp > len(have):
        raise SystemExit(
            f"--replicas {args.replicas} x --tp {args.tp} needs {args.replicas * args.tp} devices, have {len(have)}"
        )
    return have[: args.replicas * args.tp]


def _engine(args, config, weights, devices=None, **kw):
    from .serving import ContinuousBatchingEngine

    for flag in ("spec", "prefix_cache", "prefill_chunk"):
        if getattr(args, flag) not in (None, False) and args.kv != "paged":
            name = "--" + flag.replace("_", "-")
            raise SystemExit(f"{name} requires the paged KV layout: add --kv paged")
    if args.command == "serve":
        kw["spec_min_accept"] = args.spec_min_accept
    kw = dict(n_slots=args.slots, sampling=args.sampling, seed=getattr(args, "seed", 0), kv_layout=args.kv,
              page_size=args.page_size, n_pages=args.pages, spec_k=args.spec, prefix_cache=args.prefix_cache,
              prefill_chunk=args.prefill_chunk, **kw)
    if getattr(args, "tp", 1) > 1:
        import functools

        from .checkpoint import load_checkpoint
        from .serving.scheduler import start_tp_engine

        # Every rank loads the checkpoint itself and keeps its shard.
        engine = start_tp_engine(functools.partial(load_checkpoint, args.checkpoint),
                                 (devices or _tp_devices(args))[: args.tp], **kw)
    else:
        device = devices[0] if devices else (args.device.split(",")[0] if args.device else None)
        engine = ContinuousBatchingEngine(config=config, weights=weights, device=device, **kw)
    if not args.no_warmup:
        engine.warmup()
    return engine


def _batch(args) -> int:
    from .checkpoint import load_checkpoint
    from .inference.tokenizer import Tokenizer
    from .serving import Request

    config, weights = load_checkpoint(args.checkpoint)
    tokenizer = Tokenizer(args.checkpoint, config.vocab_size)
    engine = _engine(args, config, weights)
    prompts = [line for line in Path(args.file).read_text().splitlines() if line.strip()]
    for i, prompt in enumerate(prompts):
        engine.submit(Request(
            request_id=i,
            prompt_tokens=tokenizer.encode(prompt),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            topp=args.topp,
            seed=args.seed + i,
            eos_token_ids=(tokenizer.bos_token_id, tokenizer.eos_token_id),
        ))
    t0 = time.perf_counter()
    done = engine.run()
    elapsed = time.perf_counter() - t0
    for req in sorted(done, key=lambda r: r.request_id):
        print(json.dumps({
            "id": req.request_id,
            "prompt": prompts[req.request_id],
            "completion": tokenizer.decode(req.generated),
            "tokens": len(req.generated),
            "finish_reason": req.finish_reason,
        }))
    stats = engine.stats()
    total_tokens = sum(len(r.generated) for r in done)
    logging.info(
        "served %d requests, %d tokens in %.2fs (%.1f tok/s aggregate, slot utilization %.0f%%, p50 TTFT %s)",
        len(done), total_tokens, elapsed, total_tokens / elapsed if elapsed else 0.0,
        100 * stats["slot_utilization"],
        f"{stats['p50_ttft']*1e3:.0f}ms" if stats["p50_ttft"] else "n/a",
    )
    return 0


def _stop_on(httpd, failed=()) -> None:
    """SIGTERM stops the server as Ctrl-C does, so that whatever it runs
    (tp ranks, replica processes) stops with it; so does the first of
    ``failed`` (callables, polled) that turns true."""
    import signal
    import threading

    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(target=httpd.shutdown).start())

    def watch():
        while not any(f() for f in failed):
            time.sleep(0.5)
        httpd.shutdown()

    if failed:
        threading.Thread(target=watch, daemon=True).start()


def _serve(args) -> int:
    from .checkpoint import load_checkpoint
    from .configuration import read_config
    from .inference.tokenizer import Tokenizer
    from .serving.server import ReplicatedFrontend, ServingFrontend, serve

    if args.gateway:
        # The cross-host gateway: the tokenizer only; no weights, no device work.
        from .serving.remote import connect_workers

        config = read_config(args.checkpoint)
        tokenizer = Tokenizer(args.checkpoint, config.vocab_size)
        frontend = connect_workers(args.gateway.split(","), tokenizer, wait_s=600.0)
        serve(frontend, host=args.host, port=args.port, ready=_stop_on)
        return 0
    if args.tp > 1 or args.replicas > 1:  # the ranks (or the replica processes) load the weights themselves
        config, weights = read_config(args.checkpoint), None
        devices = _tp_devices(args)  # too few devices: fail before any rank starts
        if args.tp == 1:
            weights = load_checkpoint(args.checkpoint)[1]
    else:
        config, weights = load_checkpoint(args.checkpoint)
        devices = None
    tokenizer = Tokenizer(args.checkpoint, config.vocab_size)
    kw = {"cache_dtype": "int8"} if args.kv_int8 else {}
    if args.replicas > 1 and args.tp > 1:
        return _serve_tp_replicas(args, devices, tokenizer)
    if not args.no_warmup:
        logging.info("warming up (building the kernels)...")
    per = args.tp
    engines = [_engine(args, config, weights, devices[i * per : (i + 1) * per] if devices else None, **kw)
               for i in range(args.replicas)]
    frontends = [ServingFrontend(e, tokenizer) for e in engines]
    frontend = frontends[0] if len(frontends) == 1 else ReplicatedFrontend(frontends)
    # An engine whose step failed cannot serve again (a tp engine's ranks are
    # out of step): the server stops and exits non-zero.
    ready = (lambda httpd: _stop_on(httpd, [f.failed.is_set for f in frontends])) if devices else None
    serve(frontend, host=args.host, port=args.port, **({"ready": ready} if ready else {}))
    errors = [f.error for f in frontends if f.error is not None]
    if errors:
        logging.error("the serving engine failed: %s", errors[0])
        return 1
    return 0


# The serve flags a replica process takes from its front end's.
_REPLICA_FLAGS = ("slots", "sampling", "kv", "page_size", "pages", "spec", "spec_min_accept", "prefill_chunk")


def _serve_tp_replicas(args, devices: list[str], tokenizer) -> int:
    """``serve --replicas R --tp K``: one ``serve --tp K`` process a replica,
    on its slice of the devices and a free local port, behind one router of
    clients (``serving.remote``).  Its ranks are its own children; SIGTERM to
    this process stops every replica, and a replica that exits stops the
    server."""
    import subprocess

    from .parallel.distributed import free_port
    from .serving.remote import RemoteWorkerClient
    from .serving.server import ReplicatedFrontend, serve

    procs, clients = [], []
    try:
        for i in range(args.replicas):
            port = free_port()
            argv = [sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(Path(args.checkpoint).resolve()),
                    "--host", "127.0.0.1", "--port", str(port), "--tp", str(args.tp),
                    "--device", ",".join(devices[i * args.tp : (i + 1) * args.tp])]
            for flag in _REPLICA_FLAGS:
                if getattr(args, flag) is not None:
                    argv += ["--" + flag.replace("_", "-"), str(getattr(args, flag))]
            argv += [f for f, on in (("--kv-int8", args.kv_int8), ("--prefix-cache", args.prefix_cache),
                                     ("--no-warmup", args.no_warmup)) if on]
            procs.append(subprocess.Popen(argv, cwd=Path(__file__).resolve().parents[1]))
            clients.append(RemoteWorkerClient(f"http://127.0.0.1:{port}", tokenizer, prefix_cache=args.prefix_cache))
        logging.info("starting %d replicas of %d ranks...", args.replicas, args.tp)
        deadline = time.monotonic() + 600.0
        while not all(c.healthy(timeout_s=1.0) for c in clients):
            exited = [p.returncode for p in procs if p.poll() is not None]
            if exited:
                raise SystemExit(f"a replica process exited with code {exited[0]} before it served")
            if time.monotonic() > deadline:
                raise TimeoutError("the replica processes did not answer /health within 600 s")
            time.sleep(0.5)
        serve(ReplicatedFrontend(clients), host=args.host, port=args.port,
              ready=lambda httpd: _stop_on(httpd, [lambda: any(p.poll() is not None for p in procs)]))
        failed = [p.returncode for p in procs if p.poll() is not None]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)
    if failed:
        logging.error("a replica process exited with code %d", failed[0])
        return 1
    return 0


def validate_export_dir(model_path: Path) -> None:
    """The model directory holds config.json, tokenizer.json and safetensors."""
    if not model_path.is_dir():
        raise SystemExit(f"Model path is not a directory: {model_path}")
    missing = [f for f in ("config.json", "tokenizer.json") if not (model_path / f).exists()]
    if missing:
        raise SystemExit(f"Model directory {model_path} is missing: {', '.join(missing)}")
    if not list(model_path.glob("*.safetensors")):
        raise SystemExit(f"No .safetensors files found in {model_path}")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
    if args.command != "export":
        # Model commands load the CUDA kernels and the host helper: keep them
        # built across invocations.
        from .utils import enable_compile_cache

        enable_compile_cache()
    if args.command == "export":
        from .export import export_model

        validate_export_dir(Path(args.model_path))
        export_model(args.model_path, args.output_path, args.group_size, fmt=args.format, weight_bits=args.bits)
        return 0
    if args.command in ("batch", "serve"):
        return _batch(args) if args.command == "batch" else _serve(args)
    if args.command == "eval-ppl":
        from .evaluation import evaluate_checkpoint

        text = Path(args.file).read_text()
        results = evaluate_checkpoint(
            args.checkpoint, text=text, modes=tuple(args.modes.split(",")),
            window=args.window, device=args.device,
        )
        payload = {
            mode: {"perplexity": r.perplexity, "avg_nll": r.avg_nll, "tokens": r.n_tokens}
            for mode, r in results.items()
        }
        if "f32" in results:
            for mode, r in results.items():
                if mode != "f32":
                    payload[mode]["ppl_delta_vs_f32"] = r.delta_vs(results["f32"])
        print(json.dumps(payload, indent=2))
        return 0

    from . import InferenceConfig, run_inference

    run_inference(
        InferenceConfig(
            checkpoint_path=args.checkpoint,
            temperature=args.temperature,
            topp=args.topp,
            ctx_length=args.context,
            mode=args.mode,
            prompt=args.input,
            system_prompt=args.system,
            enable_thinking=args.reasoning == 1,
            seed=args.seed,
            engine_mode=args.engine_mode,
            device_sampling=args.device_sampling,
            kv_int8=args.kv_int8,
            speculative=args.spec,
            sp=args.sp,
            sp_threshold=args.sp_threshold,
            device=args.device,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface: the ``inference`` and ``eval-ppl`` subcommands.

The same flags as the reference package's subcommands, plus ``--device``
(default: the card).  Flags whose paths are not ported yet
(``--device-sampling``, ``--spec``, ``--sp > 1``) raise a "not ported" error
naming the ROADMAP.md item; they never run something else.

    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" -t 0
    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" --engine-mode exact
    python -m qwen3_rs_tpu_torch.cli eval-ppl CKPT -f text.txt --modes fast,exact,f32 -w 4096
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qwen3-torch", description="Qwen3 INT8 inference on an NVIDIA GPU (PyTorch + CUDA)"
    )
    sub = parser.add_subparsers(dest="command", required=True)
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
        help="sample on the device (not ported yet; the host xorshift sampler is the default)",
    )
    inf.add_argument(
        "--kv-int8", action="store_true", help="INT8 KV cache with per-row scales"
    )
    inf.add_argument(
        "--spec", type=int, default=0, metavar="K",
        help="n-gram speculative decoding (not ported yet)",
    )
    inf.add_argument(
        "--sp", type=int, default=1, metavar="N",
        help="sequence-parallel prefill over N devices (not ported yet)",
    )
    inf.add_argument(
        "--sp-threshold", type=int, default=4096, metavar="ROWS",
        help="minimum prompt rows to engage the sequence-parallel prefill",
    )
    inf.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; cpu runs the kernels' plain PyTorch versions)",
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
    ev.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; cpu runs the kernels' plain PyTorch versions)",
    )
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
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
            device=args.device,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

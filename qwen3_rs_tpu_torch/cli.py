"""Command-line interface: the ``inference`` subcommand.

The same flags as the reference package's ``inference`` subcommand, plus
``--device`` (default: the card).  Flags whose paths are not ported yet
(``--engine-mode exact``, ``--device-sampling``, ``--spec``, ``--sp > 1``)
raise a "not ported" error naming the ROADMAP.md item; they never run
something else.

    python -m qwen3_rs_tpu_torch.cli inference CKPT -m generate -i "hello" -t 0
"""

from __future__ import annotations

import argparse
import logging
import sys


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
        help="fast = W8A16 with the CUDA kernels; exact (W8A8) is not ported yet",
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
    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
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

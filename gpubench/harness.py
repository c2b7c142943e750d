"""One run of one cell: set-up, the driver's window, the comparison, the
metrics and the result line.

Everything a cell needs is found by name: its configuration file (the
``file`` of its entry in ``BENCHMARK.json``), ``traffic/<traffic>.json``, the
driver that mix names (``drivers/<driver>.py``), ``checks/<cell>.json`` (the
comparison's limit) and one reader a metric (``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

from . import check, counts, traffic
from . import weights as weight_draw

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_rs_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_module(path: Path, name: str):
    if not path.exists():
        raise RunError(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path} not found")
    spec = importlib.util.spec_from_file_location("gpubench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def shapes_of(conf: dict) -> counts.Shapes:
    """A configuration file (the published config's keys, plus ``assumed``)
    → the sizes the run uses."""
    a = conf["assumed"]
    return counts.Shapes(
        dim=conf["hidden_size"], hidden_dim=conf["intermediate_size"], n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"], n_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        vocab_size=conf["vocab_size"], group_size=a["group_size"], seq_len=a["ctx_per_slot"],
        norm_eps=conf["rms_norm_eps"], rope_theta=float(conf["rope_theta"]), tied=conf["tie_word_embeddings"])


def selected(metrics: list, cell: str, reported: set | None = None) -> list:
    """The metrics a cell reports: those that list it, and those without a
    list whose ``moves`` the cell reports (``reported``), or all without a
    list when ``reported`` is None."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    shapes: counts.Shapes
    mix: dict
    check: dict
    driver: object
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = _find(spec["workloads"], name, "workload")
    conf = _find(spec["configs"], entry["config"], "config")
    here = root / "gpubench"
    shapes = shapes_of(json.loads((root / conf["file"]).read_text()))
    mix = traffic.load(here / "traffic" / f"{entry['traffic']}.json")
    limits = json.loads((here / "checks" / f"{name}.json").read_text())
    driver = load_module(here / "drivers" / f"{mix['driver']}.py", mix["driver"])
    e2e = selected(spec["end_to_end"], name)
    layer = selected(spec["per_layer"], name, {m["name"] for m in e2e})
    for m in e2e + layer:
        m["reader"] = load_module(here / "metrics" / f"{m['name']}.py", m["name"])
    return Cell(name, entry, shapes, mix, limits, driver, e2e, layer)


class Context:
    """What a driver gets, and the handle by which the harness frees the
    system under test before the reference runs."""

    def __init__(self, cell: Cell, weights: dict, seed: int, seconds: float, trace: bool, device, t0: float):
        self.shapes, self.mix, self.weights = cell.shapes, cell.mix, weights
        self.seed, self.seconds, self.trace, self.device, self.t0 = seed, seconds, trace, device, t0
        self._held = None

    def sync(self) -> None:
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def hold(self, obj) -> None:
        self._held = obj

    def release(self) -> None:
        import torch

        self._held = None
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    peak: dict | None  # the card's peaks (``peaks.json``), None for an unknown card
    setup_s: float
    window_s: float
    tokens: int
    requests: list
    stats0: dict
    stats1: dict
    n_slots: int
    calls: list
    trace: object  # trace.Summary in a traced run, else None
    lateness_s: list


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, log=print) -> dict:
    """One run on ``device``: returns the result's fields (without the
    device block) and the comparison's numbers under ``checks``."""
    import time

    import torch

    from . import trace as trace_mod

    cuda = str(device).startswith("cuda")
    w = weight_draw.draw(cell.shapes, traffic.derive_seed(seed, 1), device, cell.shapes.tied)
    ctx = Context(cell, w, seed, seconds, trace, device, t0)
    rec = cell.driver.run(ctx)
    setup_s = rec["t_open"] - t0
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = None
    if rec["profiler"] is not None:
        t = time.perf_counter()
        summary = trace_mod.reduce(trace_mod.capture(rec["profiler"]), rec["window_s"])
        log(f"trace: {summary.device_ops} device operations, {summary.attributed} with their launch found, "
            f"read in {time.perf_counter() - t:.1f} s")
    rec["profiler"] = None
    ctx.release()
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peaks = json.loads((HERE / "peaks.json").read_text()).get(kind)
    run = Run(cell=cell, peak=peaks, setup_s=setup_s, window_s=rec["window_s"], tokens=rec["tokens"],
              requests=rec["requests"], stats0=rec["stats0"], stats1=rec["stats1"], n_slots=rec["n_slots"],
              calls=rec["calls"], trace=summary, lateness_s=rec["lateness_s"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m["reader"].read(run)
        if v is None:
            # A metric that lists this cell, and every end-to-end metric,
            # has something to read here: no value is a fault, not a gap.
            if not trace or "workloads" in m:
                raise RunError(f"metric {m['name']} has no value in this run")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    finished = [r for r in run.requests if r.finished]
    log(f"window {run.window_s:.3f} s: {len(run.requests)} requests counted, {len(finished)} finished, "
        f"{run.tokens} tokens; {rec['submitted']} submitted in all")
    if run.lateness_s:
        late = sorted(run.lateness_s)
        log(f"generator lateness over the counted requests: median {late[len(late) // 2] * 1e3:.3f} ms, "
            f"max {late[-1] * 1e3:.3f} ms")

    t = time.perf_counter()
    gaps = check.gaps(w, cell.shapes, check.sample(run.requests, cell.check["sample_tokens"], seed))
    log(f"reference: {gaps['requests']} requests, {gaps['tokens']} greedy and {gaps['sampled_tokens']} sampled "
        f"served tokens compared in {time.perf_counter() - t:.1f} s")
    lim = cell.check
    checks = {"served_gap_sd": {"value": gaps["served_gap_sd"], "limit": lim["limit_gap_sd"]},
              "sampled_gap_sd": {"value": gaps["sampled_gap_sd"], "limit": lim["limit_sampled_gap_sd"]},
              "tokens_compared": {"value": gaps["tokens"], "min": lim["min_tokens"]},
              "sampled_tokens_compared": {"value": gaps["sampled_tokens"], "min": lim["min_tokens"]}}
    correct = all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": len(run.requests),
           "failed": len(run.requests) - len(finished), "metrics": metrics,
           "memory_peak_bytes": int(peak_bytes), "kind": kind, "checks": checks}
    if summary is not None:
        out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = trace_mod.breakdown(summary)
    return out

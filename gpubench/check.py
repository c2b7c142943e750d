"""The comparison that decides ``correct``.

After the window has closed, two samples of the requests that the window
counted and that finished are drawn from the seed, one of the greedy
requests and one of those sampled at their temperature and top-p.  Each
takes requests until it holds the check's ``sample_tokens`` served tokens,
and always holds its longest request (prompt and served tokens).  Both run
once through the plain reference (``reference/qwen3.py``) over each prompt
and its served tokens.

At each served token the reference's logits set a floor: the best logit for
a greedy request, and for a sampled one the lowest logit of the nucleus
(the smallest set of tokens, best first, whose probabilities at the
request's temperature pass its top-p; a token is kept while the mass before
it is at most top-p).  The token's gap is how far its logit lies below that
floor, in units of the standard deviation of the reference's logits at that
row, and nought inside the nucleus.  The run's numbers are the widest gap
of each sample: ``served_gap_sd`` (greedy) and ``sampled_gap_sd``.  The
control reads, at the same rows, the gap of the token that the reference
computed in float8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import qwen3 as ref

ROW_BLOCK = 256  # rows of logits sorted at once for a nucleus


def sample(requests: list, tokens: int, seed: int) -> list:
    """Finished requests, of each kind (greedy, then sampled): the kind's
    longest (prompt and served tokens) first, then others in an order drawn
    from ``seed``, until ``tokens`` served tokens of the kind are taken or
    none is left."""
    picked = []
    for greedy in (True, False):
        pool = [r for r in requests if r.greedy == greedy and r.finished and len(r.served) >= 1]
        if not pool:
            continue
        pool.sort(key=lambda r: (len(r.prompt) + len(r.served), r.index), reverse=True)
        picked.append(pool[0])
        rest, taken = pool[1:], len(pool[0].served)
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3 if greedy else 4]))
        for i in rng.permutation(len(rest)):
            if taken >= tokens:
                break
            picked.append(rest[int(i)])
            taken += len(rest[int(i)].served)
    return picked


def nucleus_floor(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """The lowest logit that each row ``[rows, vocab]`` may serve: its best
    at temperature 0, the lowest of its top-p nucleus at ``temperature``
    otherwise, and its lowest where ``top_p`` keeps every token."""
    if temperature == 0.0:
        return logits.max(dim=-1).values
    if not 0.0 < top_p < 1.0:
        return logits.min(dim=-1).values
    floors = []
    for blk in logits.split(ROW_BLOCK):
        s = torch.sort(blk / temperature, dim=-1, descending=True).values
        p = torch.softmax(s, dim=-1)
        kept = (torch.cumsum(p, dim=-1) - p <= top_p).sum(dim=-1)  # a prefix, at least the best
        floors.append(s.gather(1, (kept - 1)[:, None])[:, 0] * temperature)
    return torch.cat(floors)


def _gap(lg: torch.Tensor, floor: torch.Tensor, tokens: torch.Tensor) -> float:
    below = (floor - lg.gather(1, tokens[:, None])[:, 0]) / lg.std(dim=-1)
    return float(below.clamp(min=0.0).max())


def gaps(weights: dict, shapes, picked: list, control: bool = False) -> dict:
    """The widest gap of the greedy requests' served tokens
    (``served_gap_sd``) and of the sampled requests' (``sampled_gap_sd``),
    with the count of each kind's tokens read; with ``control``, the same of
    the float8 reference's first picks (``control_gap_sd``,
    ``control_sampled_gap_sd``).  A kind with no token reads infinite."""
    res = {"served_gap_sd": 0.0, "sampled_gap_sd": 0.0, "tokens": 0, "sampled_tokens": 0,
           "requests": len(picked)}
    if control:
        res.update(control_gap_sd=0.0, control_sampled_gap_sd=0.0)
    if picked:
        seqs = [list(r.prompt) + list(r.served[:-1]) for r in picked]
        rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.served))) for r in picked]
        out = ref.logits_at(weights, shapes, seqs, rows, ("f32", "fp8") if control else ("f32",))
        for i, r in enumerate(picked):
            lg = out["f32"][i]
            floor = nucleus_floor(lg, r.temperature, r.top_p)
            kind = "served_gap_sd" if r.greedy else "sampled_gap_sd"
            res[kind] = max(res[kind], _gap(lg, floor, torch.as_tensor(list(r.served), device=lg.device)))
            res["tokens" if r.greedy else "sampled_tokens"] += len(r.served)
            if control:
                ck = "control_gap_sd" if r.greedy else "control_sampled_gap_sd"
                res[ck] = max(res[ck], _gap(lg, floor, out["fp8"][i].argmax(dim=-1)))
    for count, keys in (("tokens", ("served_gap_sd", "control_gap_sd")),
                        ("sampled_tokens", ("sampled_gap_sd", "control_sampled_gap_sd"))):
        if not res[count]:
            res.update({k: float("inf") for k in keys if k in res})
    return res

"""N-gram speculative decoding on the device: greedy-exact at temperature 0,
distribution-exact at any temperature.

The port of the reference package's ``inference/speculative.py``.  A round
drafts ``k`` tokens from the token history (the continuation of the most
recent earlier occurrence of the current bigram: prompt lookup), verifies
them in one forward of ``k + 1`` rows and emits the accepted run plus one
token: between 1 and ``k + 1`` tokens for one stream of the weights.

Greedy rows accept a draft while it equals the verify row's argmax (the last
maximum, as the host sampler breaks ties), so the emitted tokens are the
plain greedy loop's.  Sampled rows draw one token per verify row and accept
while it equals the draft: with a deterministic drafter that is exact
speculative sampling (the first mismatch is the corrected sample), and the
emitted prefix is distributed as plain autoregressive sampling.  Draws come
from an explicit ``torch.Generator``: reproducible per seed, not the
reference's ``jax.random`` bits.

Drafting, acceptance and the history update run on the device, as the
reference's do inside its ``lax.scan``.  One thing differs: the port's
forward takes host positions (``models/qwen3.py``), so each round reads its
counts back to the host (one ``[B]`` int32 copy) to advance the positions
before the next round's forward.  ``HOST_READS`` counts those reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sampling import argmax_last, sample_tokens

# Per-round copies of the accepted counts to the host (one a round).
HOST_READS = {"counts": 0}


def ngram_draft_batched(hist: torch.Tensor, hlen: torch.Tensor, cur: torch.Tensor, k: int) -> torch.Tensor:
    """``ngram_draft`` over a batch without a loop over its rows: hist
    ``[B, T]``, hlen ``[B]``, cur ``[B]`` → drafts ``[B, k]`` int32 (the
    reference's ``vmap``)."""
    b, t = hist.shape
    dev = hist.device
    idx = torch.arange(t, device=dev)[None, :]
    hlen = hlen.reshape(b, 1).long()
    # An index past the buffer reads its last entry, as the reference's gather clamps.
    prev = hist.gather(1, (hlen - 2).clamp(0, t - 1))
    hist_prev = torch.cat([hist[:, :1], hist[:, :-1]], dim=1)
    m = (hist == cur.reshape(b, 1)) & (hist_prev == prev) & (idx >= 1) & (idx < hlen - 1) & (hlen >= 2)
    none = torch.full_like(idx.expand(b, t), -1)
    j_any = torch.where(m, idx, none).amax(dim=1)
    j_full = torch.where(m & (idx <= hlen - 1 - k), idx, none).amax(dim=1)
    j = torch.where(j_full >= 0, j_full, j_any)
    found = j >= 0
    # The reference's dynamic_slice clamps the start to t - k; rows past the
    # history are masked.
    start = torch.where(found, j + 1, torch.zeros_like(j)).clamp(max=t - k)
    cols = start[:, None] + torch.arange(k, device=dev)[None, :]
    draft = hist.gather(1, cols)
    valid = found[:, None] & (cols < hlen)
    return torch.where(valid, draft, torch.full_like(draft, -1)).to(torch.int32)


def ngram_draft(hist: torch.Tensor, hlen, cur, k: int) -> torch.Tensor:
    """Propose ``k`` draft tokens after ``cur`` by bigram lookup.

    hist ``[T]`` ints, every consumed token (``hist[hlen - 1] == cur``).
    Finds the most recent ``j < hlen - 1`` with ``(hist[j - 1], hist[j]) ==
    (hist[hlen - 2], cur)``, preferring matches whose continuation holds
    ``k`` real tokens (``j <= hlen - 1 - k``), and returns ``hist[j + 1 : j
    + 1 + k]``; entries with no valid source are -1 (never an argmax, so
    never accepted).  Returns ``[k]`` int32.  A period-p cycle's most recent
    match sits p positions back and clips its continuation to p - 1 drafts;
    an older occurrence of the same bigram continues the same cycle with all
    ``k``."""
    dev = hist.device
    hlen = torch.as_tensor(hlen, device=dev).reshape(1)
    cur = torch.as_tensor(cur, device=dev).reshape(1)
    return ngram_draft_batched(hist.reshape(1, -1), hlen, cur, k)[0]


def _accept(draft: torch.Tensor, toks: torch.Tensor, hist: torch.Tensor, hlen: torch.Tensor, counts_of):
    """Acceptance and the history update, on the device.  draft ``[B, k]``,
    toks ``[B, k + 1]`` (the verify rows' picks), hist ``[B, T]``, hlen
    ``[B]``; ``counts_of(a)`` turns the accepted drafts ``[B]`` into the
    emitted counts.  Returns (counts, hist, hlen)."""
    b, k = draft.shape
    t = hist.shape[1]
    a = torch.cumprod((draft == toks[:, :k]).int(), dim=1).sum(dim=1)
    counts = counts_of(a).to(torch.int32)
    # The reference writes with mode="drop": indices at or past T are
    # dropped.  They go to a padding column that is cut off again (a clamped
    # index would overwrite the last history row).
    iar = torch.arange(k + 1, device=hist.device)[None, :]
    wpos = torch.where(iar < counts[:, None], hlen.reshape(b, 1).long() + iar, torch.full_like(iar, t))
    padded = torch.cat([hist, hist.new_zeros(b, 1)], dim=1)
    hist = padded.scatter(1, wpos.clamp(max=t), toks.to(hist.dtype))[:, :t]
    return counts, hist, hlen + counts


def _read_counts(counts: torch.Tensor) -> np.ndarray:
    HOST_READS["counts"] += 1
    return counts.cpu().numpy().astype(np.int64)


def spec_round_batched(forward, carry, k: int, page_table, active):
    """One batched speculative round of the serving scheduler.

    carry = (cur ``[B]`` ints on the device, cache, pos ``[B]`` host ints,
    hist ``[B, T]`` and hlen ``[B]`` on the device, temps ``[B]`` and topps
    ``[B]`` host floats, generator).  ``forward(window, cache, pos,
    write_mask=, page_table=, return_all_logits=True)`` returns (logits ``[B,
    k + 1, V]``, cache).  Every active slot drafts, verifies and accepts
    (greedy slots by argmax match, sampled slots by sampled-token match);
    inactive slots advance nothing.  Returns (new carry, (tokens ``[B, k + 1]``
    on the device, counts ``[B]`` host ints)): slot b's output is
    ``tokens[b, :counts[b]]``."""
    cur, cache, pos, hist, hlen, temps, topps, generator = carry
    b = cur.shape[0]
    draft = ngram_draft_batched(hist, hlen, cur, k)
    window = torch.cat([cur.reshape(b, 1).to(draft.dtype), draft.clamp(min=0)], dim=1)
    active_np = np.asarray(active, bool).reshape(b)
    logits, cache = forward(window, cache, pos, write_mask=active_np, page_table=page_table, return_all_logits=True)
    temps, topps = np.asarray(temps, np.float32), np.asarray(topps, np.float32)
    if (temps == 0.0).all():
        # An all-greedy batch skips the nucleus pass (the reference's lax.cond).
        toks = argmax_last(logits)
    else:
        dev = logits.device
        toks = sample_tokens(logits.reshape(b * (k + 1), -1), generator,
                             torch.as_tensor(np.repeat(temps, k + 1), device=dev),
                             torch.as_tensor(np.repeat(topps, k + 1), device=dev)).reshape(b, k + 1)
    act = torch.as_tensor(active_np, device=toks.device)
    counts, hist, hlen = _accept(draft, toks, hist, hlen, lambda a: torch.where(act, a + 1, torch.zeros_like(a)))
    cur_next = toks.gather(1, (counts.long() - 1).clamp(min=0)[:, None])[:, 0]
    cur_next = torch.where(act, cur_next, cur.to(cur_next.dtype))
    counts_np = _read_counts(counts)
    new_carry = (cur_next, cache, np.asarray(pos, np.int64) + counts_np, hist, hlen, temps, topps, generator)
    return new_carry, (toks, counts_np)


def spec_round(forward, carry, k: int):
    """One greedy speculative round of a single stream: draft, verify (a
    window of ``k + 1`` rows), accept.

    carry = (cur ``[1]`` on the device, cache, pos ``[1]`` host ints, hist
    ``[T]`` and hlen ``[]`` on the device).  Returns (new carry, (preds
    ``[k + 1]`` on the device, count host int)): the first ``count`` entries
    of preds are the round's tokens (accepted drafts and one more)."""
    cur, cache, pos, hist, hlen = carry
    draft = ngram_draft(hist, hlen, cur, k)
    window = torch.cat([cur.reshape(1).to(draft.dtype), draft.clamp(min=0)])[None, :]
    logits, cache = forward(window, cache, pos, return_all_logits=True)
    preds = argmax_last(logits[0])  # the last maximum, as the host sampler
    # preds[i] is the greedy token after window[:i + 1]: a draft is accepted
    # while it equals it, so the emitted tokens are preds[:count] themselves.
    counts, hist2, hlen2 = _accept(draft[None], preds[None], hist[None], hlen.reshape(1), lambda a: a + 1)
    cur_next = preds.gather(0, (counts.long() - 1))
    count = int(_read_counts(counts)[0])
    return (cur_next, cache, np.asarray(pos, np.int64) + count, hist2[0], hlen2[0]), (preds, count)

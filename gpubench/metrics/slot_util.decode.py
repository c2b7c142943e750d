"""The scheduler's counters across the window: decode tokens over decode
steps times slots (``ContinuousBatchingEngine.stats()``)."""


def read(run):
    steps = run.stats1["decode_steps"] - run.stats0["decode_steps"]
    if steps <= 0:
        return None
    return 100.0 * (run.stats1["decode_tokens"] - run.stats0["decode_tokens"]) / (steps * run.n_slots)

"""Generation loops: single-shot ``generate`` and interactive ``chat``.

The port of the reference package's ``inference/generation.py``: the
host-sampler loops, one decode step per token, and the device-sampling loops,
one ``Engine.decode_chunk`` per chunk of tokens (64 in ``generate``, 32 in a
chat turn); ``generate(spec_k=)`` decodes greedily in speculative chunks of
``Engine.decode_chunk_spec``.  The prompt goes through prefill windows
instead of a token-at-a-time feed.

Sampling parity: in chat mode the Rust reference draws one RNG coin per
*prompt* token as well (it samples after every fed token and keeps only the
last sample, generation.rs:116-123); the loop here advances the xorshift
stream the same way, so a seed gives the same token stream.

Intentional divergence from the Rust reference, kept from the reference
package: the Rust ``generate`` never runs the model on prompt tokens, so its
prompt positions attend over zeroed KV rows; this engine prefills the prompt.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

import numpy as np

from .engine import Engine, TokenMetrics, TokenSampler
from .tokenizer import Tokenizer, Utf8StreamDecoder

logger = logging.getLogger(__name__)


def _emit(text: str, out=None):
    (out or sys.stdout).write(text)
    (out or sys.stdout).flush()


def generate(
    engine: Engine,
    tokenizer: Tokenizer,
    sampler: TokenSampler,
    prompt: Optional[str],
    out=None,
    max_tokens: Optional[int] = None,
    spec_k: int = 0,
) -> list[int]:
    """Single-prompt generation (generation.rs:9-48). Returns generated ids.

    ``max_tokens`` stops after that many generated tokens; by default the
    loop runs to a termination token or the end of the context, as the
    reference does.  ``spec_k > 0`` enables n-gram speculative decoding
    (``speculative.py``): greedy-exact, so it takes effect with temperature
    0 and device sampling."""
    prompt_tokens = tokenizer.encode(prompt or "")
    if not prompt_tokens:
        raise ValueError("Please provide a prompt")

    seq_len = engine.config.seq_len
    prompt_tokens = prompt_tokens[:seq_len]
    metrics = TokenMetrics()
    decoder = Utf8StreamDecoder()
    metrics.start_prefill()

    # Echo the prompt as the reference does while feeding it (generation.rs:41).
    _emit(decoder.push(b"".join(tokenizer.decode_bytes(t) for t in prompt_tokens)), out)

    cache = engine.new_cache(1)
    logits, cache = engine.prefill(
        cache, np.asarray([prompt_tokens], np.int32), np.zeros(1, np.int32)
    )

    generated: list[int] = []
    pos = len(prompt_tokens) - 1

    if sampler.device:
        if spec_k > 0 and sampler.temperature == 0.0:
            _generate_spec(engine, tokenizer, sampler, logits, cache, pos, generated, metrics, decoder, out,
                           max_tokens, spec_k, prompt_tokens)
        else:
            _generate_chunks(engine, tokenizer, sampler, logits, cache, pos, generated, metrics, decoder, out,
                             max_tokens)
        _emit(decoder.flush(), out)
        metrics.report_and_reset()
        _emit("\n", out)
        return generated

    while True:
        metrics.start_generation()
        next_token = sampler.sample(logits)
        metrics.increment()
        if tokenizer.is_termination(next_token):
            break
        generated.append(next_token)
        _emit(decoder.push(tokenizer.decode_bytes(next_token)), out)
        pos += 1
        if pos >= seq_len or len(generated) == max_tokens:
            break
        logits, cache = engine.decode_step(
            cache, np.asarray([next_token]), np.asarray([pos])
        )

    _emit(decoder.flush(), out)
    metrics.report_and_reset()
    _emit("\n", out)
    return generated


def _generate_chunks(engine, tokenizer, sampler, logits, cache, pos, generated, metrics, decoder, out,
                     max_tokens, chunk_size: int = 64) -> None:
    """The device branch of ``generate``: forward and sampling of each chunk on
    the device, one ``decode_chunk`` call per chunk; a chunk's last token is
    the next chunk's input, emitted at the top of the loop as the single-step
    loop emits it.  A chunk never outruns ``max_tokens``."""
    metrics.start_generation()
    next_token = sampler.sample(logits)
    metrics.increment()
    done = tokenizer.is_termination(next_token)
    pos += 1  # next_token is fed at position len(prompt)
    seq_len = engine.config.seq_len
    while not done:
        generated.append(next_token)
        _emit(decoder.push(tokenizer.decode_bytes(next_token)), out)
        if pos >= seq_len or len(generated) == max_tokens:
            break
        n = min(chunk_size, seq_len - pos)
        if max_tokens is not None:
            n = min(n, max_tokens - len(generated))
        chunk, cache = engine.decode_chunk(cache, next_token, pos, n, temperature=sampler.temperature,
                                           topp=sampler.topp, generator=sampler.next_generator(engine.device))
        pos += n
        for t in chunk[:-1]:
            t = int(t)
            metrics.increment()
            if tokenizer.is_termination(t):
                return
            generated.append(t)
            _emit(decoder.push(tokenizer.decode_bytes(t)), out)
        next_token = int(chunk[-1])
        metrics.increment()
        done = tokenizer.is_termination(next_token)


# Rounds a speculative chunk takes: the largest that fits the room left.
SPEC_ROUND_BUCKETS = (16, 8, 4, 2, 1)


def _generate_spec(engine, tokenizer, sampler, logits, cache, pos, generated, metrics, decoder, out, max_tokens,
                   spec_k, prompt_tokens) -> None:
    """The speculative branch of ``generate``: each round verifies ``spec_k``
    drafted tokens in one forward and emits 1 to ``spec_k + 1`` tokens, the
    plain greedy loop's.  A chunk takes the largest round bucket that fits
    the context (and ``max_tokens``, a round emitting at least one token);
    fewer than ``spec_k + 1`` rows left finish on the plain ``decode_chunk``,
    since a round could overrun the cache."""
    metrics.start_generation()
    next_token = sampler.sample(logits)
    metrics.increment()
    done = tokenizer.is_termination(next_token)
    pos += 1
    history = list(prompt_tokens) + [next_token]
    seq_len = engine.config.seq_len
    while not done:
        generated.append(next_token)
        _emit(decoder.push(tokenizer.decode_bytes(next_token)), out)
        if len(generated) == max_tokens:
            break
        left = None if max_tokens is None else max_tokens - len(generated)
        n_avail = (seq_len - pos) // (spec_k + 1)
        if left is not None:
            n_avail = min(n_avail, left)
        n_rounds = next((rb for rb in SPEC_ROUND_BUCKETS if rb <= n_avail), 0)
        if n_rounds > 0:
            toks, counts, cache = engine.decode_chunk_spec(cache, next_token, pos, n_rounds, spec_k,
                                                           np.asarray(history))
            emitted = [int(t) for r in range(n_rounds) for t in toks[r, : counts[r]]]
        else:
            room = seq_len - pos
            if room <= 0:
                break
            tail, cache = engine.decode_chunk(cache, next_token, pos, room if left is None else min(room, left),
                                              temperature=0.0)
            emitted = [int(t) for t in tail]
        pos += len(emitted)
        history.extend(emitted)
        if left is not None:
            emitted = emitted[:left]
        for t in emitted[:-1]:
            metrics.increment()
            if tokenizer.is_termination(t):
                return
            generated.append(t)
            _emit(decoder.push(tokenizer.decode_bytes(t)), out)
        next_token = emitted[-1]
        metrics.increment()
        done = tokenizer.is_termination(next_token)


def render_prompt(
    pos: int, system_prompt: Optional[str], user_prompt: str, tokenizer: Tokenizer
) -> str:
    """Template rendering (generation.rs:188-195).  Note: with a system
    prompt the reference substitutes *every* ``%s`` in the system template
    with the same "system\\nuser" string (Rust ``str::replace`` replaces all
    occurrences) — replicated verbatim."""
    if pos == 0 and system_prompt is not None:
        return tokenizer.system_prompt_template.replace("%s", f"{system_prompt}\n{user_prompt}")
    return tokenizer.prompt_template.replace("%s", user_prompt)


def chat(
    engine: Engine,
    tokenizer: Tokenizer,
    sampler: TokenSampler,
    cli_user_prompt: Optional[str] = None,
    system_prompt: Optional[str] = None,
    out=None,
    input_fn: Callable[[], str] = None,
    max_tokens: Optional[int] = None,
) -> None:
    """Interactive chat loop (generation.rs:50-93).  ``max_tokens`` ends an
    assistant turn after that many tokens, as a termination token would."""
    seq_len = engine.config.seq_len
    cache = engine.new_cache(1)
    pos = 0
    user_turn = True
    next_token = 0
    turn_tokens = 0
    cli_consumed = False
    metrics = TokenMetrics()
    decoder = Utf8StreamDecoder()

    def read_user_input() -> str:
        if input_fn is not None:
            return input_fn()
        _emit("> ", out)
        return sys.stdin.readline().strip()

    while True:
        if pos >= seq_len:
            # Hard context reset when the window is exhausted
            # (generation.rs:65-69); cache entries are simply overwritten.
            metrics.report_and_reset()
            pos = 0
            user_turn = True
            _emit("\n", out)

        if user_turn:
            metrics.report_and_reset()
            if cli_user_prompt is not None and not cli_consumed:
                # The reference keys this on pos==0 (generation.rs:175-177),
                # which would re-feed the CLI prompt after a context reset;
                # an explicit consumed flag keeps the single-shot intent.
                user_prompt = cli_user_prompt
                cli_consumed = True
            elif cli_user_prompt is not None:
                break  # single-shot CLI prompt already consumed (generation.rs:177)
            else:
                user_prompt = read_user_input()
            if not user_prompt and not (pos == 0 and cli_user_prompt is not None):
                break

            rendered = render_prompt(pos, system_prompt, user_prompt, tokenizer)
            prompt_tokens = tokenizer.encode(rendered)
            prompt_tokens = prompt_tokens[: max(seq_len - pos, 0)]
            if not prompt_tokens:
                break

            metrics.start_prefill()
            logits, cache = engine.prefill(
                cache,
                np.asarray([prompt_tokens], np.int32),
                np.asarray([pos], np.int32),
            )
            # RNG parity: the reference samples after every prompt token and
            # keeps only the last result (generation.rs:116-123) — advance
            # the coin stream for the discarded draws.
            sampler.skip_draws(len(prompt_tokens) - 1)
            next_token = sampler.sample(logits)
            pos += len(prompt_tokens)
            user_turn = False
            turn_tokens = 0
        else:
            if tokenizer.is_termination(next_token) or turn_tokens == max_tokens:
                metrics.report_and_reset()
                _emit(decoder.flush() + "\n", out)
                user_turn = True
                continue
            metrics.start_generation()
            _emit(decoder.push(tokenizer.decode_bytes(next_token)), out)
            if sampler.device:
                # A chunk of the turn on the device.  Rows written past a
                # termination token inside the chunk are overwritten before
                # any query reads them: the next turn prefills from there.
                n = min(32, seq_len - pos)
                if max_tokens is not None:
                    n = min(n, max_tokens - turn_tokens)
                chunk_toks, cache = engine.decode_chunk(
                    cache, next_token, pos, n, temperature=sampler.temperature, topp=sampler.topp,
                    generator=sampler.next_generator(engine.device),
                )
                taken = n
                for idx in range(n - 1):
                    t = int(chunk_toks[idx])
                    metrics.increment()
                    if tokenizer.is_termination(t):
                        taken = idx + 1
                        break
                    _emit(decoder.push(tokenizer.decode_bytes(t)), out)
                else:
                    metrics.increment()
                next_token = int(chunk_toks[taken - 1])
                turn_tokens += taken
                pos += taken
                continue
            logits, cache = engine.decode_step(
                cache, np.asarray([next_token]), np.asarray([pos])
            )
            next_token = sampler.sample(logits)
            metrics.increment()
            turn_tokens += 1
            pos += 1

"""Random INT8-g64 weights drawn on the card from the run's seed.

One ``torch.Generator`` on the device, one call a tensor, in the types they
are served in: int8 codes uniform over ±127, scales uniform over [0, 0.02)
drawn in bf16 (the embedding's kept in f32, bf16 values), norm weights
1 + 0.02·N(0, 1) in f32.  Layouts: every linear layer in-major (``x @ W``
with ``W[n, d] = q[n, d] · s[n // g, d]``) and stacked over the layers; wqkv's
columns are q | k | v, w13's gate | up; the embedding is row-major with its
groups along the model width.  An untied classifier (``tie_word_embeddings``
false) is an in-major ``[dim, vocab]`` matrix of its own.  Both the program
and the reference read these tensors; neither changes them.
"""

from __future__ import annotations

import torch

from .counts import Shapes


def draw(c: Shapes, seed: int, device, tied: bool) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = c.group_size
    L = c.n_layers

    def codes(*shape):
        return torch.empty(shape, dtype=torch.int8, device=device).random_(-127, 128, generator=gen)

    def scales(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=torch.bfloat16, device=device).uniform_(0.0, 0.02, generator=gen).to(dtype)

    def norm(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device).normal_(1.0, 0.02, generator=gen)

    w = {
        "embed_q": codes(c.vocab_size, c.dim),
        "embed_s": scales(c.vocab_size, c.dim // g, dtype=torch.float32),
        "rms_att": norm(L, c.dim),
        "rms_ffn": norm(L, c.dim),
        "q_norm": norm(L, c.head_dim),
        "k_norm": norm(L, c.head_dim),
        "rms_final": norm(c.dim),
    }
    for name, n, d in (("wqkv", c.dim, c.all_heads_dim + 2 * c.kv_dim), ("wo", c.all_heads_dim, c.dim),
                       ("w13", c.dim, 2 * c.hidden_dim), ("w2", c.hidden_dim, c.dim)):
        w[name + "_q"] = codes(L, n, d)
        w[name + "_s"] = scales(L, n // g, d)
    if not tied:
        w["lm_q"] = codes(c.dim, c.vocab_size)
        w["lm_s"] = scales(c.dim // g, c.vocab_size)
    return w

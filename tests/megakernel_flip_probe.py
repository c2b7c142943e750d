"""Which bf16 rounding parts #11's first layer from its plain version, on a
case of ``test_torch_cuda.py::test_megakernel_ring_matches_plain``.

Card only (the kernel has no CPU mode).  Run from the repository's root:

    python tests/megakernel_flip_probe.py [B G Q4]     # default: 2 64 0

For the case's inputs it prints each row's distance from the plain version
after one layer and after two (the second also against the plain second
layer from the kernel's own first-layer output, as the test holds it).  Then,
for each row the first layer moved by more than 1e-5, it recomputes the plain
layer with the four bf16-rounded activations recorded (the wqkv and w13
inputs after RMSNorm, the attention output, SwiGLU's output), takes the
values nearest a midpoint between two bf16 numbers, rounds each in turn to
the other neighbour, and prints how far that plain row then lies from the
kernel's: a row that a single flip brings to ~1e-7 differs from the plain
version by that rounding alone.
"""

import dataclasses
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402
from test_torch_cuda import _gen, _mega, _mega_inputs  # noqa: E402

from qwen3_rs_tpu_torch.configuration import ModelConfig  # noqa: E402
from qwen3_rs_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16_plain  # noqa: E402

ACTIVATIONS = ("wqkv input (RMSNorm)", "wo input (attention)", "w13 input (RMSNorm)", "w2 input (SwiGLU)")


def bf(v):
    return v.to(torch.bfloat16).float()


def other(v):
    """The bf16 neighbour of each value that round-to-nearest did not take."""
    r = bf(v).to(torch.bfloat16)
    inf = torch.tensor(float("inf"), dtype=torch.bfloat16, device=v.device)
    up, down = torch.nextafter(r, inf).float(), torch.nextafter(r, -inf).float()
    return torch.where(v > r.float(), up, down)


def tie_distance(v):
    """|v - the midpoint of its two bf16 neighbours| in bf16 steps: 0 is a tie."""
    r, o = bf(v), other(v)
    return ((v - (r + o) / 2).abs() / (r - o).abs()).nan_to_num(1.0)


def main(b=2, g=64, q4=False, candidates=12):
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.device("cuda")
    cache = ("f32", "bf16", "int8")[(b + g // 32 + int(q4)) % 3]
    cfg = ModelConfig(architecture_id=1, dim=640, hidden_dim=896, n_layers=2, n_heads=5, n_kv_heads=1,
                      head_dim=128, seq_len=200, vocab_size=1000, group_size=g, shared_classifier=True)
    w, x, cos, sin, kv, sc = _mega_inputs(_gen(b * 41 + g + 7 * int(q4)), card, cfg, b, cache, 1024, q4=q4)
    pos = torch.tensor([0, 199, 64, 150, 1, 128, 127, 230][:b], dtype=torch.int32, device=card)
    ok = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1][:b], dtype=torch.int32, device=card)

    def layers(lo, hi):
        ws = dict(w)
        for k in ("rms_att", "rms_ffn", "q_norm", "k_norm"):
            ws[k] = w[k][lo:hi]
        for k in ("wqkv", "wo", "w13", "w2"):
            ws[k] = type(w[k])(w[k].q[lo:hi], w[k].scales[lo:hi])
        return dataclasses.replace(cfg, n_layers=hi - lo), ws

    def state(lo, hi):
        return [t[lo:hi].clone() if t is not None else None for t in kv + sc]

    def run(fn, lo, hi, x_in):
        c, ws = layers(lo, hi)
        st = state(lo, hi)
        return _mega(fn, c, ws, x_in, cos, sin, st[:2], st[2:], pos, ok)[0]

    def rel(a, ref):
        return float((a - ref).abs().max()) / float(ref.abs().max())

    gx1, px1 = run(mk.decode_stack_megakernel, 0, 1, x), run(mk.decode_stack_megakernel_plain, 0, 1, x)
    gx2, px2 = run(mk.decode_stack_megakernel, 0, 2, x), run(mk.decode_stack_megakernel_plain, 0, 2, x)
    pl2 = run(mk.decode_stack_megakernel_plain, 1, 2, gx1)
    torch.cuda.synchronize()
    print(f"B={b} g={g} {'INT4' if q4 else 'INT8'} {cache} cache")
    print("one layer, kernel vs plain, by row:", [f"{rel(gx1[r], px1[r]):.3e}" for r in range(b)])
    print("two layers, kernel vs plain:", [f"{rel(gx2[r], px2[r]):.3e}" for r in range(b)])
    print("two layers, kernel vs the plain second layer from the kernel's first:",
          [f"{rel(gx2[r], pl2[r]):.3e}" for r in range(b)])

    _, w1 = layers(0, 1)
    hd, ah, kvd, eps = cfg.head_dim, cfg.all_heads_dim, cfg.kv_dim, cfg.norm_eps

    def plain_layer(flip=None):
        """The plain version's layer 0 written out, each activation's f32
        values recorded before their bf16 rounding; ``flip`` = (activation,
        row, column) rounds that one value the other way."""
        st = state(0, 1)
        rec = []

        def act(i, v):
            rec.append(v)
            vb = bf(v)
            if flip is not None and flip[0] == i:
                vb = vb.clone()
                vb[flip[1], flip[2]] = other(v)[flip[1], flip[2]]
            return vb

        def rms(v, nw):
            return v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps) * nw.float()

        xf = x.float()
        qkv = qmatmul_w8a16_plain(act(0, rms(xf, w1["rms_att"][0])), w1["wqkv"], 0)
        q = mk._rms_rows(qkv[:, :ah].reshape(b, cfg.n_heads, hd), w1["q_norm"][0].float(), eps)
        k = mk._rms_rows(qkv[:, ah:ah + kvd].reshape(b, cfg.n_kv_heads, hd), w1["k_norm"][0].float(), eps)
        v = qkv[:, ah + kvd:].reshape(b, cfg.n_kv_heads, hd)
        q = mk._rope(q, cos[:, None, :], sin[:, None, :]) * (1.0 / hd**0.5)
        k = mk._rope(k, cos[:, None, :], sin[:, None, :])
        quant = st[2] is not None
        att = mk._layer_attention(q, k, v, st[0][0], st[1][0], st[2][0] if quant else None,
                                  st[3][0] if quant else None, pos.long().clamp(0, cfg.seq_len))
        x1 = qmatmul_w8a16_plain(act(1, att), w1["wo"], 0, residual=xf)
        gu = qmatmul_w8a16_plain(act(2, rms(x1, w1["rms_ffn"][0])), w1["w13"], 0)
        n = gu.shape[-1] // 2
        x2 = qmatmul_w8a16_plain(act(3, gu[:, :n] * torch.sigmoid(gu[:, :n]) * gu[:, n:]), w1["w2"], 0, residual=x1)
        return x2, rec

    x0, rec = plain_layer()
    print(f"the plain layer written out vs the plain version: {rel(x0, px1):.3e}")
    for r in range(b):
        if rel(gx1[r], px1[r]) <= 1e-5:
            continue
        near = []
        for i, v in enumerate(rec):
            d = tie_distance(v[r])
            vals, idx = torch.topk(-d, min(candidates, d.numel()))
            near += [(-float(dv), i, int(j)) for dv, j in zip(vals, idx)]
        print(f"row {r}: the {candidates} values of each activation nearest a bf16 tie, nearest first:")
        for dist, i, j in sorted(near)[:candidates]:
            flipped, _ = plain_layer((i, r, j))
            print(f"  {ACTIVATIONS[i]} column {j} = {float(rec[i][r, j])!r}, {dist:.3e} of a bf16 step from the "
                  f"tie: flipped, the plain row lies {rel(gx1[r], flipped[r]):.3e} from the kernel's "
                  f"({rel(flipped[r], px1[r]):.3e} from its own)")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(a[0]), int(a[1]), a[2] == "1") if a else ())

"""Inputs the benchmark makes from ``--seed``: a dense decoder's weights,
on the device, in the type they are served in, one generator call a
(layer-stacked) leaf.

Every matrix is drawn at its true fan-in (std 1/sqrt(fan-in): d for the
q, k, v, gate and up projections, Hq x head_dim for the output projection,
d_ff for the down projection, d for the head), the embedding at std 1 and
the norm gains at 1 + 0.1 N(0, 1): a network whose activations keep their
scale through its depth, so that two sound implementations agree on its
logits to rounding.  The tree is the one the program takes (its layer
leaves stacked over the layers).
"""
from __future__ import annotations

import torch


def decoder_params(c: dict, seed: int, device, dtype=torch.bfloat16):
    d, Hq, Hkv, D = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    ff, n = c["d_ff"], c["n_layers"]
    pv = -(-c["vocab"] // 2048) * 2048
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))

    def normal(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    def gain(shape):
        return normal(shape, 0.1).add_(1.0)

    return {
        "embed": {"embedding": normal((pv, d), 1.0)},
        "blocks": {"s0_block": {
            "attn": {"ln": gain((n, d)),
                     "w_q": normal((n, d, Hq, D), d ** -0.5),
                     "w_k": normal((n, d, Hkv, D), d ** -0.5),
                     "w_v": normal((n, d, Hkv, D), d ** -0.5),
                     "w_o": normal((n, Hq, D, d), (Hq * D) ** -0.5)},
            "mlp": {"ln": gain((n, d)),
                    "w_gate": normal((n, d, ff), d ** -0.5),
                    "w_up": normal((n, d, ff), d ** -0.5),
                    "w_down": normal((n, ff, d), ff ** -0.5)}}},
        "final_norm": gain((d,)),
        "lm_head": normal((pv, d), d ** -0.5),
    }

"""The weights of a hybrid MoE decoder (granite-4.0-h) made from ``--seed``,
on the device, in the type they are served in, one generator call a
(layer-stacked) leaf, in the tree the program takes: ``blocks/s{i}_mamba``
and ``blocks/s{i}_attn`` per position of the layer pattern, each leaf
stacked over the pattern's periods.

Every matrix is drawn at its true fan-in (std 1/sqrt(fan-in)) and the norm
gains at 1 + 0.1 N(0, 1), as ``weights.py`` draws a dense decoder's, with
two departures that keep the random network from being degenerate:

* the tied embedding at std 1 / (embedding_multiplier sqrt(d)), so that the
  scaled input embedding has unit norm and the residual stream, which the
  sublayers' outputs grow to a per-element spread near 2, is not the input
  token's echo: at std 1 or d^-1/2 the tied head's largest logit is the
  current token's at every position, and a greedy run repeats its input
  whatever the layers compute;
* w_q and w_k at (sqrt(D) m)^(-1/2) times their fan-in std, m the
  attention multiplier, so that the scores have unit spread, as the usual
  1/sqrt(D) gives fan-in weights (D^(1/4) for the published m = 1/D):
  near-uniform attention would hide the positions.

The Mamba-2 leaves follow its own init: conv taps at fan-in 4 and conv
biases U(-0.5, 0.5) (PyTorch's Conv1d rule), A_log = log U[1, 16], dt_bias
= softplus^-1(dt) for dt log-uniform in [1e-3, 1e-1], D = 1; so the state
decays as a trained model's does.  The experts are the ones this card
holds: ``num_local_experts`` of them.
"""
from __future__ import annotations

import math

import torch

KIND = {"mamba": "mamba", "attention": "attn"}


def layer_period(types) -> int:
    """The shortest repeat of ``layer_types``."""
    n = len(types)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and list(types[:p]) * (n // p) == list(types))


def hybrid_params(c: dict, seed: int, device, dtype=torch.bfloat16):
    d, Hq, Hkv, D = (c["hidden_size"], c["num_attention_heads"],
                     c["num_key_value_heads"], c["head_dim"])
    H, P, N, K = (c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"],
                  c["mamba_d_conv"])
    di = c["mamba_expand"] * d
    E, Eh, ff, sff = (c["router_experts"], c["num_local_experts"],
                      c["intermediate_size"], c["shared_intermediate_size"])
    types = c["layer_types"]
    period = layer_period(types)
    n = c["num_hidden_layers"] // period
    pv = -(-c["vocab_size"] // 2048) * 2048
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))

    def normal(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    def uniform(shape, lo, hi):
        t = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float32)
        return t.mul_(hi - lo).add_(lo)

    def gain(shape):
        return normal(shape, 0.1).add_(1.0)

    def mamba():
        dt = torch.exp(uniform((n, H), math.log(1e-3), math.log(1e-1)))
        return {
            "w_z": normal((n, d, di), d ** -0.5),
            "w_x": normal((n, d, di), d ** -0.5),
            "w_B": normal((n, d, N), d ** -0.5),
            "w_C": normal((n, d, N), d ** -0.5),
            "w_dt": normal((n, d, H), d ** -0.5),
            "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
            "A_log": torch.log(uniform((n, H), 1.0, 16.0)).to(dtype),
            "D": torch.ones((n, H), device=device, dtype=dtype),
            "conv_x": normal((n, K, di), K ** -0.5),
            "conv_B": normal((n, K, N), K ** -0.5),
            "conv_C": normal((n, K, N), K ** -0.5),
            "conv_x_b": uniform((n, di), -0.5, 0.5).to(dtype),
            "conv_B_b": uniform((n, N), -0.5, 0.5).to(dtype),
            "conv_C_b": uniform((n, N), -0.5, 0.5).to(dtype),
            "norm": gain((n, di)),
            "w_out": normal((n, di, d), di ** -0.5),
        }

    def attn():
        qk = (D ** 0.5 * c["attention_multiplier"]) ** -0.5 * d ** -0.5
        return {"ln": gain((n, d)),
                "w_q": normal((n, d, Hq, D), qk),
                "w_k": normal((n, d, Hkv, D), qk),
                "w_v": normal((n, d, Hkv, D), d ** -0.5),
                "w_o": normal((n, Hq, D, d), (Hq * D) ** -0.5)}

    def moe():
        return {"w_router": normal((n, d, E), d ** -0.5),
                "w_gate": normal((n, Eh, d, ff), d ** -0.5),
                "w_up": normal((n, Eh, d, ff), d ** -0.5),
                "w_down": normal((n, Eh, ff, d), ff ** -0.5),
                "shared": {"w_gate": normal((n, d, sff), d ** -0.5),
                           "w_up": normal((n, d, sff), d ** -0.5),
                           "w_down": normal((n, sff, d), sff ** -0.5)}}

    blocks = {}
    for i, t in enumerate(types[:period]):
        kind = KIND[t]
        blk = ({"ln": gain((n, d)), "mamba": mamba()} if kind == "mamba"
               else {"attn": attn()})
        blk["ln_moe"] = gain((n, d))
        blk["moe"] = moe()
        blocks[f"s{i}_{kind}"] = blk
    emb = 1.0 / (c["embedding_multiplier"] * d ** 0.5)
    return {"embed": {"embedding": normal((pv, d), emb)},
            "blocks": blocks, "final_norm": gain((d,))}

"""Analytic FLOP / HBM-byte model per (arch x shape) cell, the JAX
package's ``analysis/costs.py`` with the card's constants.

It computes *executed* FLOPs analytically (including causal-masking waste,
remat recompute and MoE capacity); the reference validated it against
exact HLO counts on small UNROLLED configs, and the port's tests hold it
against ``torch.utils.flop_counter.FlopCounterMode`` on the same configs.
The arithmetic is the reference's, line for line.

Terms reported per device on the (data=16, model=16) mesh:
    compute_s    = executed_flops / chips / 989e12   (bf16 dense peak)
    memory_s     = hbm_bytes / chips / 3.35e12
    collective_s = wire_bytes_per_device / 50e9      (from the dry-run)
MODEL_FLOPS = 6·N·D (train) or 2·N_active·D (serve); usefulness =
MODEL_FLOPS / executed_flops.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.layers import padded_vocab

# NVIDIA H100 SXM5 data sheet: bf16 dense tensor-core peak and HBM3 rate
PEAK_FLOPS = 989e12      # FLOP/s per card
HBM_BW = 3.35e12         # bytes/s per card
# one 400 Gb/s ConnectX-7 port per GPU on an HGX H100 node of 8: a 16-wide
# model axis crosses nodes, so this is the slowest link it uses
LINK_BW = 50e9           # bytes/s per card

CHIPS = 256              # single-pod 16x16 (roofline table is single-pod)


def _attn_kv_len(cfg: ModelConfig, S: int, window: int | None) -> int:
    """Executed kv positions per query in the blocked XLA path."""
    if window is None:
        return S
    return min(S, window + 2 * cfg.attn_block_kv)


def _per_token_layer_flops(cfg: ModelConfig, S: int, kind: str) -> float:
    """Forward FLOPs per token for ONE pattern step (may hold >1 layer)."""
    d, Dh = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads * cfg.kv_repeat
    f = 0.0

    def attn(window):
        qkvo = 2 * d * Dh * (2 * Hq + 2 * Hkv)
        kv_len = _attn_kv_len(cfg, S, window) if kind != "decode" else (
            min(S, window) if window else S)
        sc = 2 * 2 * kv_len * Hq * Dh
        return qkvo + sc

    def mlp():
        return 6 * d * cfg.d_ff

    def moe():
        r = 2 * d * cfg.n_experts
        eff = cfg.top_k * cfg.capacity_factor
        return r + eff * 6 * d * cfg.d_ff_expert

    def mamba():
        di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        proj = 2 * d * (2 * di + 2 * N + H) + 2 * di * d
        conv = 2 * cfg.ssm_conv * (di + 2 * N)
        L = cfg.ssm_chunk
        if kind == "decode":
            ssd = 6 * N * P * H           # state update + readout per head
        else:
            ssd = H * (2 * L * N + 2 * L * P + 6 * N * P)
        return proj + conv + ssd

    if cfg.family == "encdec":
        # every (source, target) position pair runs one enc / dec layer stack;
        # cross-attention scores span S_src (== S here)
        enc = cfg.n_enc_layers * (attn(None) + mlp())
        cross = 2 * d * Dh * (2 * Hq + 2 * Hkv) + 2 * 2 * S * Hq * Dh
        dec = cfg.n_dec_layers * (attn(None) + cross + mlp())
        return enc + dec, 1

    from repro_torch.models.transformer import _pattern
    pattern, n_steps = _pattern(cfg)
    for k in pattern:
        if k == "mamba":
            f += mamba()
        elif k == "local":
            f += attn(cfg.sliding_window) + mlp()
        elif k == "global":
            f += attn(None) + mlp()
        else:
            f += attn(cfg.sliding_window) + (moe() if cfg.family == "moe"
                                             else mlp())
    if cfg.family == "hybrid":
        f += attn(None) + mlp() + 2 * (2 * d) * d   # shared block + concat proj
    return f, n_steps


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(N_total, N_flops) from the spec tree.  N_flops is the 6·N·D-effective
    count: MoE activates top_k of n_experts; zamba2's SHARED blocks contribute
    one invocation of compute per pattern step from a single stored copy
    (parameter sharing != compute sharing — without this correction the
    usefulness ratio blames the architecture for its own design)."""
    from repro_torch.models.params import param_count
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    n_total = param_count(model.specs())
    n_active = n_total
    if cfg.family == "moe":
        expert = 3 * cfg.d_model * cfg.d_ff_expert * cfg.n_experts * cfg.n_layers
        n_active = n_total - expert + expert * cfg.top_k / cfg.n_experts
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import _pattern, shared_block_specs
        _, n_steps = _pattern(cfg)
        shared_one = param_count(shared_block_specs(cfg))
        stored = shared_one * max(cfg.n_shared_blocks, 1)
        n_active = n_total - stored + shared_one * n_steps
    return int(n_total), int(n_active)


@dataclasses.dataclass
class CellCost:
    executed_flops: float        # total, all chips
    model_flops: float
    hbm_bytes: float             # total, all chips
    tokens: int

    def terms(self, wire_bytes_per_device: float, chips: int = CHIPS) -> dict:
        comp = self.executed_flops / chips / PEAK_FLOPS
        mem = self.hbm_bytes / chips / HBM_BW
        coll = wire_bytes_per_device / LINK_BW
        dom = max(("compute", comp), ("memory", mem), ("collective", coll),
                  key=lambda kv: kv[1])
        useful = self.model_flops / max(self.executed_flops, 1.0)
        ideal = self.model_flops / chips / PEAK_FLOPS
        return {
            "compute_s": comp, "memory_s": mem, "collective_s": coll,
            "dominant": dom[0], "dominant_s": dom[1],
            "usefulness": useful,
            "roofline_fraction": ideal / max(dom[1], 1e-30),
        }


def analytic_cell(cfg: ModelConfig, shape: ShapeSpec) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    n_total, n_active = param_counts(cfg)
    pv = padded_vocab(cfg.vocab)

    if shape.kind == "decode":
        tokens = B                     # one new token per sequence
        per_tok, n_steps = _per_token_layer_flops(cfg, S, "decode")
        fwd = tokens * (per_tok * n_steps + 2 * cfg.d_model * pv)
        executed = fwd
        model = 2 * n_active * tokens
        # params read once + full KV/state cache traffic + small writes
        kv_bytes = _cache_bytes(cfg, B, S)
        hbm = n_total * 2 + kv_bytes
        return CellCost(executed, model, hbm, tokens)

    tokens = B * S
    per_tok, n_steps = _per_token_layer_flops(cfg, S, shape.kind)
    fwd = tokens * (per_tok * n_steps + 2 * cfg.d_model * pv)
    if shape.kind == "train":
        mult = {"none": 3.0, "full": 4.0, "dots": 4.0, "dots_all": 3.1}[cfg.remat]
        executed = fwd * mult
        model = 6 * n_active * tokens
        opt_bytes = n_total * (4 + 16 if cfg.opt_moments_dtype == "float32"
                               else 4 + 8)
        act_stack = n_steps * tokens * cfg.d_model * 2
        hbm = n_total * 2 * 3 + opt_bytes + act_stack * 2
    else:                              # prefill
        executed = fwd
        model = 2 * n_active * tokens
        hbm = n_total * 2 + _cache_bytes(cfg, B, S) + tokens * cfg.d_model * 2 * n_steps
    return CellCost(executed, model, hbm, tokens)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    kv_el = 1 if cfg.kv_cache_dtype == "int8" else 2
    from repro_torch.models.transformer import _pattern
    if cfg.family == "encdec":
        n_attn = cfg.n_dec_layers
        cross = cfg.n_dec_layers * B * S * cfg.n_kv_heads * cfg.kv_repeat * \
            cfg.head_dim * 2 * 2
        return cross + n_attn * B * S * cfg.n_kv_heads * cfg.kv_repeat * \
            cfg.head_dim * 2 * kv_el
    pattern, n_steps = _pattern(cfg)
    n_attn = sum(1 for k in pattern if k != "mamba") * n_steps
    n_mamba = sum(1 for k in pattern if k == "mamba") * n_steps
    if cfg.family == "hybrid":
        n_attn += n_steps              # shared block invocations
    Hkv = cfg.n_kv_heads * cfg.kv_repeat
    attn_b = n_attn * B * S * Hkv * cfg.head_dim * 2 * kv_el
    if cfg.sliding_window and not cfg.local_global_period:
        attn_b = n_attn * B * min(S, cfg.sliding_window) * Hkv * \
            cfg.head_dim * 2 * kv_el
    ssm_b = n_mamba * B * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                           * 4 + cfg.ssm_conv * cfg.d_inner * 2)
    return attn_b + ssm_b

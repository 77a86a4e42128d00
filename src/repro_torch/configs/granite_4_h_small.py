"""granite-4.0-h-small [hybrid_moe]: 40L d_model=4096, a period of 10 layers
(5 Mamba-2, 1 attention, 4 Mamba-2) four times; Mamba-2 128 heads x 64,
d_state 128, conv 4 with bias; GQA 32 over 8 heads of 128 with no positions
(NoPE), softmax scale 1/128; every layer's FFN an MoE of 72 SiLU-GLU
experts of 768, top-10, beside a shared expert of 1536; multipliers:
embedding 12, residual 0.22, logits / 16; vocab 100352, tied.
[hf:ibm-granite/granite-4.0-h-small, config.json]

The full config holds experts 0-17 of each layer: one card's share of a
deployment that divides the 72 over four cards (the router keeps its 72
outputs and top-10).  The chunk scan runs chunks of 128, its kernel's
largest (the published ``mamba_chunk_size`` is 256; the chunk leaves the
scan's mathematics unchanged).  Capacity factor 72 / 10: a row's capacity
is its token count, so no token drops, as in the published model."""
from repro_torch.configs.base import HybridMoEConfig, register

PERIOD = ("mamba",) * 5 + ("attn",) + ("mamba",) * 4


def full() -> HybridMoEConfig:
    return HybridMoEConfig(
        name="granite-4.0-h-small", layer_pattern=PERIOD,
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab=100352, tie_embeddings=True, norm_eps=1e-5,
        ssm_state=128, ssm_heads=128, ssm_head_dim=64, ssm_expand=2,
        ssm_chunk=128, ssm_conv=4, ssm_conv_bias=True,
        n_experts=72, top_k=10, d_ff_expert=768, d_ff_shared=1536,
        capacity_factor=72 / 10, n_experts_held=18, expert_first=0,
        embed_mult=12.0, residual_mult=0.22, logits_div=16.0,
        attn_scale=0.0078125, use_rope=False,
    )


def smoke() -> HybridMoEConfig:
    """One period at small widths: 8 experts, top-3, this device holding
    the first 4 (a 2-way share)."""
    return full().replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=256,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
        n_layers=10, n_experts=8, top_k=3, d_ff_expert=32, d_ff_shared=64,
        capacity_factor=8 / 3, n_experts_held=4, attn_impl="naive",
        remat="none",
    )


register("granite-4.0-h-small", full, smoke)

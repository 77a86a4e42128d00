"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, 32 experts top-8.  Vocab padded to 49408 * for model-axis
sharding (layers.VOCAB_PAD).  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, n_experts=32, top_k=8, d_ff_expert=512,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=515, n_experts=8, top_k=4, d_ff_expert=64,
        attn_impl="naive", remat="none",
    )


register("granite-moe-1b-a400m", full, smoke)

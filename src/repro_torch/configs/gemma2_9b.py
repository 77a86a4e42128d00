"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — alternating local(4096-window)/global attention, logit
soft-caps, post-norms, tied + scaled embeddings.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=14336, vocab=256000, sliding_window=4096, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0, post_norm=True,
        tie_embeddings=True, embed_scale=True, mlp_act="gelu",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=32, attn_impl="naive",
        remat="none",
    )


register("gemma2-9b", full, smoke)

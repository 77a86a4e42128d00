"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec; the audio frontend is a STUB (input_specs() provides
precomputed frame embeddings).  [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=24, n_enc_layers=12, n_dec_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256206, frontend="audio", mlp_act="relu",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, attn_impl="naive",
        remat="none",
    )


register("seamless-m4t-medium", full, smoke)

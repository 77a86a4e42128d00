"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=50280, ssm_state=128, ssm_heads=48, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=128, tie_embeddings=True,
        kv_seq_shard=True,       # adopted: EXPERIMENTS.md §Perf D1
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=3, d_model=64, vocab=256, ssm_state=16, ssm_heads=4,
        ssm_head_dim=32, ssm_chunk=32, remat="none",
    )


register("mamba2-780m", full, smoke)

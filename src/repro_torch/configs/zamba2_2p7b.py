"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + 2 alternating shared attention blocks
applied every 2 Mamba layers.  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000, ssm_state=64, ssm_heads=80, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=64,  # chunk: EXPERIMENTS.md §Perf B1
        shared_period=2, n_shared_blocks=2,
        tie_embeddings=True,
        kv_seq_shard=True,       # adopted: EXPERIMENTS.md §Perf D1
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_heads=4, ssm_head_dim=32,
        ssm_chunk=32, attn_impl="naive", remat="none",
    )


register("zamba2-2.7b", full, smoke)

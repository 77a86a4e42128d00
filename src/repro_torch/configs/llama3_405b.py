"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783; unverified]

FSDP + TP sharding; bf16 optimizer moments to fit 16 GB/chip HBM at 256 chips.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256, rope_theta=500_000.0,
        fsdp=True, opt_moments_dtype="bfloat16",
        kv_cache_dtype="int8",   # adopted: EXPERIMENTS.md §Perf A1
        seq_shard_resid=True,    # adopted: EXPERIMENTS.md §Perf C1/A4
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512, fsdp=False, opt_moments_dtype="float32",
        kv_cache_dtype="bfloat16", seq_shard_resid=False,
        attn_impl="naive", remat="none",
    )


register("llama3-405b", full, smoke)

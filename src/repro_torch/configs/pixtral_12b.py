"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — mistral-nemo decoder backbone; the pixtral-ViT frontend is a
STUB (input_specs() provides precomputed patch embeddings as a 1024-position
prefix).  [hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, rope_theta=1_000_000.0,
        frontend="vision", frontend_seq=1024,
        seq_shard_resid=True,    # adopted: EXPERIMENTS.md §Perf C1
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, frontend_seq=8, seq_shard_resid=False,
        attn_impl="naive", remat="none",
    )


register("pixtral-12b", full, smoke)

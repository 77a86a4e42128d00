"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32) d_ff=13440
vocab=92416 — qwen1.5 arch (attention qkv bias).  [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=13440, vocab=92416, attn_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, vocab=512, attn_impl="naive", remat="none",
    )


register("codeqwen1.5-7b", full, smoke)

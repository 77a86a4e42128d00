"""Architecture config system: exact assigned configs + reduced smoke variants.

``get_config(arch_id)`` returns the full published config;
``smoke_config(arch_id)`` returns a CPU-runnable reduction of the same family.
``list_archs()`` lists the archs the JAX package defines too (its parity
tests walk those); an arch of the port's own (``PORT_ONLY``) is reached by
name.  ``ModelConfig``'s
fields are the JAX package's, field for field; the hybrid MoE family's
own settings are fields of ``HybridMoEConfig`` and plain class defaults
(today's behaviour) on every other config.
Input-shape cells (train_4k / prefill_32k / decode_32k / long_500k) are shared
by all LM archs; applicability is encoded per arch (see DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "hybrid_moe", "encdec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family = "dense"
    # transformer core
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    attn_bias: bool = False                 # qwen1.5-style qkv bias
    # attention variants
    sliding_window: int | None = None       # SWA width (h2o-danube / gemma2 local)
    local_global_period: int | None = None  # gemma2: alternate local/global layers
    attn_softcap: float | None = None       # gemma2 attention logit soft-cap
    final_softcap: float | None = None      # gemma2 final logit soft-cap
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_impl: Literal["tp", "ep"] = "tp"    # tensor- vs expert-parallel experts
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # hybrid (zamba2): shared transformer block every `shared_period` ssm layers
    shared_period: int = 0
    n_shared_blocks: int = 0                # alternating shared blocks (zamba2: 2)
    # enc-dec (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stub: 'none' | 'audio' (frame embeds) | 'vision' (patch embeds)
    frontend: str = "none"
    frontend_seq: int = 0                   # prefix positions fed as embeddings
    # runtime / distribution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: Literal["none", "full", "dots", "dots_all"] = "full"
    attn_impl: Literal["naive", "blocked", "pallas"] = "blocked"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    fsdp: bool = False                      # shard params over data axis too
    opt_moments_dtype: str = "float32"      # bf16 for llama3-405b to fit HBM
    norm_eps: float = 1e-6
    mlp_act: Literal["silu", "gelu", "relu"] = "silu"
    post_norm: bool = False                 # gemma2 post-layer norms
    embed_scale: bool = False               # gemma2 sqrt(d_model) embed scaling
    kv_repeat: int = 1                      # runtime KV-head replication so the
                                            # kv dim divides the model axis
    kv_cache_dtype: str = "bfloat16"        # 'int8' enables quantized KV cache
    decode_embed_shard: bool = False        # decode: shard activations on d over
                                            # 'data' => weight-stationary 2D FSDP
                                            # (all-reduce activations, never
                                            # all-gather weights per token)
    seq_shard_resid: bool = False           # Megatron-SP: shard the residual
                                            # stream (and the remat-saved stack)
                                            # over 'model' on the seq dim
    kv_seq_shard: bool = False              # long-context decode: shard the KV
                                            # cache seq dim over 'data' (batch=1
                                            # leaves that axis idle)

    # HybridMoEConfig's fields, as class defaults: no shared expert, every
    # expert held, no conv bias, no layer pattern of its own, multipliers 1,
    # the softmax scale 1/sqrt(D), RoPE
    d_ff_shared = 0
    n_experts_held = 0
    expert_first = 0
    ssm_conv_bias = False
    layer_pattern = ()
    embed_mult = 1.0
    residual_mult = 1.0
    logits_div = 1.0
    attn_scale = None
    use_rope = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def experts_held(self) -> int:
        return self.n_experts_held or self.n_experts

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """The hybrid MoE family (granite-4.0-h): a period of Mamba-2 and
    attention layers, each a pre-norm mixer and then a pre-norm MoE FFN
    beside a shared expert, every sublayer's output times
    ``residual_mult``."""
    family: Family = "hybrid_moe"
    layer_pattern: tuple[str, ...] = ()     # "mamba" / "attn", one period
    d_ff_shared: int = 0                    # the shared expert's width
    # this device's experts of a layer's n_experts: [expert_first,
    # expert_first + n_experts_held); 0 holds them all
    n_experts_held: int = 0
    expert_first: int = 0
    ssm_conv_bias: bool = False
    embed_mult: float = 1.0                 # the embedding's multiplier
    residual_mult: float = 1.0              # every sublayer's output's
    logits_div: float = 1.0                 # the logits' divisor
    attn_scale: float | None = None         # softmax scale; None 1/sqrt(D)
    use_rope: bool = True                   # False: no positions (NoPE)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, "tuple"] = {}
# archs of the port alone: the JAX package has no config to hold them to
PORT_ONLY = ("granite-4.0-h-small",)


def register(arch_id: str, full_fn, smoke_fn):
    _REGISTRY[arch_id] = (full_fn, smoke_fn)


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id][0]()


def smoke_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[arch_id][1]()


def list_archs() -> list[str]:
    """The archs the JAX package defines as well (not ``PORT_ONLY``)."""
    _ensure_loaded()
    return sorted(a for a in _REGISTRY if a not in PORT_ONLY)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §4)."""
    if shape.name == "long_500k":
        subquad = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.sliding_window is not None and cfg.local_global_period is None)
        )
        if not subquad:
            return False, "pure full attention: long_500k skipped per DESIGN.md"
    if cfg.family == "encdec" and shape.kind == "train" and shape.seq_len > 100_000:
        return False, "enc-dec long-context not defined"
    return True, ""


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib
    for mod in (
        "zamba2_2p7b", "h2o_danube_1p8b", "llama3_405b", "codeqwen15_7b",
        "gemma2_9b", "phi35_moe", "granite_moe_1b", "mamba2_780m",
        "seamless_m4t_medium", "pixtral_12b", "granite_4_h_small",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")

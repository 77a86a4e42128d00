"""build_model(cfg) -> DecoderLM (the dense, MoE, ssm and hybrid
families; the encoder-decoder family raises)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    """The encoder-decoder family raises ``NotImplementedError`` naming
    its ROADMAP.md item."""
    return DecoderLM(cfg)

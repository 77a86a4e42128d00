from repro_torch.configs.base import ModelConfig, ShapeSpec, SHAPES, get_config, list_archs, smoke_config

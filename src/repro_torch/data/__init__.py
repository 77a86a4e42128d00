from repro_torch.data.tokens import SyntheticLMData

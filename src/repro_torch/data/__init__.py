from repro_torch.data.synthetic import SyntheticLMDataset

__all__ = ["SyntheticLMDataset"]

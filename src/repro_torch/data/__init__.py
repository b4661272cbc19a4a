from repro_torch.data.pipeline import DataConfig, MemmapDataset, SyntheticLM

__all__ = ["DataConfig", "MemmapDataset", "SyntheticLM"]

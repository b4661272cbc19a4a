from repro_torch.data.pipeline import (DataConfig, MemmapDataset, SyntheticLM,
                                       make_frames)

__all__ = ["DataConfig", "MemmapDataset", "SyntheticLM", "make_frames"]

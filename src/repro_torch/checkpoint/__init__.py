from repro_torch.checkpoint.manager import (latest_step, restore, save,
                                            valid_steps)

__all__ = ["latest_step", "restore", "save", "valid_steps"]

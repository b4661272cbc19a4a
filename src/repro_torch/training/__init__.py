from repro_torch.training.loss import next_token_loss
from repro_torch.training.step import (init_opt_state, loss_fn,
                                       make_train_step)

__all__ = ["init_opt_state", "loss_fn", "make_train_step", "next_token_loss"]

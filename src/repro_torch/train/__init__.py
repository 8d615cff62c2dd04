from repro_torch.train.optimizer import (adamw_update, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.trainer import (TRAIN_OPTS, init_train_state,
                                       make_eval_step, make_train_step)

__all__ = ["adamw_update", "global_norm", "init_opt_state", "lr_schedule",
           "TRAIN_OPTS", "init_train_state", "make_eval_step",
           "make_train_step"]

"""Training stack of the port: state, step, loop."""

from repro_torch.train.loop import resume_or_init, train_loop
from repro_torch.train.state import make_train_state
from repro_torch.train.step import (TrainConfig, build_loss_fn,
                                    build_train_step, init_state,
                                    make_tuning_prewarm, resolve_block_plan)

__all__ = ["TrainConfig", "build_loss_fn", "build_train_step", "init_state",
           "make_train_state", "make_tuning_prewarm", "resolve_block_plan",
           "resume_or_init", "train_loop"]

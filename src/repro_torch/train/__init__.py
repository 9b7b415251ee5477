from repro_torch.train.state import TrainConfig, TrainState
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    build_train_step, init_state,
                                    state_shardings)

__all__ = ["TrainConfig", "TrainState", "build_prefill_step",
           "build_serve_step", "build_train_step", "init_state",
           "state_shardings"]

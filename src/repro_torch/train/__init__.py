from repro_torch.train.runner_rl import (AsyncRLResult, AsyncRLRunConfig,
                                         run_async_rl, run_grid)
from repro_torch.train.trainer_rl import (RLHyperparams, RLTrainState,
                                          init_train_state, make_train_phase)
from repro_torch.train.trainer_rlvr import (RLVRHyperparams, RLVRResult,
                                            RLVRTrainer, RLVRTrainState,
                                            make_split_update_step,
                                            make_update_step,
                                            make_warmup_step)

__all__ = ["AsyncRLResult", "AsyncRLRunConfig", "RLHyperparams",
           "RLTrainState", "RLVRHyperparams", "RLVRResult", "RLVRTrainer",
           "RLVRTrainState", "init_train_state", "make_split_update_step",
           "make_train_phase", "make_update_step", "make_warmup_step", "run_async_rl",
           "run_grid"]

from repro_torch.train.trainer_rlvr import (RLVRHyperparams, RLVRResult,
                                            RLVRTrainer, RLVRTrainState,
                                            make_update_step,
                                            make_warmup_step)

__all__ = ["RLVRHyperparams", "RLVRResult", "RLVRTrainer", "RLVRTrainState",
           "make_update_step", "make_warmup_step"]

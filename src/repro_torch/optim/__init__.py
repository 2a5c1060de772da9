from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)
from repro_torch.optim.clip import clip_by_global_norm, global_norm_clip_scale
from repro_torch.optim.schedule import constant_schedule, linear_anneal

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "constant_schedule", "global_norm_clip_scale",
           "linear_anneal"]

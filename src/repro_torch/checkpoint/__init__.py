"""Tree checkpoints in ``repro.checkpoint``'s file format (its port)."""
from repro_torch.checkpoint.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

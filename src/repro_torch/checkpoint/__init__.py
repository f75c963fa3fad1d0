from repro_torch.checkpoint.store import (list_checkpoints, read_latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["list_checkpoints", "read_latest_step", "restore_checkpoint",
           "save_checkpoint"]

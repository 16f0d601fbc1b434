from repro_torch.training.checkpoint import (file_sha256, load_checkpoint,
                                             save_checkpoint)

__all__ = ["file_sha256", "load_checkpoint", "save_checkpoint"]

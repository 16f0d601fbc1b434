from repro_torch.training.checkpoint import (file_sha256, load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.loop import fit
from repro_torch.training.loss import IGNORE, total_loss, xent
from repro_torch.training.optimizer import (OptimizerConfig, adamw_init,
                                            adamw_update, lr_at)
from repro_torch.training.train_step import (loss_and_grads,
                                             make_train_step, train_step)

__all__ = ["file_sha256", "load_checkpoint", "save_checkpoint", "fit",
           "IGNORE", "total_loss", "xent", "OptimizerConfig", "adamw_init",
           "adamw_update", "lr_at", "loss_and_grads", "make_train_step",
           "train_step"]

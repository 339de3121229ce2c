"""Training: the twin of ``repro.training`` (the same names)."""
from repro_torch.training.data import DataConfig, SyntheticLM, make_batch
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, global_norm, lr_at)
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step,
                                             quantize_dequantize_int8)

__all__ = [
    "DataConfig", "SyntheticLM", "make_batch", "AdamWConfig", "adamw_init",
    "adamw_update", "global_norm", "lr_at", "TrainConfig",
    "init_train_state", "make_train_step", "quantize_dequantize_int8",
]

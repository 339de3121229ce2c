from repro_torch.checkpoint.checkpoint import Checkpointer

__all__ = ["Checkpointer"]

from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import OptConfig, OptState

__all__ = ["adamw", "compression", "OptConfig", "OptState"]

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward, init_params, lm_loss,
                                      quantizable_paths)

__all__ = ["ModelConfig", "init_params", "forward", "lm_loss",
           "quantizable_paths"]

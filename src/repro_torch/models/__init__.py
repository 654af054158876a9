from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, lm_loss, prefill,
                                      quantizable_paths)

__all__ = ["ModelConfig", "init_params", "forward", "lm_loss",
           "quantizable_paths", "init_cache", "decode_step", "prefill"]

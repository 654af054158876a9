from repro_torch.data.pipeline import (DataConfig, SyntheticZipf, TokenDataset,
                                      make_pipeline)
from repro_torch.data.calib import (calibration_tensor, calibration_tokens,
                                   shard_calibration)
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["DataConfig", "SyntheticZipf", "TokenDataset", "make_pipeline",
           "calibration_tokens", "calibration_tensor", "shard_calibration",
           "ByteTokenizer"]

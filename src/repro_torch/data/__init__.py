from repro_torch.data.pipeline import DataConfig, SyntheticZipf, make_pipeline
from repro_torch.data.calib import calibration_tensor, calibration_tokens

__all__ = ["DataConfig", "SyntheticZipf", "make_pipeline",
           "calibration_tokens", "calibration_tensor"]

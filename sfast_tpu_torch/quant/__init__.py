"""Int8 quantization of the port's pipelines: W8A16, dynamic W8A8, and
static W8A8 from a calibration (counterpart of ``sfast_tpu/quant``)."""

from sfast_tpu_torch.quant.calibrate import (
    Calibration,
    calibrate_controlnet_pipeline,
    calibrate_forward,
    calibrate_pipeline,
    calibrate_svd_pipeline,
)
from sfast_tpu_torch.quant.dynamic_quant import (
    quantize_conv_params,
    quantize_linear_params,
    quantize_pipeline,
)

__all__ = [
    "Calibration",
    "calibrate_controlnet_pipeline",
    "calibrate_forward",
    "calibrate_pipeline",
    "calibrate_svd_pipeline",
    "quantize_conv_params",
    "quantize_linear_params",
    "quantize_pipeline",
]

"""Motion-correction pipeline: options, the streaming engine, the in-memory
API (counterpart of ``flowreg3d_tpu/pipeline``)."""

from flowreg3d_tpu_torch.pipeline.compensate_arr import (compensate_arr,
                                                         compensate_arr_3D)
from flowreg3d_tpu_torch.pipeline.corrector import (BatchMotionCorrector,
                                                    RegistrationConfig)
from flowreg3d_tpu_torch.pipeline.of_options import (ChannelNormalization,
                                                     ConstancyAssumption,
                                                     InterpolationMethod,
                                                     NamingConvention,
                                                     OFOptions, OutputFormat,
                                                     QualitySetting)
from flowreg3d_tpu_torch.pipeline.stats import flow_statistics

__all__ = [
    "OFOptions", "OutputFormat", "QualitySetting", "ChannelNormalization",
    "InterpolationMethod", "ConstancyAssumption", "NamingConvention",
    "BatchMotionCorrector", "RegistrationConfig", "compensate_arr",
    "compensate_arr_3D", "flow_statistics",
]

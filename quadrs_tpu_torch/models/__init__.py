from quadrs_tpu_torch.models.channelizer import Channelize, run_channelize
from quadrs_tpu_torch.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu_torch.models.waterfall import WaterfallConfig, WaterfallModel

__all__ = [
    "Channelize",
    "PipelineConfig",
    "PipelineModel",
    "WaterfallConfig",
    "WaterfallModel",
    "run_channelize",
]

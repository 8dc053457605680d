from richsem_tpu_torch.data.evaluation.detection_eval import (
    CocoEvaluator,
    DetectionEvaluator,
    LvisEvaluator,
)
from richsem_tpu_torch.data.evaluation.panoptic_eval import (
    PanopticEvaluator,
    panoptic_map_from_instances,
)

__all__ = [
    "DetectionEvaluator", "CocoEvaluator", "LvisEvaluator",
    "PanopticEvaluator", "panoptic_map_from_instances",
]

from richsem_tpu_torch.data.evaluation.detection_eval import (
    CocoEvaluator,
    DetectionEvaluator,
    LvisEvaluator,
)

__all__ = ["DetectionEvaluator", "CocoEvaluator", "LvisEvaluator"]

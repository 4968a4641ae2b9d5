from empanada_torch.evaluation.evaluator import Evaluator
from empanada_torch.evaluation.instance_metrics import (
    f1,
    f1_50,
    f1_75,
    ap,
    precision,
    precision_50,
    precision_75,
    recall,
    recall_50,
    recall_75,
)
from empanada_torch.evaluation.panoptic_metrics import panoptic_quality
from empanada_torch.evaluation.semantic_metrics import iou

from podtpu_torch.ops.boxes import (  # noqa: F401
    bbox_iou,
    box_area,
    cxcywh_to_xyxy,
    pairwise_iou,
    xywhn_to_xyxy,
    xyxy_to_cxcywh,
    xyxy_to_xywhn,
)
from podtpu_torch.ops.nms import (  # noqa: F401
    batched_class_aware_nms,
    nms_padded,
)

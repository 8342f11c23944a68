"""Detector registry (``pdanet_tpu/models/detectors/__init__.py``).

All twelve detectors of the JAX package: IASSD (PDA-SSD), PointPillar,
SECOND, SECOND-IoU, Voxel-RCNN, CenterPoint, PV-RCNN, PV-RCNN++, Part-A2,
Part-A2-free, PointRCNN and CaDDN.
"""

import torch

from .caddn import CaDDN
from .centerpoint import CenterPoint
from .centerpoint import post_processing as center_post_processing
from .iassd import IASSD, post_processing
from .part_a2 import PartA2Net
from .part_a2_free import PartA2Free
from .point_rcnn import PointRCNN
from .pointpillar import PointPillar
from .pv_rcnn import PVRCNN, PVRCNNPlusPlus
from .second import SECOND
from .second_iou import SECONDNetIoU
from .second_iou import post_processing as iou_post_processing
from .voxel_rcnn import VoxelRCNN
from .voxel_rcnn import post_processing as refined_post_processing

__all__ = {"CaDDN": CaDDN, "CenterPoint": CenterPoint, "IASSD": IASSD, "PartA2Net": PartA2Net,
           "PartA2Free": PartA2Free, "PointPillar": PointPillar, "PointRCNN": PointRCNN,
           "PVRCNN": PVRCNN, "PVRCNNPlusPlus": PVRCNNPlusPlus, "SECOND": SECOND,
           "SECONDNetIoU": SECONDNetIoU, "VoxelRCNN": VoxelRCNN}

#: voxel-pipeline detectors, which take their grid geometry from the dataset
VOXEL_DETECTORS = ("PointPillar", "SECOND", "CenterPoint", "SECONDNetIoU", "VoxelRCNN",
                   "PVRCNN", "PartA2Net", "PVRCNNPlusPlus", "PartA2Free", "CaDDN")
#: the two-stage detectors, whose post-processing is the refined RoIs' NMS
REFINED = ("VoxelRCNN", "PVRCNN", "PVRCNNPlusPlus", "PartA2Net", "PartA2Free", "PointRCNN")


def get_post_processor(name):
    """fn(forward_out, model_cfg) -> fixed-shape pred dict: CenterPoint's
    NMS of its decoded candidates under the head's own
    ``DENSE_HEAD.POST_PROCESSING`` (JAX :41-43); SECOND-IoU's
    scoring and NMS of its RoIs (``second_iou.post_processing``, JAX
    :45-48); the refined RoIs' NMS (``voxel_rcnn.post_processing``) for
    the two-stage detectors (:49-53, ``REFINED``); else the sigmoid + score sort + rotated NMS of
    ``iassd.post_processing`` (detector3d_template.py:179-285), per class
    with ``MULTI_CLASSES_NMS``."""
    if name not in __all__:
        raise KeyError(f"{name}: no such detector in the JAX package's registry")
    if name == "CenterPoint":
        return lambda out, mcfg: center_post_processing(out, mcfg.DENSE_HEAD.POST_PROCESSING)
    if name == "SECONDNetIoU":
        return iou_post_processing
    if name in REFINED:
        return refined_post_processing
    return lambda out, mcfg: post_processing(
        out["batch_cls_preds"], out["batch_box_preds"], mcfg.POST_PROCESSING)


def resolve_detector_name(model_cfg):
    """The reference overloads MODEL.NAME 'PointRCNN' for Part-A2-free
    (PartA2_free.yaml wires it over a UNetV2 voxel backbone): the class
    that name resolves to, ``PartA2Free`` over either UNet.  The JAX
    registry (:72-83) resolves only the dense ``UNetV2`` so, and builds
    the shipped yaml's ``SparseUNetV2`` as PointRCNN (ROADMAP queue 3)."""
    name = model_cfg.NAME
    if name == "PointRCNN" and (model_cfg.get("BACKBONE_3D") or {}).get("NAME") in (
            "UNetV2", "SparseUNetV2"):
        return "PartA2Free"
    return name


def build_network(model_cfg, num_class, dataset=None, input_channels=4, device=None,
                  **kwargs):
    """Build the detector named by ``model_cfg.NAME`` on ``device``: the
    current CUDA device unless the caller names one (``device="cpu"``).

    With a ``dataset`` (JAX :81-97), the input channels are its point
    encoder's and a voxel detector takes the grid size, voxel size, point
    cloud range and class names from it, where ``kwargs`` does not give
    them."""
    name = resolve_detector_name(model_cfg)
    if name not in __all__:
        raise KeyError(f"{model_cfg.NAME}: no such detector in the JAX package's registry")
    if dataset is not None:
        input_channels = dataset.point_feature_encoder.num_point_features
        if name in VOXEL_DETECTORS:
            kwargs.setdefault("grid_size", tuple(int(x) for x in dataset.grid_size))
            kwargs.setdefault("voxel_size", tuple(dataset.voxel_size))
            kwargs.setdefault("point_cloud_range",
                              tuple(float(x) for x in dataset.point_cloud_range))
            kwargs.setdefault("class_names", tuple(dataset.class_names))
    device = torch.device("cuda") if device is None else torch.device(device)
    return __all__[name](model_cfg, num_class, input_channels, **kwargs).to(device)

"""Part-A2-free (``PartA2Free``) of pdanet_tpu_torch against the JAX
package, on the CPU, at ``tests/test_parta2.py``'s tiny Part-A2-free
config (its ``test_parta2_free_forward_and_loss``: the intra-part head
with a box branch under the mean-size ``PointResidualCoder``, the RoI head
with ``DISABLE_PART``) over the sparse UNet (the shipped
``PartA2_free.yaml``'s), the inputs and weights as in
``test_torch_parta2.py``; ``test_torch_parta2_free_dense.py`` runs the same
checks over the dense UNet.

* at eval in float32 and in training mode in float64 (``check_eval``,
  ``check_float64`` of ``test_torch_parta2.py``: logits within 2e-3, RoIs
  equal, detections paired; loss within 1e-10 relative, gradients within
  1e-10 of each leaf's scale);
* the tiny exported program equal to the eager closure;
* the shipped ``PartA2_free.yaml`` (MODEL.NAME PointRCNN over
  ``SparseUNetV2``): the JAX registry resolves it to PointRCNN, the port to
  ``PartA2Free``; built at full width through the dataset's geometry and
  filled by a tree of the JAX package's ``PartA2Free`` built directly,
  every leaf consumed; its serving spec the voxel triplet.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models.detectors import PartA2Free as JPartA2Free
from pdanet_tpu.models.detectors import resolve_detector_name as j_resolve
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.sparse_unet import SparseUNetV2
from pdanet_tpu_torch.models.detectors import (get_post_processor, resolve_detector_name,
                                               voxel_rcnn)
from pdanet_tpu_torch.models.detectors.part_a2_free import PartA2Free
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_parta2 import PARTA2_MODEL_CFG
from test_torch_parta2 import (MEAN_SIZES, check_eval, check_float64, export_equals_eager,
                               jax_run, make_batch)

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PartA2_free.yaml"


def free_cfg(backbone="SparseUNetV2", dp_ratio=0.3, score_type="roi_iou"):
    """``test_parta2.test_parta2_free_forward_and_loss``'s config over
    ``backbone``; ``DP_RATIO`` and ``CLS_SCORE_TYPE`` as
    ``test_torch_parta2.parta2_cfg`` sets them."""
    roi = copy.deepcopy(PARTA2_MODEL_CFG["ROI_HEAD"])
    roi.update(DISABLE_PART=True, SEG_MASK_SCORE_THRESH=0.0, DP_RATIO=dp_ratio)
    roi["TARGET_CONFIG"]["CLS_SCORE_TYPE"] = score_type
    return {
        "NAME": "PointRCNN", "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": backbone, "RETURN_ENCODED_TENSOR": False},
        "POINT_HEAD": {
            "NAME": "PointIntraPartOffsetHead", "CLS_FC": [16], "PART_FC": [16],
            "REG_FC": [16], "CLASS_AGNOSTIC": False,
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2],
                              "BOX_CODER": "PointResidualCoder",
                              "BOX_CODER_CONFIG": {"use_mean_size": True,
                                                   "mean_size": MEAN_SIZES}},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "point_cls_weight": 1.0, "point_box_weight": 1.0, "point_part_weight": 1.0,
                "code_weights": [1.0] * 8}}},
        "ROI_HEAD": roi,
        "POST_PROCESSING": copy.deepcopy(PARTA2_MODEL_CFG["POST_PROCESSING"]),
    }


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def free_run_checks(backbone, batch):
    """``PartA2Free`` over ``backbone`` at eval in float32 and in training
    mode in float64 against the JAX package's ``PartA2Free``."""
    run = jax_run(JPartA2Free, free_cfg, backbone, batch)
    assert type(run["model"]) is PartA2Free
    assert type(run["model"].backbone_3d).__name__ == backbone
    out = check_eval(run, batch)
    assert out["point_box_preds"].shape[-1] == 8
    check_float64(run, batch)


def test_parta2_free_sparse_unet_matches_jax(batch):
    """Over the sparse UNet: eval in float32 and the float64 training step
    (``free_run_checks``)."""
    free_run_checks("SparseUNetV2", batch)


def test_parta2_free_exported_program_equals_eager(batch, tmp_path):
    """The tiny Part-A2-free program over the sparse UNet
    (``export_equals_eager``)."""
    export_equals_eager(EasyDict(free_cfg()), batch, tmp_path)


def test_build_network_parta2_free_yaml():
    """The shipped yaml: MODEL.NAME PointRCNN over ``SparseUNetV2``, which the
    JAX registry resolves to PointRCNN (ROADMAP queue 3) and the port to
    ``PartA2Free`` (either UNet does); at full width from the dataset's
    grid without the encoded tensor, the 12^3 pool with ``DISABLE_PART``; on
    CUDA unless told (this torch has none: raises); every leaf of a tree of
    the JAX package's ``PartA2Free`` built directly consumed; the serving
    spec the voxel triplet at 40000 x 5; the refined post-processing under
    both names."""
    cfg = cfg_from_yaml_file(str(YAML))
    assert cfg.MODEL.NAME == "PointRCNN" and cfg.MODEL.BACKBONE_3D.NAME == "SparseUNetV2"
    assert j_resolve(JEasyDict(cfg.MODEL)) == "PointRCNN"
    assert resolve_detector_name(cfg.MODEL) == "PartA2Free"
    dense = copy.deepcopy(cfg.MODEL)
    dense.BACKBONE_3D.NAME = "UNetV2"
    assert resolve_detector_name(dense) == j_resolve(JEasyDict(dense)) == "PartA2Free"
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model) is PartA2Free and model.grid_size == (1408, 1600, 40)
    assert type(model.backbone_3d) is SparseUNetV2 and not model.backbone_3d.encoded
    assert model.roi_head.disable_part and model.roi_head.shared_fc0.in_features == 12 ** 3 * 128
    assert model.point_head.box_out.out_features == 8
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = JPartA2Free(model_cfg=JEasyDict(cfg.MODEL), num_class=3, input_channels=4,
                         grid_size=tuple(int(g) for g in jds.grid_size),
                         voxel_size=tuple(jds.voxel_size),
                         point_cloud_range=tuple(float(x) for x in jds.point_cloud_range),
                         class_names=tuple(cfg.CLASS_NAMES))
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec == {"voxels": ((1, 40000, 5, 4), torch.float32),
                    "voxel_coords": ((1, 40000, 3), torch.int32),
                    "voxel_num_points": ((1, 40000), torch.int32)}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    assert get_post_processor("PartA2Free") is voxel_rcnn.post_processing
    assert get_post_processor(resolve_detector_name(cfg.MODEL)) is voxel_rcnn.post_processing

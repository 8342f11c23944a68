"""Part-A2 (``PartA2Net``) of pdanet_tpu_torch against the JAX package, on
the CPU, at ``tests/test_parta2.py``'s tiny config over the sparse UNet
(the shipped ``PartA2.yaml``'s), the inputs and weights as in
``test_torch_parta2.py``:

* at eval in float32: the voxel centres within 1e-6, the segmentation and
  part logits within 2e-3, the RoIs equal, ``rcnn_cls`` within 2e-3, the
  refined boxes within 1e-3, the detections paired box for box;
* in training mode in float64 (``DP_RATIO`` 0, JAX's sampler draws fed,
  ``CLS_SCORE_TYPE`` cls): the loss and its tb terms within 1e-10
  relative, every gradient leaf within 1e-10 of its largest |gradient|,
  the running statistics within 1e-9;
* the tiny exported program equal to the eager closure; the shipped
  ``PartA2.yaml`` built through the dataset's geometry (on CUDA unless
  told) and filled by a JAX tree of the same config, every leaf consumed;
  its serving spec equal to JAX's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu import serving as j_serving
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.detectors import PartA2Net as JPartA2Net
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.sparse_unet import SparseUNetV2
from pdanet_tpu_torch.models.detectors import get_post_processor, voxel_rcnn
from pdanet_tpu_torch.models.detectors.part_a2 import PartA2Net
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_parta2 import (check_eval, check_float64, export_equals_eager, jax_run,
                               make_batch, parta2_cfg)

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PartA2.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def parta2_run(batch):
    return jax_run(JPartA2Net, parta2_cfg, "SparseUNetV2", batch)


def test_parta2_eval_matches_jax(batch, parta2_run):
    """``PartA2Net`` over the sparse UNet at eval in float32
    (``check_eval``)."""
    assert type(parta2_run["model"]) is PartA2Net
    check_eval(parta2_run, batch)


def test_parta2_loss_and_gradients_match_jax_float64(batch, parta2_run):
    """Training mode in float64, JAX's sampler draws fed
    (``check_float64``): the RPN, point and RCNN losses, the gradients
    through the UNet's decoder."""
    check_float64(parta2_run, batch)


def test_parta2_exported_program_equals_eager(batch, tmp_path):
    """The tiny Part-A2 program over the sparse UNet
    (``export_equals_eager``)."""
    export_equals_eager(EasyDict(parta2_cfg()), batch, tmp_path)


def test_build_network_parta2_yaml():
    """The shipped yaml at full width, its grid from the dataset: 1408 x
    1600 x 40 cells, the sparse UNet with the encoded BEV map (256
    channels), the 12^3 RoI-aware pool into 128 channels (221184 into
    SHARED_FC); on CUDA unless told (this torch has none: raises); every
    leaf of a JAX tree of the same config consumed; the serving spec the
    voxel triplet at 40000 x 5, equal to JAX's; the refined
    post-processing registered."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model) is PartA2Net and model.grid_size == (1408, 1600, 40)
    assert type(model.backbone_3d) is SparseUNetV2 and model.backbone_3d.num_bev_features == 256
    assert model.roi_head.shared_fc0.in_features == 12 ** 3 * 128
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    assert type(jmodel) is JPartA2Net
    spec = serving.serving_input_spec(cfg, 1, model)
    assert spec == {"voxels": ((1, 40000, 5, 4), torch.float32),
                    "voxel_coords": ((1, 40000, 3), torch.int32),
                    "voxel_num_points": ((1, 40000), torch.int32)}
    jspec = j_serving.serving_input_spec(cfg, 1, jmodel)
    assert {k: tuple(s) for k, (s, _) in jspec.items()} == {k: s for k, (s, _) in spec.items()}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    torch.testing.assert_close(model.backbone_3d.inv_conv4.kernel, torch.from_numpy(
        np.asarray(variables["params"]["backbone_3d"]["inv_conv4"]["kernel"])), rtol=0, atol=0)
    assert get_post_processor("PartA2Net") is voxel_rcnn.post_processing

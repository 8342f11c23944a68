"""The PV-RCNN++ slice of pdanet_tpu_torch against the JAX package, on the
CPU, at ``tests/test_pvrcnn_pp.py``'s tiny config (``_pp_cfg``: SPC
keypoint sampling, VectorPool aggregation of the raw points, x_conv3 and
x_conv4 and in the RoI grid pool) over the dense and the sparse 3-D
backbones, the inputs and weights as in ``test_torch_pvrcnn.py``.

* ``three_nn``: indices equal to JAX's, ties (duplicated and equidistant
  support points) to the lowest index, across chunks; distances within an
  ulp, their gradient within 1e-6;
* ``dense_grid_offsets`` equal; ``local_interpolate`` within 1e-6 (taps out
  of range, centres with none in range);
* ``spc_proximity_collapse`` and ``roi_neighbor_filter`` equal (padded RoIs,
  a frame without RoIs); FPS over an SPC-collapsed cloud with fewer
  distinct points than picks equal to JAX's;
* ``VectorPoolAggregationModuleMSG`` within 1e-5, its statistics within
  1e-5 relative;
* ``PVRCNNPlusPlus`` at eval in float32 (keypoints equal, RoIs equal,
  features within 1e-3, logits within 2e-3, detections paired) and in
  training mode in float64 (loss and tb within 1e-10 relative, gradients
  within 1e-10 of each leaf's scale, statistics within 1e-9); the tiny
  exported program equal to the eager closure; the shipped
  ``pv_rcnn_plusplus.yaml`` built and filled by a JAX tree.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu import serving as j_serving
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.backbones_3d.pfe import vector_pool as j_vp
from pdanet_tpu.models.backbones_3d.pfe import voxel_set_abstraction as j_vsa
from pdanet_tpu.ops.interpolate import three_nn as j_three_nn
from pdanet_tpu.ops.sampling import farthest_point_sample as j_fps
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.pfe import vector_pool as vp
from pdanet_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
from pdanet_tpu_torch.models.detectors.pv_rcnn import PVRCNNPlusPlus
from pdanet_tpu_torch.ops import interpolate
from pdanet_tpu_torch.ops.sampling import farthest_point_sample_plain
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_pvrcnn_pp import _pp_cfg
from test_torch_pointpillar import _perturb
from test_torch_pvrcnn import (BACKBONES, B, _stats_rel, make_batch, pv_check_eval,
                               pv_check_float64, pv_export_equals_eager, pv_jax_run)

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pv_rcnn_plusplus.yaml"


def pp_cfg(backbone="SparseVoxelBackBone8x", dp_ratio=0.3, score_type="roi_iou"):
    cfg = _pp_cfg()
    cfg["BACKBONE_3D"]["NAME"] = backbone
    cfg["ROI_HEAD"]["DP_RATIO"] = dp_ratio
    cfg["ROI_HEAD"]["TARGET_CONFIG"]["CLS_SCORE_TYPE"] = score_type
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------- the pieces

def test_three_nn_equals_jax(monkeypatch):
    """Queries over a support with duplicated points and points equidistant
    from a query (ties): the indices equal JAX's ``top_k`` (the lowest
    index first among ties), over chunks of 7 queries, the distances
    within an ulp (2.5e-7 relative); the
    gradient of a weighted sum of the distances within 1e-6 in both
    inputs; ``torch.library.opcheck`` of the index search's op."""
    rs = np.random.RandomState(0)
    known = rs.uniform(-1, 1, (B, 40, 3)).astype(np.float32)
    known[:, 20:25] = known[:, 3:4]  # duplicates of point 3
    unknown = rs.uniform(-1, 1, (B, 30, 3)).astype(np.float32)
    unknown[:, 0] = known[:, 3]  # five ties at distance 0 after point 3
    unknown[:, 1] = 5.0  # four support points 0.5 from it, the rest far
    known[:, 30:34] = 5.0 + np.array([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [-0.5, 0, 0]])
    w = rs.rand(B, 30, 3).astype(np.float32)

    def j_loss(u, k):
        d2, _ = j_three_nn(u, k)
        return jnp.sum(d2 * w)

    (d2_w, idx_w) = jax.device_get(jax.jit(j_three_nn)(jnp.asarray(unknown), jnp.asarray(known)))
    gu_w, gk_w = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(unknown), jnp.asarray(known))
    monkeypatch.setattr(interpolate, "_CHUNK", 7 * 40)
    u, k = torch.from_numpy(unknown).requires_grad_(), torch.from_numpy(known).requires_grad_()
    d2, idx = interpolate.three_nn(u, k)
    np.testing.assert_array_equal(idx.numpy(), idx_w)
    # XLA contracts the sum of squares into fused multiply-adds: an ulp apart
    np.testing.assert_allclose(d2.detach().numpy(), d2_w, rtol=2.5e-7, atol=1e-7)
    assert idx.dtype == torch.int32 and idx[0, 0].tolist() == [3, 20, 21]
    assert idx[0, 1].tolist() == [30, 31, 32]
    (d2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(gu_w), atol=1e-6, rtol=0)
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(gk_w), atol=1e-6, rtol=0)
    # the index search is one op (schema, fake, export)
    assert interpolate.three_nn_op._qualname == "pdanet_tpu_torch::three_nn"
    result = torch.library.opcheck(interpolate.three_nn_op, (torch.from_numpy(unknown),
                                                             torch.from_numpy(known)))
    assert set(result.values()) == {"SUCCESS"}, result


def test_dense_grid_offsets_and_local_interpolate_equal_jax():
    """The sub-voxel offsets equal; the local interpolation of centres near
    the support (some taps out of range) and of centres with no support in
    range (zero) within 1e-6 of JAX's."""
    for r, n in ((1.2, (2, 2, 2)), (3.0, (3, 1, 1)), (0.8, (3, 3, 3))):
        np.testing.assert_array_equal(vp.dense_grid_offsets(r, n),
                                      j_vp.dense_grid_offsets(r, n))
    rs = np.random.RandomState(1)
    support = rs.uniform(-2, 2, (B, 32, 3)).astype(np.float32)
    support[:, 28:] = vsa.FAR_SENTINEL
    feats = rs.rand(B, 32, 4).astype(np.float32)
    centres = np.concatenate([rs.uniform(-1, 1, (B, 9, 3)), np.full((B, 1, 3), 50.0)],
                             axis=1).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: j_vp.local_interpolate(*a, 0.9))(
        *(jnp.asarray(a) for a in (support, feats, centres))))
    got = vp.local_interpolate(*(torch.from_numpy(a) for a in (support, feats, centres)),
                               0.9).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[:, 9] == 0).all() and np.abs(got[:, :9, :4]).max() > 0
    far = np.linalg.norm(support[:, None, :28] - centres[:, :9, None], axis=-1)
    assert (np.sort(far, axis=-1)[..., 2] > 0.9).any()  # some third tap out of range


def test_spc_roi_filter_and_fps_on_collapsed_cloud_equal_jax():
    """``spc_proximity_collapse`` and ``roi_neighbor_filter`` equal JAX's
    over random RoIs (one padded row; a frame with none: nothing moves);
    FPS of 96 over the collapsed cloud, which holds fewer distinct points,
    equal to JAX's (every pick after the distinct points run out is the
    lowest index of a zero distance)."""
    rs = np.random.RandomState(2)
    xyz = rs.uniform(-20, 20, (B, 400, 3)).astype(np.float32)
    rois = np.concatenate([rs.uniform(-10, 10, (B, 3, 3)), rs.uniform(1, 4, (B, 3, 3)),
                           rs.uniform(-1, 1, (B, 3, 1))], axis=-1).astype(np.float32)
    rois[0, 2] = 0.0
    rois[1] = 0.0
    args = (jnp.asarray(xyz), jnp.asarray(rois))
    want_c = np.asarray(jax.jit(lambda x, r: j_vsa.spc_proximity_collapse(x, r, 1.6))(*args))
    want_f = np.asarray(jax.jit(lambda x, r: j_vsa.roi_neighbor_filter(x, r, 2.4))(*args))
    t = (torch.from_numpy(xyz), torch.from_numpy(rois))
    got_c = vsa.spc_proximity_collapse(*t, 1.6).numpy()
    got_f = vsa.roi_neighbor_filter(*t, 2.4).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_c[1], xyz[1])
    distinct = len(np.unique(got_c[0], axis=0))
    assert 1 < distinct < 96 and (got_f[0] == vsa.FAR_SENTINEL).any()
    want_i = np.asarray(jax.jit(lambda x: j_fps(x, 96))(jnp.asarray(got_c)))
    got_i = farthest_point_sample_plain(torch.from_numpy(got_c), 96).numpy()
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("train", [False, True])
def test_vector_pool_msg_equals_jax(train):
    """``test_pvrcnn_pp``'s two-group VectorPool (channels reduced 4 -> 2)
    over a support with sentinel rows: outputs within 1e-5, in training the
    statistics within 1e-5 relative; the kernel kept in flax's layout."""
    cfg = {
        "NUM_GROUPS": 2, "LOCAL_AGGREGATION_TYPE": "local_interpolation",
        "NUM_REDUCED_CHANNELS": 2, "NUM_CHANNELS_OF_LOCAL_AGGREGATION": 4,
        "MSG_POST_MLPS": [16],
        "GROUP_CFG_0": {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.6,
                        "NEIGHBOR_NSAMPLE": -1, "POST_MLPS": [8, 8]},
        "GROUP_CFG_1": {"NUM_LOCAL_VOXEL": [3, 3, 3], "MAX_NEIGHBOR_DISTANCE": 1.2,
                        "NEIGHBOR_NSAMPLE": -1, "POST_MLPS": [8, 8]},
    }
    rs = np.random.RandomState(1)
    xyz = rs.uniform(-2, 2, (B, 64, 3)).astype(np.float32)
    xyz[:, 60:] = vsa.FAR_SENTINEL
    feats = rs.rand(B, 64, 4).astype(np.float32)
    new_xyz = rs.uniform(-1, 1, (B, 8, 3)).astype(np.float32)
    args = [jnp.asarray(a) for a in (xyz, feats, new_xyz)]
    jmod = j_vp.VectorPoolAggregationModuleMSG(input_channels=4, config=JEasyDict(cfg))
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), *args), 5)
    want, mut = jax.jit(lambda v: jmod.apply(v, *args, train=train, mutable=["batch_stats"]))(
        variables)
    port = vp.VectorPoolAggregationModuleMSG(4, EasyDict(cfg))
    load_jax_variables(port, variables)
    torch.testing.assert_close(port.layer_1.separate_local_aggregation, torch.from_numpy(
        np.asarray(variables["params"]["layer_1"]["separate_local_aggregation"])), rtol=0, atol=0)
    port.train(train)
    got = port(*(torch.from_numpy(a) for a in (xyz, feats, new_xyz))).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    _stats_rel(port, mut["batch_stats"], rtol=1e-5)


# ---------------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def batch():
    return make_batch(seed=9)


@pytest.fixture(scope="module", params=BACKBONES)
def pp_run(request, batch):
    """``test_torch_pvrcnn.pv_jax_run`` of the PV-RCNN++ config."""
    return pv_jax_run(pp_cfg, request.param, batch)


def test_pvrcnn_pp_eval_matches_jax(batch, pp_run):
    """Eval in float32 over the dense and the sparse backbone
    (``test_torch_pvrcnn.pv_check_eval``): SPC's keypoints equal, the RoIs
    equal, each source's VectorPool features within 1e-3, the logits within
    2e-3, the detections paired box for box."""
    assert type(pp_run["model"]) is PVRCNNPlusPlus
    pv_check_eval(pp_run, batch, "PVRCNNPlusPlus")


def test_pvrcnn_pp_loss_and_gradients_match_jax_float64(batch, pp_run):
    """Training mode in float64 over the dense and the sparse backbone, JAX's
    sampler draws fed (``test_torch_pvrcnn.pv_check_float64``)."""
    pv_check_float64(pp_run, batch)


def test_pvrcnn_pp_exported_program_equals_eager(batch, tmp_path):
    """The tiny PV-RCNN++ program reloaded gives the eager closure's
    outputs exactly."""
    pv_export_equals_eager(EasyDict(pp_cfg()), batch, tmp_path)


def test_build_network_pv_rcnn_plusplus_yaml():
    """The shipped yaml at full width: SPC sampling, VectorPool over the
    raw points (1 channel), x_conv3 and x_conv4 (64 -> 32) and in the RoI
    grid pool (90 -> 30), 256 + 32 + 128 + 128 channels before a fusion of
    90; every leaf of a JAX tree of the same config consumed; the serving
    spec equal to JAX's."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert type(model) is PVRCNNPlusPlus and model.pfe.method == "SPC"
    assert model.pfe.sources == ["bev", "raw_points", "x_conv3", "x_conv4"]
    assert model.pfe.fusion.in_features == 256 + 32 + 128 + 128
    assert model.roi_head.roi_grid_pool.layer_0.red == 30
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=3, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    jspec = j_serving.serving_input_spec(cfg, 1, jmodel)
    assert {k: tuple(s) for k, (s, _) in jspec.items()} == {k: s for k, (s, _) in spec.items()}
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    copy.deepcopy(model)  # the non-persistent offsets travel with the module

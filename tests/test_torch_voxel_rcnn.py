"""The Voxel-RCNN slice of pdanet_tpu_torch against the JAX package, on the
CPU, at ``tests/test_two_stage.py``'s tiny config (``_voxel_rcnn_tiny_cfg``
over ``tests/test_second.py``'s grid of 32 x 32 x 8 cells of 0.2 x 0.2 x
0.5 m) with the sparse 3-D backbone (``NUM_FILTERS [4, 4, 8, 8, 8]``):
inputs from a numpy seed (voxels in clusters, padded rows, a duplicated
cell), weights carried from the flax variables by the weight bridge.  The
JAX side runs jitted on the CPU; its NMS takes the XLA walk there, its
sparse engine has no Pallas kernel.

* The NMS plain path at K 4500 (beyond the 4096 the port's kernel held
  before) equal to JAX's walk.
* ``proposal_layer``: keep masks, RoIs and labels equal; ``subsample_rois``
  in the four cases of ``test_two_stage.py:39-88`` and
  ``sample_rois_for_rcnn`` equal to JAX's with JAX's draws fed (its IoUs
  within 2e-6: the two packages' float32 rotated overlaps differ);
  ``canonicalize_gt_of_rois`` and ``decode_roi_boxes`` within 1e-6;
  ``get_dense_grid_points`` within 1e-6.
* ``SparseNeighborGridPool``: the voxel-query table equal, the first-16
  slots equal, the empty-window ghost, outputs within 1e-5.
* ``VoxelRCNN`` at eval in float32: the first-stage logits within 2e-3,
  the RoIs equal, ``rcnn_cls`` within 2e-3 and the detections paired box
  for box; in training mode in float64 (``DP_RATIO`` 0, the sampler's
  draws fed, ``CLS_SCORE_TYPE`` cls): the loss and its tb terms within
  1e-10 relative, every
  gradient leaf within 1e-10 of its largest |gradient| (the RCNN loss
  reaches the RoI head alone), the running statistics within 1e-9.
* Dropout's kept share and scale from a frame's own generator; the recall
  record with ``roi_<t>`` against JAX's; the tiny exported program equal
  to the eager closure; the shipped ``voxel_rcnn_car.yaml`` built through
  the dataset's geometry and filled by a JAX tree of the same config.

Float64 on the JAX side drops the sparse conv's float32
``preferred_element_type`` (``test_torch_second._exact_f64``, ROADMAP
queue 3).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.detectors import voxel_rcnn as j_vrcnn
from pdanet_tpu.models.detectors.iassd import generate_recall_record as j_recall
from pdanet_tpu.models.roi_heads import roi_head_template as JRHT
from pdanet_tpu.models.roi_heads import voxelrcnn_head as j_head
from pdanet_tpu.ops import sparse_conv as j_sc
from pdanet_tpu.ops.nms import greedy_nms_mask_batched as j_nms
from pdanet_tpu.utils.box_coder_utils import ResidualCoder as JResidualCoder
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.models.detectors.second import SECOND
from pdanet_tpu_torch.models.detectors.iassd import generate_recall_record
from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
from pdanet_tpu_torch.models.roi_heads import voxelrcnn_head as head
from pdanet_tpu_torch.ops.nms import greedy_nms_mask_batched_plain
from pdanet_tpu_torch.ops.rotated_iou import boxes_iou3d
from pdanet_tpu_torch.train import make_train_step
from pdanet_tpu_torch.train.train_utils import frame_generator
from pdanet_tpu_torch.utils.box_coder_utils import ResidualCoder
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_second import GRID
from test_torch_pointpillar import _match, _perturb, _stats_close
from test_torch_second import _exact_f64, clustered_coords
from test_two_stage import SAMPLER_CFG, _boxes, _voxel_rcnn_tiny_cfg

REPO = Path(__file__).resolve().parent.parent
YAML = REPO / "tools" / "cfgs" / "kitti_models" / "voxel_rcnn_car.yaml"
VOXEL = (0.2, 0.2, 0.5)
PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
CLASSES = ("Car", "Pedestrian")
GEOMETRY = dict(grid_size=GRID, voxel_size=VOXEL, point_cloud_range=PCR, class_names=CLASSES)
B, V, P = 2, 160, 5
FEED_KEY = 7  # the key JAX's sampler draws from in the training runs here


def vrcnn_cfg(dp_ratio=0.3, score_type="roi_iou"):
    """``test_two_stage._voxel_rcnn_tiny_cfg`` over the sparse backbone.

    The float64 step takes ``CLS_SCORE_TYPE`` cls: the roi_iou labels are
    the RoIs' IoUs, whose float32 BEV overlap the two packages compute
    each its own way (~1e-7 apart, ``test_sample_rois_for_rcnn_equals_jax``
    holds them), which the loss would carry."""
    cfg = copy.deepcopy(dict(_voxel_rcnn_tiny_cfg()))
    cfg["BACKBONE_3D"] = {"NAME": "SparseVoxelBackBone8x", "NUM_FILTERS": [4, 4, 8, 8, 8],
                          "NUM_OUTPUT_FEATURES": 16}
    cfg["ROI_HEAD"] = copy.deepcopy(dict(cfg["ROI_HEAD"]))
    cfg["ROI_HEAD"]["DP_RATIO"] = dp_ratio
    cfg["ROI_HEAD"]["TARGET_CONFIG"] = {**cfg["ROI_HEAD"]["TARGET_CONFIG"],
                                        "CLS_SCORE_TYPE": score_type}
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed=3, n_valid=(140, 118)):
    """The voxel triplet of B frames: clustered coords on the tiny grid,
    voxels of 1-5 points (the rest zero) in the range, zero where padded."""
    rs = np.random.RandomState(seed)
    coords = np.stack([clustered_coords(rs, n, grid=GRID, V_=V, dups=2, clusters=4)
                       for n in n_valid])
    nums = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    lo, hi = np.asarray(PCR[:3]), np.asarray(PCR[3:])
    voxels = np.concatenate([rs.uniform(lo, hi, (B, V, P, 3)), rs.rand(B, V, P, 1)],
                            axis=-1).astype(np.float32)
    voxels[np.arange(P)[None, None] >= nums[..., None]] = 0
    pad = coords[..., 0] < 0
    voxels[pad], nums[pad] = 0, 0
    return {"voxels": voxels, "voxel_coords": coords, "voxel_num_points": nums}


def _tb(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k == "voxels" else torch.from_numpy(v)
            for k, v in batch.items()}


def _args(batch, dtype=jnp.float32):
    return [jnp.asarray(batch["voxels"], dtype), jnp.asarray(batch["voxel_coords"]),
            jnp.asarray(batch["voxel_num_points"])]


def jax_sampler_draws(key, max_overlaps, R, dtype=np.float32):
    """JAX's draws of ``subsample_rois(key, ...)`` (:72-121) as the port
    takes them: its fg permutation and with-replacement uniforms as they
    are, its hard and easy ``randint`` values k as the uniforms (k + 0.5) /
    n, which ``floor(u * n)`` maps back to k."""
    mo = np.asarray(max_overlaps)
    lo, reg_fg = SAMPLER_CFG.CLS_BG_THRESH_LO, SAMPLER_CFG.REG_FG_THRESH  # the tiny cfg's too
    n_easy = int((mo < lo).sum())
    n_hard = int(((mo < reg_fg) & (mo >= lo)).sum())
    k_fgperm, k_fgrep, k_hard, k_easy = jax.random.split(key, 4)

    def as_uniform(k, n):
        n = max(n, 1)
        ints = np.asarray(jax.random.randint(k, (R,), 0, n))
        return ((ints + 0.5) / n).astype(dtype)

    return {"fg_perm": np.asarray(jax.random.uniform(k_fgperm, (len(mo),))).astype(dtype),
            "fg_rep": np.asarray(jax.random.uniform(k_fgrep, (R,))).astype(dtype),
            "hard": as_uniform(k_hard, n_hard), "easy": as_uniform(k_easy, n_easy)}


def _stack_draws(frames):
    return {k: torch.from_numpy(np.stack([f[k] for f in frames])) for k in frames[0]}


# ---------------------------------------------------------------- NMS at K > 4096

def test_nms_plain_beyond_4096_equals_jax():
    """K 4500 on a synthetic sparse IoU (each entry uniform in (0, 1) with
    probability 4 / K), two frames, random validity: the keep mask equal
    to the JAX package's walk."""
    K = 4500
    rs = np.random.RandomState(11)
    iou = np.where(rs.rand(B, K, K) < 4.0 / K, rs.rand(B, K, K), 0.0).astype(np.float32)
    valid = rs.rand(B, K) < 0.9
    want = np.asarray(j_nms(jnp.asarray(iou), jnp.asarray(valid), 0.3))
    got = greedy_nms_mask_batched_plain(torch.from_numpy(iou), torch.from_numpy(valid), 0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.3 * K < want.sum(axis=1).min() and want.sum(axis=1).max() < 0.9 * K


# ---------------------------------------------------------------- the RoI machinery

def _proposal_inputs(seed=5, N=96, C=2):
    """Clustered, overlapping boxes (some duplicated) and raw logits with
    ties across classes."""
    rs = np.random.RandomState(seed)
    boxes = np.stack([_boxes(N, seed + b, spread=4.0) for b in range(B)])
    boxes[:, 10:20] = boxes[:, 0:10] + rs.uniform(-0.2, 0.2, (B, 10, 7)).astype(np.float32)
    boxes[:, 30] = boxes[:, 31]
    logits = rs.randn(B, N, C).astype(np.float32)
    logits[:, 5, 1] = logits[:, 5, 0]
    return boxes, logits


def test_proposal_layer_equals_jax():
    """The proposal layer (NMS_PRE 64, POST 16, thresh 0.7) on raw
    two-class logits: RoIs, scores, labels and validity equal."""
    boxes, logits = _proposal_inputs()
    nms_cfg = JEasyDict(_voxel_rcnn_tiny_cfg().ROI_HEAD.NMS_CONFIG.TEST)
    want = jax.device_get(jax.jit(lambda c, b: JRHT.proposal_layer(c, b, nms_cfg))(
        jnp.asarray(logits), jnp.asarray(boxes)))
    got = RHT.proposal_layer(torch.from_numpy(logits), torch.from_numpy(boxes),
                             EasyDict(nms_cfg))
    for key in ("rois", "roi_scores", "roi_labels", "roi_valid"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert 0 < want["roi_valid"].sum(axis=1).min() and set(np.unique(want["roi_labels"])) >= {1, 2}


SUBSAMPLE_CASES = {
    # test_two_stage.py:39-88: 5 fg, 10 hard, 20 easy; fg over the cap; no
    # bg; no fg
    "fg_bg_split": np.concatenate([np.full(5, 0.9), np.full(10, 0.3), np.full(20, 0.01)]),
    "fg_cap": np.concatenate([np.full(39, 0.9), [0.0]]),
    "no_bg": np.full(8, 0.9),
    "no_fg": np.full(8, 0.2),
}


@pytest.mark.parametrize("case", sorted(SUBSAMPLE_CASES))
def test_subsample_rois_equals_jax(case):
    """The sampled indices equal JAX's, two frames (the second the first
    shuffled), JAX's draws fed."""
    o = SUBSAMPLE_CASES[case].astype(np.float32)
    overlaps = np.stack([o, np.random.RandomState(1).permutation(o)])
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.stack([np.asarray(JRHT.subsample_rois(keys[b], jnp.asarray(overlaps[b]),
                                                    SAMPLER_CFG)) for b in range(B)])
    draws = _stack_draws([jax_sampler_draws(keys[b], overlaps[b], SAMPLER_CFG.ROI_PER_IMAGE)
                          for b in range(B)])
    got = RHT.subsample_rois(torch.from_numpy(overlaps), EasyDict(SAMPLER_CFG), draws)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("score_type", ["roi_iou", "cls"])
def test_sample_rois_for_rcnn_equals_jax(score_type):
    """Matching by class and sampling on proposals near the gt (jittered gt
    among random boxes, some RoIs invalid, a padded gt row): every index
    output equal to JAX's with JAX's draws fed, the IoUs and labels within
    1e-6."""
    rs = np.random.RandomState(8)
    N, M = 48, 4
    gt = np.zeros((B, M, 8), np.float32)
    gt[:, :3, :7] = np.stack([_boxes(3, 20 + b, spread=3.0) for b in range(B)])
    gt[:, :3, 7] = [1, 2, 1]
    gt[1, 2] = 0  # a padded row
    rois = np.stack([_boxes(N, 30 + b, spread=3.0) for b in range(B)])
    near = np.repeat(gt[:, :3, :7], 8, axis=1)
    rois[:, :24] = near + rs.uniform(-0.3, 0.3, near.shape).astype(np.float32)
    labels = rs.randint(1, 3, (B, N)).astype(np.int32)
    labels[:, :24] = np.repeat(gt[:, :3, 7], 8, axis=1).astype(np.int32)
    valid = np.ones((B, N), bool)
    valid[:, -6:] = False
    scores = rs.randn(B, N).astype(np.float32)
    cfg = JEasyDict({**SAMPLER_CFG, "CLS_SCORE_TYPE": score_type})
    proposals = {"rois": rois, "roi_scores": scores, "roi_labels": labels, "roi_valid": valid}
    key = jax.random.PRNGKey(4)
    want = jax.device_get(jax.jit(lambda p, g: JRHT.sample_rois_for_rcnn(key, p, g, cfg))(
        {k: jnp.asarray(v) for k, v in proposals.items()}, jnp.asarray(gt)))
    tp = {k: torch.from_numpy(v) for k, v in proposals.items()}
    iou = boxes_iou3d(tp["rois"], torch.from_numpy(gt[..., :7]))
    ok = torch.from_numpy((gt[..., :7] != 0).any(-1))[:, None, :] & (
        tp["roi_labels"][..., None] == torch.from_numpy(gt[..., 7]).int()[:, None, :])
    mo = torch.where(tp["roi_valid"], torch.where(ok, iou, -1.0).max(-1).values.clamp(min=0), 0)
    keys = jax.random.split(key, B)
    draws = _stack_draws([jax_sampler_draws(keys[b], mo[b].numpy(), cfg.ROI_PER_IMAGE)
                          for b in range(B)])
    got = RHT.sample_rois_for_rcnn(tp, torch.from_numpy(gt), EasyDict(cfg), draws)
    for k in ("rois", "gt_of_rois", "roi_scores", "roi_labels", "reg_valid_mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # two float32 implementations of the rotated overlap: IoUs within 2e-6,
    # the soft labels (IoU - 0.25) / 0.5 within twice that
    for k, atol in (("gt_iou_of_rois", 2e-6), ("rcnn_cls_labels", 4e-6)):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol, rtol=0, err_msg=k)
    fg = want["reg_valid_mask"].sum(axis=1)
    assert fg.min() > 0 and (fg < cfg.ROI_PER_IMAGE).all()


def test_canonical_targets_decode_and_grid_points_equal_jax():
    """``canonicalize_gt_of_rois`` and ``decode_roi_boxes`` within 1e-6,
    headings across the flips included; ``get_dense_grid_points`` within
    1e-6."""
    rs = np.random.RandomState(9)
    R = 24
    rois = np.stack([_boxes(R, 40 + b) for b in range(B)])
    rois[:, :4, 6] = [np.pi / 2, -np.pi / 2, np.pi, 3.0]
    gt = np.concatenate([np.stack([_boxes(R, 50 + b) for b in range(B)]),
                         np.ones((B, R, 1), np.float32)], axis=-1)
    reg = (rs.randn(B, R, 7) * 0.3).astype(np.float32)
    want_c = np.asarray(jax.jit(JRHT.canonicalize_gt_of_rois)(jnp.asarray(rois),
                                                              jnp.asarray(gt)))
    got_c = RHT.canonicalize_gt_of_rois(torch.from_numpy(rois), torch.from_numpy(gt))
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-6, rtol=0)
    want_d = np.asarray(jax.jit(lambda r, x: JRHT.decode_roi_boxes(r, x, JResidualCoder()))(
        jnp.asarray(rois), jnp.asarray(reg)))
    got_d = RHT.decode_roi_boxes(torch.from_numpy(rois), torch.from_numpy(reg),
                                 ResidualCoder())
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-6, rtol=0)
    want_g = np.asarray(jax.jit(lambda r: j_head.get_dense_grid_points(r, 6))(
        jnp.asarray(rois)))
    got_g = head.get_dense_grid_points(torch.from_numpy(rois), 6)
    assert got_g.shape == (B, R, 216, 3)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- the voxel query

POOL_RADIUS = 2.4


def _pool_inputs(batch):
    """The tiny backbone's x_conv3 geometry (stride 4): its active sites
    from JAX's ladder, features, and grid points: around active voxels,
    between them, and far outside the range (an empty window)."""
    grids, conv4_pad = j_sc.stage_grids(GRID)
    sites = jnp.asarray(batch["voxel_coords"])
    for lvl in (1, 2):
        gx, gy, gz = grids[lvl]
        sites = j_sc.downsample_coords(sites, V, out_grid=(gz, gy, gx), dilate=True,
                                       padding=(1, 1, 1))
    coords = np.asarray(sites)
    valid = (coords >= 0).all(-1)
    rs = np.random.RandomState(12)
    feats = np.where(valid[..., None], rs.randn(B, V, 8), 0).astype(np.float32)
    vs = np.asarray(VOXEL) * 4
    centres = (coords[..., ::-1] + 0.5) * vs + np.asarray(PCR[:3])
    pick = np.stack([np.flatnonzero(valid[b])[:40] for b in range(B)])
    q = np.take_along_axis(centres, pick[..., None], 1) + rs.uniform(-0.9, 0.9, (B, 40, 3))
    q = np.concatenate([q, rs.uniform(PCR[:3], PCR[3:], (B, 20, 3)),
                        np.full((B, 4, 3), [40.0, 30.0, 9.0])], axis=1).astype(np.float32)
    return coords, feats, valid, q


@pytest.mark.parametrize("train", [True, False])
def test_sparse_neighbor_grid_pool_equals_jax(train, batch):
    """QUERY_RANGES 4 (a 9 x 9 x 9 window), NSAMPLE 16, radius 2.4 m: the
    table equal to JAX's ``build_neighbor_table`` on the grid points'
    cells, the first-16 hits in scan order equal to JAX's ``top_k``
    selection, the empty windows' output the ghost relu(bn_pos(mlp_pos(0)))
    through the out-MLP, and the output within 1e-5 (training mode: batch
    statistics over every row and slot, masked ones included)."""
    coords, feats, valid, q = _pool_inputs(batch)
    mlp, qr, ns = (8, 6, 5), (4, 4, 4), 16
    jmod = j_head.SparseNeighborGridPool(mlp=mlp, radius=POOL_RADIUS, query_range=qr,
                                         nsample=ns)
    entry = (jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid))
    call = lambda v, **kw: jmod.apply(v, entry, 4, jnp.asarray(q), VOXEL, PCR, GRID,  # noqa
                                      train=train, **kw)
    variables = _perturb(jax.jit(lambda: jmod.init(jax.random.PRNGKey(2), entry, 4,
                                                   jnp.asarray(q), VOXEL, PCR, GRID))(), 5)
    want, mut = jax.jit(lambda v: call(v, mutable=["batch_stats"]))(variables)

    port = head.SparseNeighborGridPool(mlp, POOL_RADIUS, qr, ns)
    load_jax_variables(port, variables)
    port.train(train)
    tc = torch.from_numpy(coords)
    table, pos_idx, valid_k, empty, rel = port.query(tc, 4, torch.from_numpy(q), VOXEL, PCR,
                                                     GRID)
    # JAX's table and first-16 selection (voxelrcnn_head.py:177-205)
    cell_zyx = jnp.floor((jnp.asarray(q) - jnp.asarray(PCR[:3], jnp.float32))
                         / (jnp.asarray(VOXEL, jnp.float32) * 4.0)).astype(jnp.int32)[..., ::-1]
    lvl = tuple(j_sc.stage_grids(GRID)[0][2])
    jtab = np.asarray(j_sc.build_neighbor_table(jnp.asarray(coords), lvl, query_coords=cell_zyx,
                                                kernel=(9, 9, 9)))
    np.testing.assert_array_equal(table.numpy(), jtab)
    offs = np.asarray(j_sc._kernel_offsets((9, 9, 9)))
    nb = (np.asarray(cell_zyx)[:, :, None, :] + offs)[..., ::-1]
    centers = ((nb + 0.5) * (np.asarray(VOXEL, np.float32) * 4).astype(np.float64)
               + np.asarray(PCR[:3], np.float32)).astype(np.float32)  # XLA's fused form
    hit = (jtab >= 0) & (((centers - q[:, :, None]) ** 2).sum(-1) <= POOL_RADIUS ** 2)
    key = np.where(hit, np.arange(729), 729)
    jsel = np.asarray(jax.lax.top_k(-jnp.asarray(key), ns)[1])
    want_valid = np.take_along_axis(key, jsel, 2) < 729
    np.testing.assert_array_equal(valid_k.numpy(), want_valid)
    np.testing.assert_array_equal(np.where(want_valid, pos_idx.numpy(), -1),
                                  np.where(want_valid, jsel, -1))
    np.testing.assert_array_equal(empty.numpy(), ~hit.any(-1))
    assert empty.numpy()[:, -4:].all() and (~empty.numpy()).sum(axis=1).min() > 30
    assert want_valid.sum(-1).max() == ns  # some window has more hits than slots

    got = port(tuple(torch.from_numpy(a) for a in (coords, feats, valid)), 4,
               torch.from_numpy(q), VOXEL, PCR, GRID)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    _stats_close(port, mut["batch_stats"], atol=1e-6)
    if not train:
        with torch.no_grad():
            ghost = torch.relu(port.bn_pos(port.mlp_pos(torch.zeros(1, 3))))
            ghost = torch.relu(port.bn_out(port.mlp_out(ghost)))
        np.testing.assert_allclose(got[:, -4:].detach().numpy(),
                                   np.broadcast_to(ghost.numpy(), (B, 4, mlp[2])), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def batch():
    return make_batch()


def jax_vrcnn(cfg):
    return j_build(JEasyDict(cfg), num_class=len(CLASSES), input_channels=4, **GEOMETRY)


def _gt_near(rois, labels, valid, seed=6):
    """Two gt boxes a frame a little off two valid RoIs (their labels), and
    a padded row: the sampler then finds foreground RoIs."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, 3, 8), np.float64)
    for b in range(B):
        idx = np.flatnonzero(valid[b])[[0, 3]]
        gt[b, :2, :7] = rois[b, idx] + rs.uniform(-0.05, 0.05, (2, 7))
        gt[b, :2, 3:6] = np.abs(gt[b, :2, 3:6]) + 0.2
        gt[b, :2, 7] = labels[b, idx]
    return gt


def gt_near_train_rois(model, batch):
    """``_gt_near`` the proposals of ``model``'s first stage in training
    mode in float64 (batch statistics move them from the eval's), run on a
    copy."""
    probe = copy.deepcopy(model).double().train()
    with torch.no_grad():
        first = SECOND.forward(probe, *_tb(batch, torch.float64).values())
        props = RHT.proposal_layer(first["batch_cls_preds"], first["batch_box_preds"],
                                   probe.roi_cfg.NMS_CONFIG.TRAIN)
    return _gt_near(*(props[k].numpy() for k in ("rois", "roi_labels", "roi_valid")))


@pytest.fixture(scope="module")
def vrcnn_run(batch):
    """The tiny JAX Voxel-RCNN on the batch: at eval in float32 (forward and
    the refined post-processing) with perturbed weights, and in training
    mode in float64 with DP_RATIO 0 (loss, gradient, the statistics the
    forward leaves and the proposals, its sampler drawing from
    ``FEED_KEY``); the gt near the eval's RoIs.  One compile each."""
    cfg = EasyDict(vrcnn_cfg())
    jmodel = jax_vrcnn(vrcnn_cfg())
    args = _args(batch)
    variables = _perturb(jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a))(*args), 3)

    def predict(v, *a):
        out = jmodel.apply(v, *a, train=False)
        out.pop("multi_scale_3d_features")
        return out, j_vrcnn.post_processing(out, JEasyDict(cfg))

    out, post = jax.device_get(jax.jit(predict)(variables, *args))

    cfg0, jmodel0 = EasyDict(vrcnn_cfg(0.0, "cls")), jax_vrcnn(vrcnn_cfg(0.0, "cls"))
    probe = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY)
    load_jax_variables(probe, variables)
    gt = gt_near_train_rois(probe, batch)
    orig = JRHT.assign_targets

    def assign(rng, proposals, gt_boxes, sampler_cfg):
        t = orig(jax.random.PRNGKey(FEED_KEY), proposals, gt_boxes, sampler_cfg)
        t["_proposals"] = proposals
        return t

    with pytest.MonkeyPatch.context() as mp, _exact_f64():
        mp.setattr(JRHT, "assign_targets", assign)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        a64 = _args(batch, jnp.float64)

        def loss_fn(params, gt_):
            o, mut = jmodel0.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                   *a64, gt_boxes=gt_, train=True, mutable=["batch_stats"],
                                   rngs={"proposal": jax.random.PRNGKey(0)})
            loss, tb = jmodel0.apply(v64, o, gt_, list(CLASSES), method=jmodel0.loss)
            return loss, (tb, mut["batch_stats"], o["roi_targets"]["_proposals"])

        (loss, (tb, stats, props)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"], jnp.asarray(gt))
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(stats),
                   proposals=jax.device_get(props))
    model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY).eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, cfg0=cfg0, variables=variables, out=out, post=post, gt=gt, f64=f64,
                model=model, gt_eval=_gt_near(out["rois"], out["roi_labels"], out["roi_valid"]))


def test_voxel_rcnn_eval_matches_jax(batch, vrcnn_run):
    """Eval in float32: the first-stage logits within 2e-3, the RoIs and
    their labels and validity equal, ``rcnn_cls`` within 2e-3, the refined
    boxes within 1e-3, the detections paired box for box."""
    model, want = vrcnn_run["model"], vrcnn_run["out"]
    with torch.no_grad():
        out = model.forward_batch(_tb(batch))
        post = get_post_processor("VoxelRCNN")(out, vrcnn_run["cfg"])
    assert out["rcnn_cls"].shape == (B, 16, 1) and out["batch_box_preds"].shape == (B, 16, 7)
    err = np.abs(out["cls_preds"].numpy() - want["cls_preds"]).max()
    assert err <= 2e-3, err
    for key in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)
    err = np.abs(out["rcnn_cls"].numpy() - want["rcnn_cls"]).max()
    print(f"rcnn_cls within {err:.3g}")
    assert err <= 2e-3
    np.testing.assert_allclose(out["batch_box_preds"].numpy(), want["batch_box_preds"],
                               atol=1e-3, rtol=0)
    post = {k: v.numpy() for k, v in post.items()}
    assert post["pred_counts"].min() > 0
    box_err, score_err = _match(post, vrcnn_run["post"])
    assert box_err <= 1e-3 and score_err <= 1e-4


def _f64_step(vrcnn_run, batch, model=None, backward=True):
    """The port's training forward, loss and backward in float64 from the
    JAX weights, the sampler fed JAX's draws (from its proposals)."""
    f64, cfg0, gt = vrcnn_run["f64"], vrcnn_run["cfg0"], vrcnn_run["gt"]
    if model is None:
        model = build_network(cfg0, len(CLASSES), device="cpu", **GEOMETRY).double()
        load_jax_variables(model, f64["variables"])
    model.train()
    props = {k: torch.from_numpy(np.array(v)) for k, v in f64["proposals"].items()}
    gtt = torch.from_numpy(gt)
    ok = (gtt[..., :7] != 0).any(-1)[:, None, :] & (
        props["roi_labels"][..., None] == gtt[..., 7].int()[:, None, :])
    iou = torch.where(ok, boxes_iou3d(props["rois"], gtt[..., :7]), -1.0)
    mo = torch.where(props["roi_valid"], iou.max(-1).values.clamp(min=0), 0.0)
    keys = jax.random.split(jax.random.PRNGKey(FEED_KEY), B)
    with _exact_f64():
        frames = [jax_sampler_draws(keys[b], mo[b].numpy(), 16, np.float64) for b in range(B)]
    tb_batch = _tb(batch, torch.float64)
    tb_batch["gt_boxes"] = gtt
    out = model.forward_batch(tb_batch, draws={"sampler": _stack_draws(frames), "dropout": {}})
    loss, tb = model.loss_batch(out, tb_batch)
    if backward:
        loss.backward()
    return model, out, loss, tb


def test_voxel_rcnn_loss_and_gradients_match_jax_float64(batch, vrcnn_run):
    """Training mode in float64 with JAX's draws fed: the proposals equal,
    the loss and its tb terms within 1e-10 relative, every gradient leaf
    within 1e-10 of its largest |gradient|, the running statistics within
    1e-9.  The gradient stops where JAX stops it: the RCNN loss alone
    moves the RoI head, the RPN loss alone the backbones."""
    f64 = vrcnn_run["f64"]
    model, out, loss, tb = _f64_step(vrcnn_run, batch)
    assert abs(loss.item() - f64["loss"]) <= 1e-10 * abs(f64["loss"])
    assert tb["rcnn_loss_corner"] > 0 and tb["rpn_loss_loc"] > 0  # foreground RoIs and anchors
    for k, w in f64["tb"].items():
        assert abs(float(tb[k].detach()) - w) <= 1e-10 * max(abs(w), 1e-3), k
    ref = build_network(vrcnn_run["cfg0"], len(CLASSES), device="cpu", **GEOMETRY).double()
    load_jax_variables(ref, {"params": f64["grads"],
                             "batch_stats": f64["variables"]["batch_stats"]})
    want = dict(ref.named_parameters())
    worst = []
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        assert scale > 0, f"{name}: no gradient in JAX"
        worst.append(((p.grad - want[name]).abs().max().item() / scale, name))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1e-10, f"gradients, worst first: {worst[:4]}"
    _stats_close(model, f64["stats"], atol=1e-9)

    # the detach points: the RCNN loss reaches the RoI head and nothing else
    model.zero_grad()
    _, out, _, _ = _f64_step(vrcnn_run, batch, model, backward=False)
    rcnn, _ = RHT.roi_box_cls_loss(out["rcnn_cls"], out["roi_targets"]["rcnn_cls_labels"],
                                   vrcnn_run["cfg0"].ROI_HEAD.LOSS_CONFIG)
    rcnn.backward()
    moved = {n.split(".")[0] for n, p in model.named_parameters()
             if p.grad is not None and p.grad.abs().max() > 0}
    assert moved == {"roi_head"}


def test_dropout_draws_share_scale_and_generators(vrcnn_run):
    """``train_draws`` from a frame's own generator: the sampler's uniforms
    and dropout keep masks of the shapes the head takes, kept at 1 - 0.3
    of entries; the same generator seeds give the same draws, another
    frame other draws.  A kept activation is scaled by 1 / 0.7, a dropped
    one is 0."""
    model = build_network(EasyDict(vrcnn_cfg()), len(CLASSES), device="cpu", **GEOMETRY)
    gens = lambda: [frame_generator(9, 3, i) for i in range(B)]  # noqa: E731
    d1, d2 = model.train_draws(gens(), "cpu"), model.train_draws(gens(), "cpu")
    assert set(d1["dropout"]) == {"shared0"}  # CLS_FC and REG_FC have one layer each
    for part in ("sampler", "dropout"):
        for k in d1[part]:
            assert torch.equal(d1[part][k], d2[part][k]), k
            assert not torch.equal(d1[part][k][0], d1[part][k][1]), k
    assert d1["sampler"]["fg_perm"].shape == (B, 32)  # the TRAIN NMS_POST_MAXSIZE
    assert d1["sampler"]["hard"].shape == (B, 16)
    keep = d1["dropout"]["shared0"]
    assert keep.shape == (B, 16, 32) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.7) < 0.05
    net = model.roi_head.train()
    x = torch.randn(B, 16, net.shared_fc0.in_features)
    got = net._stack(x, "shared", d1["dropout"])
    h = torch.relu(net.shared_bn0(net.shared_fc0(x)))
    want = torch.relu(net.shared_bn1(net.shared_fc1(torch.where(keep, h / 0.7, 0.0))))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="dropout keep masks"):
        net.refine(x)


def test_train_step_draws_from_frame_generators(batch, vrcnn_run):
    """``make_train_step`` gives each frame its generator from (seed, step,
    frame): two models from the same weights and seed take the same step;
    draws passed in replace them."""
    cfg = vrcnn_run["cfg"]
    from pdanet_tpu_torch.train import build_optimizer_and_schedule

    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    tb_batch = _tb(batch)
    tb_batch["gt_boxes"] = torch.from_numpy(vrcnn_run["gt"]).float()
    losses = []
    for draws in (None, None, "fed"):
        model = build_network(cfg, len(CLASSES), device="cpu", **GEOMETRY)
        load_jax_variables(model, vrcnn_run["variables"])
        opt, sch = build_optimizer_and_schedule(model, optim_cfg, 4, 2)
        if draws == "fed":
            draws = model.train_draws([frame_generator(1, 0, i) for i in range(B)], "cpu")
        losses.append(make_train_step(model, opt, sch)(tb_batch, draws)[0].item())
    assert losses[0] == losses[1] != losses[2]


def test_roi_recall_record_matches_jax(vrcnn_run):
    """The recall record with first-stage RoIs (``roi_<t>``) equal to JAX's
    ``generate_recall_record`` on the eval's RoIs and detections; without
    RoIs the ``roi_<t>`` counts are 0."""
    out, post = vrcnn_run["out"], vrcnn_run["post"]
    gt = vrcnn_run["gt_eval"].astype(np.float32)
    thresh = [0.1, 0.3, 0.5]
    pv = np.arange(post["pred_boxes"].shape[1])[None] < post["pred_counts"][:, None]
    want = jax.device_get(jax.jit(jax.vmap(lambda pb, v, g, rb, rv: j_recall(
        pb, v, g, thresh, rb, rv)))(post["pred_boxes"], pv, gt, out["rois"], out["roi_valid"]))
    got = generate_recall_record(torch.from_numpy(post["pred_boxes"]), torch.from_numpy(pv),
                                 torch.from_numpy(gt), thresh, torch.from_numpy(out["rois"]),
                                 torch.from_numpy(out["roi_valid"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want["roi_0.5"].sum() > 0
    single = generate_recall_record(torch.from_numpy(post["pred_boxes"]), torch.from_numpy(pv),
                                    torch.from_numpy(gt), thresh)
    assert all(int(single[f"roi_{t}"].sum()) == 0 for t in thresh)


def test_voxel_rcnn_exported_program_equals_eager(batch, vrcnn_run, tmp_path):
    """The tiny Voxel-RCNN program traced by ``torch.export``, saved and
    reloaded, gives the eager closure's outputs exactly."""
    model, cfg = vrcnn_run["model"], vrcnn_run["cfg"]
    dev_batch = _tb(batch)
    exported = serving.export_serving(model, cfg, dev_batch)
    path = tmp_path / "voxel_rcnn_b2.pt2"
    full = EasyDict(MODEL=cfg, CLASS_NAMES=list(CLASSES), DATA_CONFIG=EasyDict(
        DATA_PROCESSOR=[EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=list(VOXEL),
                                 MAX_POINTS_PER_VOXEL=P, MAX_NUMBER_OF_VOXELS=V)],
        POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]}))
    serving.save_serving(exported, path, serving.serving_meta(full, "tiny.yaml", dev_batch,
                                                              exported))
    predict, _ = serving.load_serving(path)
    got = predict(dev_batch)
    want = serving.make_predict_fn(model, cfg)(dev_batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["pred_counts"].min()) > 0


def test_build_network_voxel_rcnn_yaml():
    """The shipped yaml at full width, its grid from the dataset: 1408 x
    1600 x 40 cells, 70400 anchors, 216 grid points of three levels into
    SHARED_FC's 20736 inputs; every leaf of a JAX tree of the same config
    consumed (the roi_head subtree with the rest); the refined
    post-processing registered."""
    cfg = cfg_from_yaml_file(str(YAML))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds, device="cpu")
    assert model.grid_size == (1408, 1600, 40) and model.anchors_flat.shape == (70400, 7)
    assert model.roi_head.shared_fc0.in_features == 216 * 96
    assert [model.roi_head.strides[s] for s in model.roi_head.sources] == [2, 4, 8]
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    jmodel = j_build(JEasyDict(cfg.MODEL), num_class=1, dataset=jds)
    spec = serving.serving_input_spec(cfg, 1, model)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *(jnp.zeros(s, jnp.float32 if d == torch.float32 else jnp.int32)
                                 for s, d in spec.values()), train=False))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rs.rand(*s.shape).astype(np.float32), shapes)
    assert "roi_head" in variables["params"]
    load_jax_variables(model, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(model.state_dict())
    torch.testing.assert_close(model.roi_head.pool_x_conv3.mlp_in.weight, torch.from_numpy(
        np.asarray(variables["params"]["roi_head"]["pool_x_conv3"]["mlp_in"]["kernel"]).T),
        rtol=0, atol=0)
    from pdanet_tpu_torch.models.detectors import voxel_rcnn

    assert get_post_processor("VoxelRCNN") is voxel_rcnn.post_processing
    assert get_post_processor("CaDDN") is not voxel_rcnn.post_processing  # the single NMS
    # over the dense backbone, the dense-grid pool (its parity below)
    dense = EasyDict(vrcnn_cfg())
    dense.BACKBONE_3D = EasyDict(dense.BACKBONE_3D, NAME="VoxelBackBone8x")
    model = build_network(dense, len(CLASSES), device="cpu", **GEOMETRY)
    assert all(isinstance(getattr(model.roi_head, f"pool_{s}"), head.NeighborGridPool)
               for s in model.roi_head.sources)


@pytest.mark.parametrize("train", [True, False])
def test_dense_neighbor_grid_pool_equals_jax(train):
    """The JAX package's dense-grid ``NeighborGridPool`` (Voxel-RCNN over
    ``VoxelBackBone8x``) in float64 on a stride-2 level of 4 x 16 x 16
    cells: grid points inside, at the edges and outside the grid; the
    output within 1e-12 of max(1, |value|), the gradients of the weights
    and the level within 1e-11 of their largest |gradient| (the window's
    max sends its gradient to the first maximum, ties of zeros included),
    the running statistics within 1e-12."""
    rs = np.random.RandomState(3 + train)
    dense = rs.randn(2, 4, 16, 16, 6)
    dense[:, :, :4] = 0.0  # empty cells: ties in the window's max
    query = rs.uniform((-0.6, -3.8, -3.6), (7.0, 3.8, 1.6), (2, 60, 3))
    mlp, radius = (6, 8, 12), 0.7
    jpool = j_head.NeighborGridPool(mlp=mlp, radius=radius)
    variables = _perturb(jax.device_get(jax.jit(lambda d, q: jpool.init(
        jax.random.PRNGKey(0), d, 2, q, VOXEL, PCR))(dense.astype(np.float32),
                                                     query.astype(np.float32))), 9, np.float64)
    cot = rs.randn(2, 60, 12)
    with _exact_f64():
        def fn(params, d):
            out, mut = jpool.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   d, 2, query, VOXEL, PCR, train=train,
                                   mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (want, stats)), (g_params, g_dense) = jax.jit(
            jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))(variables["params"], dense)
        want, stats, g_params, g_dense = jax.device_get((want, stats, g_params, g_dense))
    pool = head.NeighborGridPool(mlp, radius).double().train(train)
    load_jax_variables(pool, variables)
    d = torch.from_numpy(dense).requires_grad_()
    got = pool(d, 2, torch.from_numpy(query), VOXEL, PCR)
    (got * torch.from_numpy(cot)).sum().backward()
    err = (got.detach().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert np.abs(err).max() <= 1e-12 and np.abs(want).max() > 0.1
    assert np.abs(d.grad.numpy() - g_dense).max() <= 1e-11 * np.abs(g_dense).max()
    ref = head.NeighborGridPool(mlp, radius).double()
    load_jax_variables(ref, {"params": g_params, "batch_stats": variables["batch_stats"]})
    for name, p in pool.named_parameters():
        w = dict(ref.named_parameters())[name]
        assert (p.grad - w).abs().max() <= 1e-11 * w.abs().max(), name
    if train:
        _stats_close(pool, stats, atol=1e-12)

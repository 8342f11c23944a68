"""The stand-alone ops of the IASSD surface in pdanet_tpu_torch against the
JAX package, on the CPU, on seeded numpy inputs handed to both:

* the ellipsoid query and its grouper, mirroring
  ``tests/test_ellipsoid_query.py`` (the scan-order oracle there and the
  JAX op): indices equal on clouds whose group covariances have distinct
  eigenvalues, and on the degenerate paths (fewer than three hits, no hit,
  a point exactly at the origin, full slots);
* the dilated (annulus) query: indices equal, the double admission of a
  point at d = 0 when the inner radius is 0 included;
* ``boxes_overlap_bev`` within 1e-5 of JAX's (float32 corners round apart
  by an ulp), ``paired_boxes_iou3d`` within 1e-5 of JAX's and of the
  diagonal of the pairwise IoU;
* ``nms_rotated`` / ``class_agnostic_nms``: the selection equal, the
  counts equal, the scores within 1e-6;
* ``cd_loss_l2`` within 1e-6, ``gaussian_density`` within 1e-6,
  ``enlarge_box3d_np`` and ``mask_points_by_range`` equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import ball_query_dilated_oracle, nms_oracle
from pdanet_tpu.ops import ball_query as j_bq
from pdanet_tpu.ops import chamfer as j_chamfer
from pdanet_tpu.ops import ellipsoid_query as j_ell
from pdanet_tpu.ops import geometry as j_geom
from pdanet_tpu.ops import grouping as j_grouping
from pdanet_tpu.ops import nms as j_nms
from pdanet_tpu.ops import rotated_iou as j_iou
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.models.model_utils.model_nms_utils import class_agnostic_nms
from pdanet_tpu_torch.ops import ball_query as bq
from pdanet_tpu_torch.ops import chamfer, geometry, grouping, nms, rotated_iou
from pdanet_tpu_torch.ops.ellipsoid_query import ellipsoid_query, query_and_group_ellipsoid
from pdanet_tpu_torch.utils.easydict import EasyDict
from test_ellipsoid_query import ellipsoid_query_oracle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cloud(B, N, seed, scale=3.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, N, 3) * scale).astype(np.float32)


def _ell_both(radius, nsample, xyz, centers):
    got = ellipsoid_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(centers))
    want = np.asarray(j_ell.ellipsoid_query(radius, nsample, jnp.asarray(xyz),
                                            jnp.asarray(centers)))
    return got.numpy(), want


def _anisotropic(seed, M=8):
    """Elongated clusters: well-separated eigenvalues, so the re-oriented
    long axis changes the result against the ball query."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(1, M, 3).astype(np.float32) * 2.0
    pts = []
    for j in range(M):
        d = rs.randn(3)
        d /= np.linalg.norm(d)
        pts.append(centers[0, j] + rs.randn(64, 1) * 1.2 * d + rs.randn(64, 3) * 0.08)
    return np.concatenate(pts, 0)[None].astype(np.float32), centers


@pytest.mark.parametrize("case", ["random", "anisotropic", "smoke"])
def test_ellipsoid_query_equals_jax(case):
    """Indices equal to JAX's op and to the scan-order oracle."""
    if case == "random":
        xyz = _cloud(2, 256, 0, scale=1.5)
        centers, radius, k = xyz[:, ::16].copy(), 0.8, 16
    elif case == "anisotropic":
        (xyz, centers), radius, k = _anisotropic(3), 0.5, 24
    else:
        xyz = _cloud(1, 128, 5, scale=0.8)
        centers, radius, k = xyz[:, ::32].copy(), 0.6, 8
    got, want = _ell_both(radius, k, xyz, centers)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ellipsoid_query_oracle(radius, k, xyz, centers))
    if case == "anisotropic":  # the union stage appended beyond the sphere
        d2 = np.sum((xyz[0][None] - centers[0][:, None]) ** 2, -1)
        sphere = np.minimum((d2 < radius * radius).sum(-1), k)
        grown = np.array([len(set(got[0, j].tolist())) for j in range(centers.shape[1])])
        assert (grown > sphere).any()


def test_ellipsoid_query_degenerate_paths():
    """Fewer than three hits (the ball result), no hit (index 0), a point
    exactly at the origin (the identity basis), full slots (no append)."""
    xyz = np.zeros((1, 8, 3), np.float32)
    xyz[0] = [[5, 5, 5], [0.1, 0, 0], [0, 0.1, 0], [0, 0, 0], [0.3, 0.3, 0],
              [9, 9, 9], [9.1, 9, 9], [-9, -9, -9]]
    centers = np.array([[[0.0, 0, 0], [9.0, 9, 9], [50.0, 50, 50]]], np.float32)
    got, want = _ell_both(0.5, 4, xyz, centers)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ellipsoid_query_oracle(0.5, 4, xyz, centers))
    assert (got[0, 2] == 0).all()
    dense = _cloud(1, 64, 7, scale=0.2)
    got, want = _ell_both(0.6, 8, dense, np.zeros((1, 1, 3), np.float32))
    np.testing.assert_array_equal(got, want)


def test_query_and_group_ellipsoid_equals_jax():
    xyz = _cloud(2, 64, 1, scale=0.5)
    centers = xyz[:, ::8].copy()
    feats = _cloud(2, 64, 2)[..., :2]
    got = query_and_group_ellipsoid(0.7, 8, torch.from_numpy(xyz), torch.from_numpy(centers),
                                    torch.from_numpy(feats))
    want = j_ell.query_and_group_ellipsoid(0.7, 8, jnp.asarray(xyz), jnp.asarray(centers),
                                           jnp.asarray(feats))
    assert got.shape == (2, 8, 8, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    only_xyz = query_and_group_ellipsoid(0.7, 8, torch.from_numpy(xyz),
                                         torch.from_numpy(centers))
    np.testing.assert_array_equal(only_xyz.numpy(), got[..., :3].numpy())


@pytest.mark.parametrize("rmax, rmin", [(1.0, 0.0), (1.5, 0.5)])
def test_ball_query_dilated_equals_jax(rmax, rmin):
    """Centres on cloud points (exact self matches, d = 0), and a duplicated
    point: with rmin 0 a point at d = 0 takes two slots, as in CUDA."""
    xyz = (np.random.RandomState(9).rand(2, 96, 3).astype(np.float32) - 0.5) * 4.0
    xyz[:, 50] = xyz[:, 3]
    centers = xyz[:, :16].copy()
    got = bq.ball_query_dilated(rmax, rmin, 8, torch.from_numpy(xyz), torch.from_numpy(centers))
    want = np.asarray(j_bq.ball_query_dilated(rmax, rmin, 8, jnp.asarray(xyz),
                                              jnp.asarray(centers)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  ball_query_dilated_oracle(rmax, rmin, 8, xyz, centers))
    if rmin == 0.0:  # the double admission shows
        assert (got.numpy()[:, :, 0] == got.numpy()[:, :, 1]).any()


def _boxes(n, seed):
    rs = np.random.RandomState(seed)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0:2] = (rs.rand(n, 2) - 0.5) * 10
    boxes[:, 2] = (rs.rand(n) - 0.5) * 2
    boxes[:, 3:6] = rs.rand(n, 3) * 3 + 0.3
    boxes[:, 6] = (rs.rand(n) - 0.5) * 2 * np.pi
    return boxes


def test_boxes_overlap_bev_and_paired_iou3d_equal_jax():
    a, b = _boxes(24, 13), _boxes(16, 14)
    got = rotated_iou.boxes_overlap_bev(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(j_iou.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (24, 16) and (want > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # paired rows: b's rows near a's so that most pairs overlap
    c = a + np.random.RandomState(15).randn(24, 7).astype(np.float32) * 0.3
    c[:, 3:6] = np.abs(c[:, 3:6]) + 0.1
    c[3] = a[3]  # an identical pair
    paired = rotated_iou.paired_boxes_iou3d(torch.from_numpy(a), torch.from_numpy(c))
    want_p = np.asarray(j_iou.paired_boxes_iou3d(jnp.asarray(a), jnp.asarray(c)))
    assert paired.shape == (24,) and (want_p > 0).sum() > 12
    np.testing.assert_allclose(paired.numpy(), want_p, atol=1e-5)
    diag = np.diag(rotated_iou.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(c)).numpy())
    np.testing.assert_allclose(paired.numpy(), diag, atol=1e-6)
    assert abs(paired[3].item() - 1.0) < 1e-5


@pytest.mark.parametrize("score_thresh, post", [(None, 64), (0.5, 5)])
def test_nms_rotated_equals_jax(score_thresh, post):
    """The stable score order, the walk and the compaction with -1 padding:
    selection and count equal to JAX's (and the oracle's), scores within
    1e-6; the config form through ``class_agnostic_nms``."""
    rs = np.random.RandomState(16)
    n = 64
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0:2] = (rs.rand(n, 2) - 0.5) * 8
    boxes[:, 3:6] = rs.rand(n, 3) * 2 + 0.5
    boxes[:, 6] = (rs.rand(n) - 0.5) * np.pi
    scores = rs.rand(n).astype(np.float32)
    scores[7] = scores[9]  # a tie keeps the lower index first
    scores[11] = np.nan  # a non-finite score never takes part
    sel, count, sel_scores = nms.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                                             0.1, pre_maxsize=n, post_maxsize=post,
                                             score_thresh=score_thresh)
    jsel, jcount, jscores = j_nms.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), 0.1,
                                              pre_maxsize=n, post_maxsize=post,
                                              score_thresh=score_thresh)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert int(count) == int(jcount) > 0
    np.testing.assert_allclose(sel_scores.numpy(), np.asarray(jscores), atol=1e-6)
    assert (sel.numpy()[int(count):] == -1).all()
    if score_thresh is None:
        finite = np.where(np.isfinite(scores), scores, -np.inf)
        want = nms_oracle(boxes, finite, 0.1, pre_maxsize=n)
        np.testing.assert_array_equal(sel.numpy()[:int(count)], want[:int(count)])
    cfg = EasyDict(NMS_THRESH=0.1, NMS_PRE_MAXSIZE=n, NMS_POST_MAXSIZE=post)
    csel, ccount, _ = class_agnostic_nms(torch.from_numpy(scores), torch.from_numpy(boxes), cfg,
                                         score_thresh=score_thresh)
    from pdanet_tpu.models.model_utils import model_nms_utils as j_mnu
    jc = j_mnu.class_agnostic_nms(jnp.asarray(scores), jnp.asarray(boxes), JEasyDict(cfg),
                                  score_thresh=score_thresh)
    np.testing.assert_array_equal(csel.numpy(), np.asarray(jc[0]))
    assert int(ccount) == int(jc[1])


def test_cd_loss_l2_and_gaussian_density_equal_jax():
    rs = np.random.RandomState(21)
    a, b = rs.randn(2, 40, 3).astype(np.float32), rs.randn(2, 30, 3).astype(np.float32)
    got = chamfer.cd_loss_l2(torch.from_numpy(a), torch.from_numpy(b)).item()
    want = float(j_chamfer.cd_loss_l2(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    grouped = rs.randn(2, 5, 8, 3).astype(np.float32)
    centers = rs.randn(2, 5, 3).astype(np.float32)
    for radius in (0.8, 1.6):
        got = grouping.gaussian_density(torch.from_numpy(grouped), torch.from_numpy(centers),
                                        radius)
        want = np.asarray(j_grouping.gaussian_density(jnp.asarray(grouped),
                                                      jnp.asarray(centers), radius))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_enlarge_box3d_np_and_mask_points_by_range_equal_jax():
    boxes = _boxes(6, 22)
    got = geometry.enlarge_box3d_np(boxes, [0.2, 0.3, 0.4])
    np.testing.assert_array_equal(got, j_geom.enlarge_box3d_np(boxes, [0.2, 0.3, 0.4]))
    assert got is not boxes and not np.shares_memory(got, boxes)
    pts = (np.random.RandomState(23).rand(200, 4).astype(np.float32) - 0.5) * 100
    pts[0, :2] = [0.0, -40.0]  # on the bounds
    pts[1, :2] = [70.4, 40.0]
    limit = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
    got = geometry.mask_points_by_range(torch.from_numpy(pts), limit)
    want = np.asarray(j_geom.mask_points_by_range(jnp.asarray(pts), limit))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] and got[1] and 0 < got.sum() < 200

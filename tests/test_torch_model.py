"""The pdanet_tpu_torch slice as a whole against the JAX package, on the CPU.

The tiny PDA-SSD config (every layer type of the KITTI model at shrunken
budgets, float32) runs in both packages on the same cloud with the same
weights, carried from the flax variables by the weight bridge.  Tolerances
are those of the torch-twin parity test
(tests/test_full_model_torch_parity.py:404-435): xyz 1e-5, sa_ins logits
3e-4, centre features 1e-3, cls/box logits 2e-3; post-processed
detections agree in count and to 1e-4 in their boxes.

The slice runs twice: once with the JAX run's sampling and ball-query
indices fed into the port (separating the float modules from the index
ops), and once free-running, where every index must also be equal.  In
the dtype the yaml ships for serving (``COMPUTE_DTYPE: bfloat16`` on both
sides, JAX's indices fed), centre features and cls/box logits agree within
3e-2 of each tensor's largest |value|: the two frameworks round bfloat16
at other points (the guide's section on numbers that differ), so the
float32 tolerances do not apply.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from model_cfg import tiny_model_cfg
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.ops.ball_query import ball_query_multi as j_ball_query_multi
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import iassd_backbone
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

REPO = Path(__file__).resolve().parent.parent
NUM_CLASS = 3


def _cloud():
    rng = np.random.RandomState(17)
    B, N = 2, 128
    xyz = rng.rand(B, N, 3).astype(np.float32) * np.array([6.0, 6.0, 3.0], np.float32)
    return np.concatenate([xyz, rng.rand(B, N, 1).astype(np.float32)], axis=-1)


@pytest.fixture(scope="module")
def slice_run():
    """JAX run of the tiny model with perturbed weights, its per-layer
    indices, and a port model holding the same weights."""
    return _make_run()


@pytest.fixture(scope="module")
def slice_run_bf16():
    """The same in the shipped serving dtype: ``COMPUTE_DTYPE: bfloat16``."""
    return _make_run("bfloat16")


def _make_run(compute_dtype=None):
    cfg = EasyDict(tiny_model_cfg(NUM_CLASS))
    if compute_dtype:
        cfg.BACKBONE_3D.COMPUTE_DTYPE = compute_dtype
    points = _cloud()
    jmodel = j_build(cfg, num_class=NUM_CLASS)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(points), train=False)
    rs = np.random.RandomState(3)

    def perturb(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return rs.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if leaf == "scale":
            return rs.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return np.asarray(a)

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))
    out, state = jax.jit(
        lambda v, p: jmodel.apply(v, p, train=False, capture_intermediates=True,
                                  mutable=["intermediates"])
    )(variables, jnp.asarray(points))
    inter = state["intermediates"]["backbone_3d"]
    post = j_post(out["batch_cls_preds"], out["batch_box_preds"], cfg.POST_PROCESSING)

    sa_cfg = cfg.BACKBONE_3D.SA_CONFIG
    enc_xyz = [np.asarray(t) for t in out["encoder_xyz"]]
    samp, ball = [], []
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        s = b = None
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer":
            s = inter[f"SA_modules_{k}"]["__call__"][0][3]
            s = None if s is None else np.asarray(s)
            if sa_cfg.RADIUS_LIST[k]:
                b = [np.asarray(i) for i in j_ball_query_multi(
                    tuple(sa_cfg.RADIUS_LIST[k]), tuple(sa_cfg.NSAMPLE_LIST[k]),
                    jnp.asarray(enc_xyz[sa_cfg.LAYER_INPUT[k]]),
                    jnp.asarray(enc_xyz[k + 1]))]
        samp.append(s)
        ball.append(b)

    model = build_network(cfg, NUM_CLASS, device="cpu").eval()
    load_jax_variables(model, variables)
    return dict(cfg=cfg, points=points, variables=variables, out=out,
                post=jax.device_get(post), samp=samp, ball=ball, model=model)


def _run_port(run):
    with torch.no_grad():
        out = run["model"](torch.from_numpy(run["points"]))
        post = get_post_processor("IASSD")(out, run["cfg"])
    return out, post


def _compare(run, out, post):
    j = run["out"]
    sa_cfg = run["cfg"].BACKBONE_3D.SA_CONFIG
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        got, want = out["encoder_xyz"][k + 1].numpy(), np.asarray(j["encoder_xyz"][k + 1])
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer" and sa_cfg.CTR_INDEX[k] == -1:
            np.testing.assert_array_equal(got, want, err_msg=f"xyz L{k}")
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"xyz L{k}")
        if out["sa_ins_preds"][k] is not None:
            np.testing.assert_allclose(
                out["sa_ins_preds"][k].numpy(), np.asarray(j["sa_ins_preds"][k]),
                atol=3e-4, err_msg=f"sa_ins L{k}")
    np.testing.assert_allclose(out["centers"].numpy(), np.asarray(j["centers"]), atol=1e-5)
    np.testing.assert_allclose(out["centers_features"].numpy(),
                               np.asarray(j["centers_features"]), atol=1e-3)
    np.testing.assert_allclose(out["batch_cls_preds"].numpy(),
                               np.asarray(j["batch_cls_preds"]), atol=2e-3)
    np.testing.assert_allclose(out["center_box_preds"].numpy(),
                               np.asarray(j["center_box_preds"]), atol=2e-3)
    jp = run["post"]
    np.testing.assert_array_equal(post["pred_counts"].numpy(), jp["pred_counts"])
    np.testing.assert_allclose(post["pred_boxes"].numpy(), jp["pred_boxes"], atol=1e-4)
    np.testing.assert_allclose(post["pred_scores"].numpy(), jp["pred_scores"], atol=1e-4)
    np.testing.assert_array_equal(post["pred_labels"].numpy(), jp["pred_labels"])


def test_weight_bridge_consumes_every_leaf(slice_run):
    model, variables = slice_run["model"], slice_run["variables"]
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == len(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.isfinite(t).all(), name
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["point_head"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_variables(build_network(slice_run["cfg"], NUM_CLASS, device="cpu"), extra)
    short = jax.tree_util.tree_map(lambda a: a, variables)
    del short["batch_stats"]["point_head"]
    with pytest.raises(KeyError):
        load_jax_variables(build_network(slice_run["cfg"], NUM_CLASS, device="cpu"), short)


def _run_port_fed(run, monkeypatch):
    """The port's forward with the JAX run's sampling and ball-query
    indices fed."""
    samp = [s for s, fps_id in zip(run["samp"], run["model"].backbone_3d.fps_identity)
            if s is not None and not fps_id]
    ball = [b for b in run["ball"] if b is not None]

    def fed_sampling(*args):
        return torch.tensor(samp.pop(0))

    def fed_ball_query(radii, nsamples, xyz, new_xyz):
        return tuple(torch.tensor(i) for i in ball.pop(0))

    monkeypatch.setattr(iassd_backbone, "run_sampling", fed_sampling)
    monkeypatch.setattr(iassd_backbone, "ball_query_multi", fed_ball_query)
    out, post = _run_port(run)
    assert not samp and not ball
    return out, post


def test_slice_with_jax_indices(slice_run, monkeypatch):
    out, post = _run_port_fed(slice_run, monkeypatch)
    _compare(slice_run, out, post)


def test_slice_bf16_with_jax_indices(slice_run_bf16, monkeypatch):
    out, _ = _run_port_fed(slice_run_bf16, monkeypatch)
    j = slice_run_bf16["out"]
    for key in ("centers_features", "batch_cls_preds", "center_box_preds"):
        want = np.asarray(j[key], np.float32)
        got = out[key].float().numpy()
        scale = np.abs(want).max()
        err = np.abs(got - want).max() / scale
        assert err <= 3e-2, f"{key}: max |port - JAX| / max |JAX| = {err:.3g} > 3e-2"


def test_slice_free_running(slice_run):
    out, post = _run_port(slice_run)
    sa_cfg = slice_run["cfg"].BACKBONE_3D.SA_CONFIG
    j = slice_run["out"]
    for k, (js, jb) in enumerate(zip(slice_run["samp"], slice_run["ball"])):
        if js is not None:
            msg = f"sampled idx L{k}"
            if "ctr_aware" in sa_cfg.SAMPLE_METHOD_LIST[k]:
                # the ctr-aware cut must not sit on a near tie of the scores
                cls = np.asarray(j["sa_ins_preds"][k - 1])
                score = np.sort(1 / (1 + np.exp(-cls.max(-1))), axis=-1)[:, ::-1]
                npoint = sa_cfg.NPOINT_LIST[k][0]
                gap = (score[:, npoint - 1] - score[:, npoint]).min()
                msg += f" (top-k score gap at the cut {gap:.3g})"
                assert gap > 1e-5, msg
            np.testing.assert_array_equal(out["sampled_idx"][k].numpy(), js, err_msg=msg)
        if jb is not None:
            for r, (g, w) in enumerate(zip(out["ball_query_idx"][k], jb)):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"ball L{k} r{r}")
    _compare(slice_run, out, post)


def test_config_loader_matches_jax():
    from pdanet_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
    from pdanet_tpu_torch.config import cfg_from_yaml_file

    path = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
    want = j_cfg_from_yaml_file(str(path), JEasyDict())
    got = cfg_from_yaml_file(str(path))
    assert got == want
    assert got.MODEL.BACKBONE_3D.SA_CONFIG.NPOINT_LIST[0] == [4096]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import pdanet_tpu_torch\n"
        "from pdanet_tpu_torch.models import build_network\n"
        "from pdanet_tpu_torch import serving\n"
        "from pdanet_tpu_torch.utils import jax_weights\n"
        "import pdanet_tpu_torch.train\n"
        "from pdanet_tpu_torch.models.dense_heads import iassd_head\n"
        "import pdanet_tpu_torch.datasets\n"
        "import pdanet_tpu_torch.datasets.once.once_dataset\n"
        "import pdanet_tpu_torch.datasets.once.once_eval.evaluation\n"
        "import pdanet_tpu_torch.eval.eval_utils\n"
        "import pdanet_tpu_torch.tools.export, pdanet_tpu_torch.tools.serve\n"
        "import pdanet_tpu_torch.tools.train, pdanet_tpu_torch.tools.test\n"
        "import pdanet_tpu_torch.parallel\n"
        "import pdanet_tpu_torch.graft_entry\n"
        "import pdanet_tpu_torch.models.detectors.pointpillar\n"
        "from pdanet_tpu_torch.models.backbones_3d.vfe import pillar_vfe\n"
        "from pdanet_tpu_torch.models.backbones_2d import base_bev_backbone\n"
        "from pdanet_tpu_torch.models.backbones_2d.map_to_bev import pointpillar_scatter\n"
        "from pdanet_tpu_torch.models.dense_heads import anchor_head\n"
        "import pdanet_tpu_torch.models.detectors.second\n"
        "from pdanet_tpu_torch.models.backbones_3d import sparse_backbone\n"
        "from pdanet_tpu_torch.models.backbones_3d.vfe import mean_vfe\n"
        "from pdanet_tpu_torch.ops import sparse_conv\n"
        "from pdanet_tpu_torch.datasets import random_draws\n"
        "import pdanet_tpu_torch.models.detectors.voxel_rcnn\n"
        "from pdanet_tpu_torch.models.roi_heads import roi_head_template, voxelrcnn_head\n"
        "from pdanet_tpu_torch.models.model_utils import model_nms_utils\n"
        "import pdanet_tpu_torch.models.detectors.part_a2\n"
        "import pdanet_tpu_torch.models.detectors.part_a2_free\n"
        "from pdanet_tpu_torch.models.backbones_3d import sparse_unet, voxel_unet\n"
        "from pdanet_tpu_torch.models.dense_heads import point_head_box\n"
        "from pdanet_tpu_torch.models.dense_heads import point_intra_part_head\n"
        "from pdanet_tpu_torch.models.roi_heads import partA2_head\n"
        "from pdanet_tpu_torch.ops import roi_pool\n"
        "import pdanet_tpu_torch.models.detectors.point_rcnn\n"
        "from pdanet_tpu_torch.models.backbones_3d import pointnet2_backbone\n"
        "from pdanet_tpu_torch.models.roi_heads import pointrcnn_head\n"
        "from pdanet_tpu_torch.ops import interpolate\n"
        "from pdanet_tpu_torch.ops import ellipsoid_query, chamfer, grouping, geometry, nms\n"
        "from pdanet_tpu_torch.ops.sampling import farthest_point_sample_features, ry_fps\n"
        "from pdanet_tpu_torch.models.blocks import CBAM, EncoderLayer\n"
        "from pdanet_tpu_torch.models.model_utils.model_nms_utils import class_agnostic_nms\n"
        "from pdanet_tpu_torch.tools import ckpt_converter, once_submit_result, profiler\n"
        "from pdanet_tpu_torch import native\n"
        "from pdanet_tpu_torch.datasets.processor import data_processor\n"
        "from pdanet_tpu_torch.utils import box_utils, iou3d_np\n"
        "from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import rotate_iou\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pdanet_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

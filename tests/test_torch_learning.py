"""What the learning checks of pdanet_tpu_torch stand on, against the JAX
package, on the CPU (tier 1; the overfits and the AP parity are the slow
``tests/test_torch_overfit_e2e.py`` and ``tests/test_torch_ap_parity.py``).

* Non-finite test boxes after a few steps from seeded weights: the port's
  seeded weights of the tiny PointPillar config (``tests/test_cli.py``
  ``PP_TINY_CFG``) carried into the JAX package by ``port_variables``,
  8 train steps in both in float64 on the same batches of the mini-KITTI
  fixture (``select_device_batch``, each package's ``make_train_step`` and
  adam_onecycle at the config's LR), then the test split decoded and
  post-processed by both: the same non-finite boxes and scores, and the
  finite ones within 1e-8 of max(1, |value|) (the largest box extent
  printed); the decode's ``exp`` is unclamped in both.  At this config
  neither package gives a non-finite box, so the test holds the two
  trajectories equal but does not reproduce the non-finite boxes seen at
  full width on the card (float32, where ``exp`` overflows above 88.7).
* ``BN_MOMENTUM`` of the CenterPoint and Voxel-RCNN tiny configs reaches
  the same BatchNorms in both packages, at the same momentum.
* What ``chip_smoke.py`` phase 24 runs without the JAX package: its four
  config strings equal ``tests/test_cli.py``'s, its fixture root equal to
  ``build_mini_kitti``'s file for file (the PNGs of the same size), and
  ``import chip_smoke`` with the root written pulls in no JAX, no
  ``pdanet_tpu`` and no PIL.
* The capstone fixture of ``tests/test_ap_parity_twin.py``: the port's
  loader gives the JAX loader's batches bit for bit with augmentation off,
  and the gt fed back through the port's prediction dicts and official
  evaluation gives the JAX package's eval ceiling.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax

import chip_smoke
import test_cli
from kitti_fixture import build_mini_kitti
from test_torch_kitti import assert_same
from pdanet_tpu.datasets import build_dataloader as j_build_dataloader
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate
from pdanet_tpu.models import build_network as j_build
from pdanet_tpu.models.detectors import get_post_processor as j_get_post_processor
from pdanet_tpu.train import build_optimizer_and_schedule as j_build_optimizer
from pdanet_tpu.train import create_train_state
from pdanet_tpu.train import make_train_step as j_make_train_step
from pdanet_tpu.train.train_utils import select_device_batch as j_select
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.datasets import build_dataloader
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.blocks import BatchNorm, init_random_weights
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step
from pdanet_tpu_torch.train.train_utils import select_device_batch
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import port_variables

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N_STEPS = 8
BATCH = 2
SEED = 0  # the port's seeded weights
BOX_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _kitti(tmp_path, cfg_text, **fixture):
    """A mini-KITTI root with the port's infos, and the config over it."""
    import yaml

    root = tmp_path / "kitti"
    build_mini_kitti(root, **fixture)
    cfg = EasyDict(yaml.safe_load(cfg_text.format(data_path=root)))
    create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=1)
    return root, cfg


def _geometry(cfg):
    return DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")


def _f64(batch):
    return {k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32 else v
            for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# non-finite test boxes after 8 steps from seeded weights
# ---------------------------------------------------------------------------


def _port_run(cfg, batches, tests):
    """8 float64 steps of the port from its seeded weights; then the test
    batches' decoded boxes and scores and their post-processed detections."""
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=_geometry(cfg), device="cpu")
    init_random_weights(model, SEED)
    variables = port_variables(model)
    model.double()
    optimizer, schedule = build_optimizer_and_schedule(
        model, cfg.OPTIMIZATION, len(batches), N_STEPS // len(batches))
    step = make_train_step(model, optimizer, schedule)
    losses = [step(select_device_batch(batches[t % len(batches)], CPU, model))[0].item()
              for t in range(N_STEPS)]
    model.eval()
    post_fn = get_post_processor(cfg.MODEL.NAME)
    outs = []
    with torch.no_grad():
        for b in tests:
            dev = select_device_batch(b, CPU, model)
            dev.pop("gt_boxes", None)
            out = model.forward_batch(dev)
            pred = post_fn(out, cfg.MODEL)
            outs.append({k: v.numpy() for k, v in (
                ("boxes", out["batch_box_preds"]), ("scores", out["batch_cls_preds"]),
                *((f"pred_{k}", pred[f"pred_{k}"]) for k in
                  ("boxes", "scores", "labels", "counts")))})
    return variables, losses, outs


def _jax_run(cfg, variables, batches, tests):
    """The same with the JAX package from the port's weights, in float64."""
    jcfg = JEasyDict(cfg)
    jax.config.update("jax_enable_x64", True)
    try:
        geometry = JDatasetTemplate(dataset_cfg=jcfg.DATA_CONFIG, class_names=jcfg.CLASS_NAMES,
                                    training=False, root_path=".")
        model = j_build(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=geometry)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        tx, _ = j_build_optimizer(jcfg.OPTIMIZATION, len(batches), N_STEPS // len(batches))
        state = create_train_state(model, variables, tx)
        step = jax.jit(j_make_train_step(model, tx))
        losses = []
        for t in range(N_STEPS):
            state, loss, _ = step(state, j_select(batches[t % len(batches)], model))
            losses.append(float(loss))
        post_fn = j_get_post_processor(jcfg.MODEL.NAME)

        @jax.jit
        def forward(params, batch_stats, dev):
            out = model.apply({"params": params, "batch_stats": batch_stats}, dev,
                              train=False, method=model.forward_batch)
            return out, post_fn(out, jcfg.MODEL)

        outs = []
        for b in tests:
            dev = j_select(b, model)
            dev.pop("gt_boxes", None)
            out, pred = _np(forward(state.params, state.batch_stats, dev))
            outs.append({"boxes": out["batch_box_preds"], "scores": out["batch_cls_preds"],
                         **{f"pred_{k}": pred[f"pred_{k}"]
                            for k in ("boxes", "scores", "labels", "counts")}})
    finally:
        jax.config.update("jax_enable_x64", False)
    return losses, outs


def _same_nonfinite_and_close(got, want, what):
    """The same non-finite entries (inf of the same sign, NaN), the finite
    ones within BOX_TOL of max(1, |value|).  Returns the largest |finite|."""
    bad_g, bad_w = ~np.isfinite(got), ~np.isfinite(want)
    np.testing.assert_array_equal(bad_g, bad_w, err_msg=f"{what}: non-finite positions")
    np.testing.assert_array_equal(got[bad_g], want[bad_w], err_msg=f"{what}: non-finite values")
    fin = ~bad_w
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= BOX_TOL, f"{what}: largest relative gap {err.max()}"
    return int(bad_w.sum()), float(np.abs(want[fin]).max(initial=0.0))


def test_pointpillar_nonfinite_boxes_after_eight_steps_match_jax_float64(tmp_path):
    root, cfg = _kitti(tmp_path, test_cli.PP_TINY_CFG, num_frames=4)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, BATCH, root_path=root,
                                    training=True, workers=0)
    batches = [_f64(b) for b in loader]
    _, test_loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, BATCH,
                                         root_path=root, training=False, workers=0)
    tests = [_f64(b) for b in test_loader]
    assert len(batches) == 2 and len(tests) == 2
    variables, port_losses, port = _port_run(cfg, batches, tests)
    jax_losses, ref = _jax_run(cfg, variables, batches, tests)
    rel = np.abs(np.subtract(port_losses, jax_losses)) / np.abs(jax_losses)
    assert rel.max() <= 1e-10, (port_losses, jax_losses)
    report = []
    for i, (p, j) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(p["pred_counts"], j["pred_counts"])
        np.testing.assert_array_equal(p["pred_labels"], j["pred_labels"])
        for key in ("boxes", "scores", "pred_boxes", "pred_scores"):
            report.append((f"batch {i} {key}", *_same_nonfinite_and_close(
                p[key], j[key], f"batch {i} {key}")))
    extent = max(np.abs(np.nan_to_num(j["boxes"][..., 3:6], posinf=0.0, neginf=0.0)).max()
                 for j in ref)
    print(f"losses over {N_STEPS} steps {jax_losses}; (non-finite, largest |finite|): {report}; "
          f"largest decoded box extent {extent:.2f} m")


# ---------------------------------------------------------------------------
# BN_MOMENTUM reaches the same BatchNorms
# ---------------------------------------------------------------------------


def _jax_bn_momenta(jcfg, batch):
    """{module path: momentum} of every BatchNorm the JAX model calls."""
    geometry = JDatasetTemplate(dataset_cfg=jcfg.DATA_CONFIG, class_names=jcfg.CLASS_NAMES,
                                training=False, root_path=".")
    model = j_build(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES), dataset=geometry)
    found = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and "BatchNorm" in type(mod).__name__:
            found[".".join(mod.path)] = float(mod.momentum)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, train=False,
                                            method=model.forward_batch), j_select(batch, model))
    return found


@pytest.mark.parametrize("name", ["CP_TINY_CFG", "VR_TINY_CFG"])
def test_bn_momentum_reaches_the_same_batchnorms(tmp_path, name):
    root, cfg = _kitti(tmp_path, getattr(test_cli, name), num_frames=2)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, root_path=root,
                                    training=True, workers=0)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=_geometry(cfg), device="cpu")
    port = {n: float(m.momentum) for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    assert port == _jax_bn_momenta(JEasyDict(cfg), next(iter(loader)))
    # all 0.9, but Voxel-RCNN's conv_out, which keeps 0.99 in both packages
    assert {n for n, m in port.items() if m != 0.9} <= {"backbone_3d.conv_out.BatchNorm_0"}, port


# ---------------------------------------------------------------------------
# chip_smoke.py phase 24 without the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TINY_CFG", "PP_TINY_CFG", "CP_TINY_CFG", "VR_TINY_CFG"])
def test_chip_smoke_learning_configs_equal_the_tests(name):
    assert getattr(chip_smoke, name) == getattr(test_cli, name)


def test_chip_smoke_fixture_root_equals_build_mini_kitti(tmp_path):
    from PIL import Image

    ids = chip_smoke.write_fixture_root(tmp_path / "card")
    want = build_mini_kitti(tmp_path / "cpu", **chip_smoke.LEARNING_FIXTURE)
    assert ids == want
    files = sorted(p.relative_to(tmp_path / "cpu") for p in (tmp_path / "cpu").rglob("*")
                   if p.is_file())
    got = sorted(p.relative_to(tmp_path / "card") for p in (tmp_path / "card").rglob("*")
                 if p.is_file())
    assert got == files and len(files) == 4 * 5 + 3
    for rel in files:
        a, b = (tmp_path / "card" / rel), (tmp_path / "cpu" / rel)
        if rel.suffix == ".png":
            assert Image.open(a).size == Image.open(b).size == (1242, 375)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_chip_smoke_learning_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import chip_smoke\n"
        f"chip_smoke.write_fixture_root({str(tmp_path / 'root')!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pdanet_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(list((tmp_path / "root" / "training" / "velodyne").iterdir())) == 4


# ---------------------------------------------------------------------------
# the capstone fixture of the AP parity
# ---------------------------------------------------------------------------


def test_capstone_loader_and_eval_ceiling_equal_jax(tmp_path):
    from test_ap_parity_twin import _capstone_fixture, _eval_ceiling

    jcfg, root = _capstone_fixture(tmp_path)
    cfg = EasyDict(jcfg)
    np.random.seed(0)
    _, jloader, _ = j_build_dataloader(dataset_cfg=jcfg.DATA_CONFIG, class_names=jcfg.CLASS_NAMES,
                                       batch_size=4, training=True, root_path=root)
    np.random.seed(0)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4, training=True,
                                    root_path=root)
    want, got = list(jloader), list(loader)
    assert len(got) == len(want) == 2
    assert_same(got, want)
    import test_torch_ap_parity

    assert test_torch_ap_parity._eval_ceiling(cfg, root) == _eval_ceiling(jcfg, root)

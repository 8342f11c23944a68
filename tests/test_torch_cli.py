"""The port's train and test CLIs (``pdanet_tpu_torch.tools.train`` /
``.test``) on the synthetic mini-KITTI of ``tests/kitti_fixture.py``, in
process, on the CPU (``--device cpu``).

The config is the shipped ``tools/cfgs/kitti_models/PDA-SSD.yaml`` with its
full data pipeline (FOV crop, gt sampling on the road plane, world flip /
rotation / scaling, the four point processors) at a 512-point budget and
the tiny model of ``tests/model_cfg.py``.

* ``--launcher pytorch`` without torchrun's ``RANK`` raises.
* The train CLI trains one epoch and writes its checkpoint and metrics;
  a second run resumes from it; a corrupt newest checkpoint is skipped
  for the one before it; old checkpoints rotate out beyond
  ``--max_ckpt_save_num``; the post-train evaluation writes its results.
* The test CLI writes ``result.pkl`` with every val frame; ``--eval_all``
  evaluates the one checkpoint and stops.
* The shipped ``pointpillar.yaml`` (a voxel pipeline: ragged frames,
  the host voxelizer, the voxel collate; the PointPillar detector at a
  tiny width on 0.32 m pillars) trains one epoch through the train CLI,
  and the test CLI evaluates its checkpoint.
* The shipped ``second.yaml`` (MeanVFE, the sparse voxel backbone, at a
  tiny width on 0.2 x 0.2 x 0.1 m voxels) the same, its train loader on
  two threads.
* The shipped ``voxel_rcnn_car.yaml`` cut to size the same way, with its
  second stage (the RoI sampler, the voxel-query pool, the refined
  post-processing and the ``roi_<t>`` recall).
* The shipped ``pv_rcnn.yaml`` cut to size the same way (the raw points
  beside the voxels, the VSA, the point head, the ball-query RoI grid
  pool) through the train, test and export CLIs.
* The shipped ``CaDDN.yaml`` cut to size (a DDN of width 16, 16 depth
  bins, an 80 x 128 x 8 grid, a 16 / 32-filter BEV backbone) on a
  mini-KITTI of its own with camera inputs (textured 375 x 1242 and 370 x
  1224 images, 16-bit depth maps) through the train and test CLIs; the
  export CLI refuses it as the JAX package's serving spec does.
* A JAX-package checkpoint of the same config, saved by
  ``pdanet_tpu.train.save_checkpoint``, is evaluated by the port's test
  CLI and by JAX's ``eval_one_epoch`` on the same frames: equal detection
  counts, boxes within 2e-3 and scores within 1e-3 (the margins printed).
"""

import copy
import json
import logging
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from kitti_fixture import build_mini_kitti
from model_cfg import tiny_model_cfg
from pdanet_tpu.datasets import build_dataloader as j_build_dataloader
from pdanet_tpu.eval.eval_utils import eval_one_epoch as j_eval_one_epoch
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.train import build_optimizer_and_schedule as j_build_optimizer
from pdanet_tpu.train import create_train_state as j_create_train_state
from pdanet_tpu.train import save_checkpoint as j_save_checkpoint
from pdanet_tpu.train.train_utils import checkpoint_state as j_checkpoint_state
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from pdanet_tpu_torch.tools import test as test_cli
from pdanet_tpu_torch.tools import train as train_cli

REPO = Path(__file__).resolve().parent.parent
KITTI_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
PP_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pointpillar.yaml"
PP_CFG_REL = "cfgs/tiny/pointpillar-tiny.yaml"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
N_POINTS = 512
CFG_REL = "cfgs/tiny/PDA-SSD-tiny.yaml"  # relative to the run's working directory
KITTI_KEYS = {"name", "score", "boxes_lidar", "bbox", "location", "frame_id"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_plain(v) for v in d]
    return d


@pytest.fixture(scope="module")
def kitti_env(tmp_path_factory):
    """The mini-KITTI root with the port's infos and gt database, and the
    config text (the shipped yaml, 512 points, the tiny model)."""
    root = tmp_path_factory.mktemp("cli_kitti")
    build_mini_kitti(root, num_frames=4)
    cfg = cfg_from_yaml_file(str(KITTI_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": N_POINTS, "test": N_POINTS}
    cfg.MODEL = tiny_model_cfg(len(CLASSES))
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    create_kitti_infos(cfg.DATA_CONFIG, CLASSES, root, root, workers=1)
    return root, yaml.safe_dump(_plain(cfg))


@pytest.fixture
def workdir(kitti_env, tmp_path, monkeypatch):
    """A working directory holding the config under ``CFG_REL``."""
    (tmp_path / CFG_REL).parent.mkdir(parents=True)
    (tmp_path / CFG_REL).write_text(kitti_env[1])
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _train(*extra):
    return train_cli.main(["--cfg_file", CFG_REL, "--device", "cpu", "--workers", "0",
                           "--batch_size", "2", *extra])


def _log(out_dir, kind):
    return "\n".join(p.read_text() for p in sorted(Path(out_dir).glob(f"log_{kind}_*.txt")))


def test_clis_default_to_cuda():
    for cli in (train_cli, test_cli):
        args, _ = cli.parse_config(["--cfg_file", str(KITTI_YAML)])
        assert args.device == "cuda"


def test_launcher_other_than_none_raises(workdir, monkeypatch):
    """``--launcher pytorch`` outside torchrun (no RANK in the environment)
    raises before it joins a process group, where every process would
    otherwise claim rank 0 and hang the rendezvous."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="needs RANK"):
            cli.main(["--cfg_file", CFG_REL, "--device", "cpu", "--launcher", "pytorch"])
    assert not torch.distributed.is_initialized()


def test_set_overrides_the_yaml():
    _, cfg = train_cli.parse_config(["--cfg_file", str(KITTI_YAML), "--set",
                                     "OPTIMIZATION.LR", "0.5", "DATA_CONFIG.DATA_PATH", "/d",
                                     "MODEL.BACKBONE_3D.COMPUTE_DTYPE", "None"])
    assert cfg.OPTIMIZATION.LR == 0.5 and cfg.DATA_CONFIG.DATA_PATH == "/d"
    assert cfg.MODEL.BACKBONE_3D.COMPUTE_DTYPE is None
    with pytest.raises(KeyError):
        train_cli.parse_config(["--cfg_file", str(KITTI_YAML), "--set", "MODEL.NO_SUCH", "1"])


def test_train_cli_one_epoch_then_resume(workdir):
    out = _train("--epochs", "1", "--num_epochs_to_eval", "0")
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    assert ckpt.exists()
    lines = (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()
    tags = [json.loads(line)["tag"] for line in lines]
    # four frames at two a batch: two steps, each recorded
    assert tags.count("train/loss") == tags.count("meta_data/batch_time") == 2
    assert "meta_data/data_time" in tags

    out = _train("--epochs", "2", "--num_epochs_to_eval", "0")
    assert "auto-resumed from" in _log(out, "train")
    assert (out / "ckpt" / "checkpoint_epoch_2.pth").exists()

    # a corrupt newest checkpoint: resume from the one before it
    newest = out / "ckpt" / "checkpoint_epoch_2.pth"
    newest.write_bytes(newest.read_bytes()[:1000])
    for log in out.glob("log_train_*.txt"):
        log.unlink()
    out = _train("--epochs", "3", "--num_epochs_to_eval", "0", "--max_ckpt_save_num", "2")
    log = _log(out, "train")
    assert "skipping corrupt checkpoint" in log
    assert "auto-resumed from" in log and "checkpoint_epoch_1.pth at epoch 1" in log
    names = sorted(p.name for p in (out / "ckpt").glob("checkpoint_epoch_*.pth"))
    assert names == ["checkpoint_epoch_2.pth", "checkpoint_epoch_3.pth"]
    from pdanet_tpu_torch.train import load_checkpoint

    ck = load_checkpoint(out / "ckpt" / "checkpoint_epoch_3.pth")
    assert ck["epoch"] == 3 and ck["it"] == 6


def test_train_cli_evaluates_after_training(workdir):
    out = _train("--epochs", "1", "--num_epochs_to_eval", "1")
    result = out / "eval" / "eval_with_train" / "epoch_1" / "val" / "result.pkl"
    with open(result, "rb") as f:
        annos = pickle.load(f)
    assert len(annos) == 4
    assert "Car AP@0.70, 0.70, 0.70" in _log(out, "train")


def test_train_cli_profile(workdir):
    """``--profile`` traces train steps 3-5 (here 3-4 of 4) with torch.profiler."""
    out = _train("--epochs", "2", "--num_epochs_to_eval", "0", "--profile")
    traces = list((out / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_test_cli_single_ckpt_and_eval_all(workdir, monkeypatch):
    out = _train("--epochs", "1", "--num_epochs_to_eval", "0")
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", CFG_REL, "--ckpt", str(ckpt), "--device", "cpu",
                            "--workers", "0", "--batch_size", "1", "--infer_time"])
    assert "recall/rcnn_0.3" in result and "Car_3d/moderate_R40" in result
    res_dir = out / "eval" / "epoch_1" / "val" / "default"
    with open(res_dir / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS
    assert re.search(r"Average infer time: [0-9.]+ ms", _log(res_dir, "eval"))

    sleeps = []
    monkeypatch.setattr(test_cli.time, "sleep", sleeps.append)
    assert test_cli.main(["--cfg_file", CFG_REL, "--eval_all", "--device", "cpu",
                          "--workers", "0", "--max_waiting_mins", "0"]) is None
    watch = out / "eval" / "eval_all_default" / "default"
    assert (watch / "eval_list_val.txt").read_text().split() == ["1"]
    assert (out / "eval" / "eval_all_default" / "epoch_1" / "val" / "result.pkl").exists()
    assert sleeps == [test_cli.POLL_SECONDS]


def _pointpillar_tiny_yaml(root):
    """The shipped pointpillar.yaml on the mini-KITTI at ``root``, cut to
    size: 0.32 m pillars (a 216 x 248 grid) of at most 8 points, 2048 of
    them a frame, 16 / 32 filters, NMS over the best 256 anchors."""
    cfg = cfg_from_yaml_file(str(PP_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.32, 0.32, 4]
            proc.MAX_POINTS_PER_VOXEL = 8
            proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    m = cfg.MODEL
    m.VFE.NUM_FILTERS = [16]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[2, 2], NUM_FILTERS=[16, 32],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=32)
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    return yaml.safe_dump(_plain(cfg))


def test_pointpillar_train_then_test_cli(kitti_env, tmp_path, monkeypatch):
    """PointPillar through both CLIs: one epoch (two steps at B = 2) with
    finite losses, then the test CLI on its checkpoint with the official
    evaluation over every val frame."""
    (tmp_path / PP_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / PP_CFG_REL).write_text(_pointpillar_tiny_yaml(kitti_env[0]))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg_file", PP_CFG_REL, "--device", "cpu", "--workers", "0",
                          "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval", "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in lines if r["tag"] == "train/rpn_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", PP_CFG_REL, "--ckpt", str(ckpt), "--device", "cpu",
                            "--workers", "0", "--batch_size", "2"])
    assert "recall/rcnn_0.3" in result and "Car_3d/moderate_R40" in result
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS

SECOND_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "second.yaml"
SECOND_CFG_REL = "cfgs/tiny/second-tiny.yaml"


def _second_tiny_yaml(root):
    """The shipped second.yaml on the mini-KITTI at ``root``, cut to size:
    0.2 x 0.2 x 0.1 m voxels (a 352 x 400 x 40 grid, the reference's z
    ladder) of at most 5 points, 2048 of them a frame, ``NUM_FILTERS [4,
    4, 8, 8, 8]`` and 8 output features, a 16 / 32-filter BEV backbone,
    NMS over the best 256 anchors."""
    cfg = cfg_from_yaml_file(str(SECOND_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.2, 0.2, 0.1]
            proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    m = cfg.MODEL
    m.BACKBONE_3D.update(NUM_FILTERS=[4, 4, 8, 8, 8], NUM_OUTPUT_FEATURES=8)
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[16, 32],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=32)
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    return yaml.safe_dump(_plain(cfg))


def test_second_train_then_test_cli(kitti_env, tmp_path, monkeypatch):
    """SECOND through both CLIs: one epoch (two steps at B = 2, the gt
    sampler and world augmentors of the yaml) with finite losses, then the
    test CLI on its checkpoint with the official evaluation over every val
    frame."""
    (tmp_path / SECOND_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / SECOND_CFG_REL).write_text(_second_tiny_yaml(kitti_env[0]))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg_file", SECOND_CFG_REL, "--device", "cpu", "--workers", "2",
                          "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval", "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in lines if r["tag"] == "train/rpn_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", SECOND_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--workers", "0", "--batch_size", "2"])
    assert "recall/rcnn_0.3" in result and "Car_3d/moderate_R40" in result
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS


VOXEL_RCNN_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "voxel_rcnn_car.yaml"
VOXEL_RCNN_CFG_REL = "cfgs/tiny/voxel_rcnn-tiny.yaml"


def _voxel_rcnn_tiny_yaml(root):
    """The shipped voxel_rcnn_car.yaml on the mini-KITTI at ``root``, cut to
    size as ``_second_tiny_yaml`` cuts second.yaml, and its second stage:
    proposals from the best 256 / 128 anchors (train / test), 16 RoIs a
    frame, a 3 x 3 x 3 RoI grid, 4-channel pools and 16-wide FC stacks."""
    cfg = cfg_from_yaml_file(str(VOXEL_RCNN_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.2, 0.2, 0.1]
            proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    m = cfg.MODEL
    m.BACKBONE_3D.update(NUM_FILTERS=[4, 4, 8, 8, 8], NUM_OUTPUT_FEATURES=8)
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[16, 32],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    roi = m.ROI_HEAD
    roi.update(SHARED_FC=[16, 16], CLS_FC=[16, 16], REG_FC=[16, 16])
    roi.NMS_CONFIG.TRAIN.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=64)
    roi.NMS_CONFIG.TEST.update(NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=32)
    roi.ROI_GRID_POOL.GRID_SIZE = 3
    for layer in roi.ROI_GRID_POOL.POOL_LAYERS.values():
        layer.MLPS = [[4, 4]]
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=32, NMS_POST_MAXSIZE=16)
    return yaml.safe_dump(_plain(cfg))


def test_voxel_rcnn_train_then_test_cli(kitti_env, tmp_path, monkeypatch):
    """Voxel-RCNN through both CLIs: one epoch (two steps at B = 2, the RoI
    sampler and dropout drawing from each frame's generator) with finite
    RPN and RCNN losses, then the test CLI on its checkpoint: the refined
    post-processing, the first-stage ``roi_<t>`` recall beside the
    ``rcnn_<t>``, the official evaluation over every val frame."""
    (tmp_path / VOXEL_RCNN_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / VOXEL_RCNN_CFG_REL).write_text(_voxel_rcnn_tiny_yaml(kitti_env[0]))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg_file", VOXEL_RCNN_CFG_REL, "--device", "cpu", "--workers",
                          "0", "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval",
                          "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    for tag in ("train/rpn_loss", "train/rcnn_loss_cls", "train/rcnn_loss_reg"):
        values = [r["value"] for r in lines if r["tag"] == tag]
        assert len(values) == 2 and all(np.isfinite(values)), (tag, values)
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", VOXEL_RCNN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--workers", "0", "--batch_size", "2"])
    assert {"recall/roi_0.3", "recall/rcnn_0.3", "Car_3d/moderate_R40"} <= set(result)
    log = "".join(p.read_text() for p in (out / "eval" / "epoch_1" / "val" / "default")
                  .glob("log_eval_*.txt"))
    assert "recall_roi_0.3" in log
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS
        assert len(a["score"]) <= 16


CADDN_CFG_REL = "cfgs/tiny/CaDDN-tiny.yaml"


def _caddn_tiny_yaml(root):
    """The shipped CaDDN.yaml on the camera mini-KITTI at ``root``, cut to
    size."""
    from test_torch_caddn import CADDN_YAML

    cfg = cfg_from_yaml_file(str(CADDN_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "calculate_grid_size":
            proc.VOXEL_SIZE = [0.56, 0.47, 0.5]  # an 80 x 128 x 8 grid
    m = cfg.MODEL
    m.VFE.FFN.DDN.WIDTH = 16
    m.VFE.FFN.CHANNEL_REDUCE.update(in_channels=16, out_channels=8)
    m.VFE.FFN.DISCRETIZE.num_bins = 16
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[2, 2], NUM_FILTERS=[16, 32],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=32)
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    return yaml.safe_dump(_plain(cfg))


def test_caddn_train_then_test_cli(tmp_path, monkeypatch):
    """CaDDN through both CLIs on two camera frames: one epoch (one step at
    B = 2, the collate padding the smaller frame) with finite anchor and
    depth losses, then the test CLI on its checkpoint with the official
    evaluation over both val frames; the export CLI refuses the camera
    inputs."""
    from pdanet_tpu_torch.tools import export as export_cli
    from test_torch_caddn import add_camera_inputs

    root = tmp_path / "kitti"
    ids = build_mini_kitti(root, num_frames=2, n_bg=500)
    add_camera_inputs(root, ids, [(375, 1242), (370, 1224)])
    (tmp_path / CADDN_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / CADDN_CFG_REL).write_text(_caddn_tiny_yaml(root))
    monkeypatch.chdir(tmp_path)
    cfg = cfg_from_yaml_file(CADDN_CFG_REL)
    create_kitti_infos(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), root, root, workers=1)
    out = train_cli.main(["--cfg_file", CADDN_CFG_REL, "--device", "cpu", "--workers", "0",
                          "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval", "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    for tag in ("train/rpn_loss", "train/ddn_loss"):
        values = [r["value"] for r in lines if r["tag"] == tag]
        assert len(values) == 1 and all(np.isfinite(values)) and values[0] > 0, (tag, values)
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", CADDN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--workers", "0", "--batch_size", "2"])
    assert {"recall/rcnn_0.3", "Car_3d/moderate_R40"} <= set(result)
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ids
    for a in annos:
        assert set(a) >= KITTI_KEYS
    with pytest.raises(NotImplementedError, match="camera-family CaDDN"):
        export_cli.main(["--cfg_file", CADDN_CFG_REL, "--random_init", "--device", "cpu"])


PV_RCNN_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pv_rcnn.yaml"
PV_RCNN_CFG_REL = "cfgs/tiny/pv_rcnn-tiny.yaml"


def _pv_rcnn_tiny_yaml(root):
    """The shipped pv_rcnn.yaml on the mini-KITTI at ``root``, cut to size
    as ``_voxel_rcnn_tiny_yaml`` cuts voxel_rcnn_car.yaml, with 2048 raw
    points a frame, 128 keypoints, 4-channel pools from every source and
    in the 3 x 3 x 3 RoI grid, 16-wide point head and FC stacks."""
    cfg = cfg_from_yaml_file(str(PV_RCNN_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.2, 0.2, 0.1]
            proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 2048, "test": 2048}
    m = cfg.MODEL
    m.BACKBONE_3D.update(NUM_FILTERS=[4, 4, 8, 8, 8], NUM_OUTPUT_FEATURES=8)
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[16, 32],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    m.PFE.update(NUM_KEYPOINTS=128, NUM_OUTPUT_FEATURES=16)
    for layer in m.PFE.SA_LAYER.values():
        layer.MLPS = [[4, 4], [4, 4]]
    m.POINT_HEAD.CLS_FC = [16]
    roi = m.ROI_HEAD
    roi.update(SHARED_FC=[16, 16], CLS_FC=[16, 16], REG_FC=[16, 16])
    roi.NMS_CONFIG.TRAIN.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=64)
    roi.NMS_CONFIG.TEST.update(NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=32)
    roi.ROI_GRID_POOL.update(GRID_SIZE=3, MLPS=[[4, 4], [4, 4]])
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=32, NMS_POST_MAXSIZE=16)
    return yaml.safe_dump(_plain(cfg))


def test_pv_rcnn_train_test_and_export_cli(kitti_env, tmp_path, monkeypatch):
    """PV-RCNN through the CLIs: one epoch (two steps at B = 2: the raw
    points beside the voxels, the RoI sampler and dropout drawing from each
    frame's generator) with finite RPN, point and RCNN losses; the test
    CLI on its checkpoint (the refined post-processing, ``roi_<t>`` beside
    ``rcnn_<t>``, the official evaluation over every val frame); the export
    CLI on the checkpoint with ``--verify`` (a points-and-voxels program),
    then ``--load`` of the program on the sidecar's inputs; the serve CLI
    refuses the program (it takes point clouds alone)."""
    from pdanet_tpu_torch.tools import export as export_cli
    from pdanet_tpu_torch.tools import serve as serve_cli

    (tmp_path / PV_RCNN_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / PV_RCNN_CFG_REL).write_text(_pv_rcnn_tiny_yaml(kitti_env[0]))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg_file", PV_RCNN_CFG_REL, "--device", "cpu", "--workers", "0",
                          "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval", "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    for tag in ("train/rpn_loss", "train/point_loss_cls", "train/rcnn_loss_cls",
                "train/rcnn_loss_reg"):
        values = [r["value"] for r in lines if r["tag"] == tag]
        assert len(values) == 2 and all(np.isfinite(values)), (tag, values)
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", PV_RCNN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--workers", "0", "--batch_size", "2"])
    assert {"recall/roi_0.3", "recall/rcnn_0.3", "Car_3d/moderate_R40"} <= set(result)
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS and len(a["score"]) <= 16
    path = export_cli.main(["--cfg_file", PV_RCNN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--verify"])
    meta = json.loads(Path(f"{path}.json").read_text())
    assert meta["model"] == "PVRCNN" and meta["inputs"]["points"]["shape"] == [1, 2048, 4]
    assert meta["inputs"]["voxels"]["shape"] == [1, 2048, 5, 4]
    pred = export_cli.main(["--cfg_file", PV_RCNN_CFG_REL, "--device", "cpu", "--load",
                            str(path)])
    assert pred["pred_boxes"].shape == (1, 16, 7)
    with pytest.raises(SystemExit, match="point clouds to a point detector"):
        serve_cli.main(["--artifact", str(path), "--inputs", "*.bin"])


POINTRCNN_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "pointrcnn.yaml"
POINTRCNN_CFG_REL = "cfgs/tiny/pointrcnn-tiny.yaml"


def _pointrcnn_tiny_yaml(root):
    """The shipped pointrcnn.yaml on the mini-KITTI at ``root``, cut to 512
    points a frame, a two-level MSG backbone of 4-8 channels, 16-wide point
    head and FC stacks, 32 pooled points a RoI through SA stages [16, -1],
    proposals at 256 / 128 into 64 / 32 RoIs, 16 sampled."""
    cfg = cfg_from_yaml_file(str(POINTRCNN_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": N_POINTS, "test": N_POINTS}
    m = cfg.MODEL
    m.BACKBONE_3D.SA_CONFIG.update(NPOINTS=[64, 16], RADIUS=[[0.5, 1.0], [1.0, 2.0]],
                                   NSAMPLE=[[8, 8], [8, 8]],
                                   MLPS=[[[4, 8], [4, 8]], [[8, 8], [8, 8]]])
    m.BACKBONE_3D.FP_MLPS = [[16, 16], [16, 16]]
    m.POINT_HEAD.update(CLS_FC=[16], REG_FC=[16])
    roi = m.ROI_HEAD
    roi.update(XYZ_UP_LAYER=[16, 16], CLS_FC=[16], REG_FC=[16])
    roi.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 32
    roi.SA_CONFIG.update(NPOINTS=[16, -1], RADIUS=[0.4, 100], NSAMPLE=[8, 8],
                         MLPS=[[16, 16], [16, 32]])
    roi.NMS_CONFIG.TRAIN.update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=64)
    roi.NMS_CONFIG.TEST.update(NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=32)
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=32, NMS_POST_MAXSIZE=16)
    return yaml.safe_dump(_plain(cfg))


def test_pointrcnn_train_test_export_and_serve_cli(kitti_env, tmp_path, monkeypatch):
    """PointRCNN through the CLIs: one epoch (two steps at B = 2: the RoI
    sampler drawing from each frame's generator) with finite point and RCNN
    losses; the test CLI on its checkpoint (the refined post-processing,
    ``roi_<t>`` beside ``rcnn_<t>``, the official evaluation over every val
    frame); the export CLI on the checkpoint with ``--verify`` (a points
    program); the serve CLI over the mini-KITTI's velodyne files on it, one
    JSON line a file."""
    from pdanet_tpu_torch.tools import export as export_cli
    from pdanet_tpu_torch.tools import serve as serve_cli

    (tmp_path / POINTRCNN_CFG_REL).parent.mkdir(parents=True)
    (tmp_path / POINTRCNN_CFG_REL).write_text(_pointrcnn_tiny_yaml(kitti_env[0]))
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg_file", POINTRCNN_CFG_REL, "--device", "cpu", "--workers", "0",
                          "--batch_size", "2", "--epochs", "1", "--num_epochs_to_eval", "0"])
    lines = [json.loads(line) for line in
             (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    for tag in ("train/point_loss_cls", "train/point_loss_box", "train/rcnn_loss_cls",
                "train/rcnn_loss_reg"):
        values = [r["value"] for r in lines if r["tag"] == tag]
        assert len(values) == 2 and all(np.isfinite(values)), (tag, values)
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", POINTRCNN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--workers", "0", "--batch_size", "2"])
    assert {"recall/roi_0.3", "recall/rcnn_0.3", "Car_3d/moderate_R40"} <= set(result)
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    path = export_cli.main(["--cfg_file", POINTRCNN_CFG_REL, "--ckpt", str(ckpt), "--device",
                            "cpu", "--verify"])
    meta = json.loads(Path(f"{path}.json").read_text())
    assert meta["model"] == "PointRCNN" and list(meta["inputs"]) == ["points"]
    assert meta["inputs"]["points"]["shape"] == [1, N_POINTS, 4]
    bins = sorted((kitti_env[0] / "training" / "velodyne").glob("*.bin"))
    jsonl = tmp_path / "detections.jsonl"
    serve_cli.main(["--artifact", str(path), "--inputs",
                    str(kitti_env[0] / "training" / "velodyne" / "*.bin"), "--out", str(jsonl),
                    "--score_thresh", "0.0"])
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert len(rows) == len(bins) > 0


@pytest.fixture(scope="module")
def jax_checkpoint(kitti_env, tmp_path_factory):
    """The tiny model in the JAX package, flax's initial weights with the
    BatchNorm statistics and biases moved off 0 / 1, saved as a JAX
    checkpoint (optimizer state included)."""
    cfg = JEasyDict(yaml.safe_load(kitti_env[1]))
    jmodel = j_build(cfg.MODEL, num_class=len(CLASSES))
    variables = jax.jit(lambda p: jmodel.init(jax.random.PRNGKey(0), p, train=False))(
        jnp.zeros((1, N_POINTS, 4), jnp.float32))
    rs = np.random.RandomState(3)

    def perturb(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return rs.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        return np.asarray(a)

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))
    tx, _ = j_build_optimizer(cfg.OPTIMIZATION, 2, 1)
    state = j_create_train_state(jmodel, variables, tx)
    path = tmp_path_factory.mktemp("jax_ckpt") / "checkpoint_epoch_7"
    path = j_save_checkpoint(j_checkpoint_state(state, 7, 14), filename=str(path))
    return cfg, jmodel, variables, Path(path)


def test_load_jax_checkpoint(jax_checkpoint, tmp_path):
    """The JAX checkpoint read without jax (optax's state classes turn into
    inert stubs): the variables array for array; a flipped payload byte or
    a file that is no checkpoint raises."""
    from pdanet_tpu_torch.utils.jax_weights import load_jax_checkpoint

    _, _, variables, path = jax_checkpoint
    got = load_jax_checkpoint(path)
    want = jax.tree_util.tree_leaves_with_path(variables)
    assert len(jax.tree_util.tree_leaves(got)) == len(want) > 0
    for (p, w), g in zip(want, jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w, err_msg=str(p))
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    (tmp_path / "flipped.pkl").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum|not a checkpoint"):
        load_jax_checkpoint(tmp_path / "flipped.pkl")
    (tmp_path / "text.pkl").write_text("not a pickle")
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_jax_checkpoint(tmp_path / "text.pkl")


def test_jax_checkpoint_through_the_test_cli_like_jax(kitti_env, jax_checkpoint, workdir):
    """The slice's parity: the JAX package's checkpoint through the port's
    test CLI against JAX's ``eval_one_epoch`` on the same frames."""
    root = kitti_env[0]
    cfg, jmodel, variables, path = jax_checkpoint
    got_result = test_cli.main(["--cfg_file", CFG_REL, "--ckpt", str(path), "--device", "cpu",
                                "--workers", "0", "--batch_size", "1"])
    with open(workdir / "output" / "tiny" / "PDA-SSD-tiny" / "default" / "eval" / "epoch_7"
              / "val" / "default" / "result.pkl", "rb") as f:
        got = pickle.load(f)

    np.random.seed(1024)  # as the test CLI seeds the test split's sampling
    _, j_loader, _ = j_build_dataloader(cfg.DATA_CONFIG, CLASSES, 1, root_path=root,
                                        workers=0, training=False)
    want_result = j_eval_one_epoch(copy.deepcopy(cfg), jmodel, variables, j_loader, 7,
                                   logging.getLogger("test_torch_cli"),
                                   result_dir=workdir / "jax")
    with open(workdir / "jax" / "result.pkl", "rb") as f:
        want = pickle.load(f)

    assert len(got) == len(want) == 4
    box_margin = score_margin = 0.0
    n_boxes = 0
    for a, w in zip(got, want):
        assert a["frame_id"] == w["frame_id"]
        assert len(a["score"]) == len(w["score"]) > 0, a["frame_id"]
        np.testing.assert_array_equal(a["name"], w["name"])
        box_margin = max(box_margin, np.abs(a["boxes_lidar"] - w["boxes_lidar"]).max())
        score_margin = max(score_margin, np.abs(a["score"] - w["score"]).max())
        n_boxes += len(a["score"])
    print(f"{n_boxes} detections over 4 frames: largest |port - JAX| box coordinate "
          f"{box_margin:.3g}, score {score_margin:.3g}")
    assert box_margin <= 2e-3 and score_margin <= 1e-3
    assert list(got_result) == list(want_result)
    for k, w in want_result.items():
        assert got_result[k] == pytest.approx(w, abs=1e-6), k

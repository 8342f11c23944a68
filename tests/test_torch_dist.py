"""Data-parallel training and multi-process evaluation of pdanet_tpu_torch,
on the CPU with Gloo.

* ``tools/scripts/dist_train.sh`` of the port (torchrun, two processes,
  ``--device cpu``) trains the tiny model of ``tests/model_cfg.py`` on the
  mini-KITTI of ``tests/kitti_fixture.py`` (five frames, two a process, so
  that one frame pads the shards) for one epoch and evaluates its
  checkpoint: one checkpoint, written by rank 0; one log, rank 0's; a
  merged ``result.pkl`` holding every frame once, in dataset order.  A
  second run at once beside it (``--fix_random_seed``) writes a bit-equal
  checkpoint and the same detections.  ``dist_test.sh`` on the checkpoint
  merges every frame's detections in dataset order (its point sampling is
  seeded apart from the train CLI's, so its detections are not those of
  the post-train evaluation).
* ``init_dist`` reads torchrun's and Slurm's environments and raises
  without ``RANK``; ``interleave_parts`` and ``merge_results_dist`` on
  simulated ranks, as the JAX package's tests hold its copies.

The global-batch train step against the JAX package is
``tests/test_torch_train.py::test_two_ranks_step_like_jax_float64``; the
PointPillar step of two Gloo ranks (``tests/torch_dist_step.py``) equals
one process on the same two frames in float64 (its BEV BatchNorms take
the global moments over (B, H, W), empty cells included); the SECOND step
of two Gloo ranks whose frames hold different numbers of valid voxels
equals the JAX package's step on the global batch in float64 (the masked
BatchNorms all-reduce their valid-row count with the sum of x); the
Voxel-RCNN step of two Gloo ranks equals one process on the same two
frames in float64, each frame drawing its RoI sample and dropout masks
from its own generator.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from kitti_fixture import build_mini_kitti
from model_cfg import tiny_model_cfg
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from pdanet_tpu_torch.datasets.processor.data_processor import DataProcessor
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.blocks import init_random_weights
from pdanet_tpu_torch.train import build_optimizer_and_schedule, load_checkpoint, make_train_step
from pdanet_tpu_torch.utils import common_utils
from pdanet_tpu_torch.utils.easydict import EasyDict
from test_pointpillar import GRID, PCR, PP_MODEL_CFG, VOXEL

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "pdanet_tpu_torch" / "tools" / "scripts"
KITTI_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
CFG_REL = "cfgs/tiny/PDA-SSD-tiny.yaml"
N_FRAMES = 5  # two processes, two frames a batch: the shards pad one frame
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_plain(v) for v in d]
    return d


@pytest.fixture(scope="module")
def dist_env(tmp_path_factory):
    """A working directory holding the config (the shipped KITTI yaml at
    512 points with the tiny model) over a five-frame mini-KITTI, and the
    environment of the launched processes: one torch thread each."""
    root = tmp_path_factory.mktemp("dist_kitti")
    ids = build_mini_kitti(root, num_frames=N_FRAMES)
    cfg = cfg_from_yaml_file(str(KITTI_YAML))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 512, "test": 512}
    cfg.MODEL = tiny_model_cfg(len(CLASSES))
    create_kitti_infos(cfg.DATA_CONFIG, CLASSES, root, root, workers=1)
    work = tmp_path_factory.mktemp("dist_work")
    (work / CFG_REL).parent.mkdir(parents=True)
    (work / CFG_REL).write_text(yaml.safe_dump(_plain(cfg)))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return work, env, ids


def _launch(script, args, work, env):
    """Start ``script`` on two processes; returns the Popen."""
    return subprocess.Popen(["bash", str(SCRIPTS / script), "2", "--cfg_file", CFG_REL,
                             "--device", "cpu", "--workers", "0", "--batch_size", "2", *args],
                            cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, what, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, f"{what} failed ({proc.returncode}):\n{out[-2000:]}\n{err[-4000:]}"


def _annos(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same_annos(got, want):
    assert [a["frame_id"] for a in got] == [a["frame_id"] for a in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{w['frame_id']} {k}")


def test_dist_train_then_dist_test_two_ranks(dist_env):
    work, env, ids = dist_env
    train_args = ["--epochs", "1", "--num_epochs_to_eval", "1", "--fix_random_seed"]
    runs = {tag: _launch("dist_train.sh", [*train_args, "--extra_tag", tag], work, env)
            for tag in ("first", "rerun")}
    for tag, proc in runs.items():
        _wait(proc, f"dist_train.sh ({tag})")
    out = {tag: work / "output" / "tiny" / "PDA-SSD-tiny" / tag for tag in runs}

    ckpts = sorted((out["first"] / "ckpt").iterdir())
    assert [p.name for p in ckpts] == ["checkpoint_epoch_1.pth"], ckpts
    logs = list(out["first"].glob("log_train_*.txt"))
    assert len(logs) == 1, logs
    log = logs[0].read_text()
    assert "process group: backend gloo, world 2" in log and "global batch 4" in log
    metrics = (out["first"] / "tensorboard" / "metrics.jsonl").read_text().splitlines()
    assert sum('"train/loss"' in line for line in metrics) == 1  # 3 frames a rank: 1 step

    first, rerun = (load_checkpoint(out[t] / "ckpt" / "checkpoint_epoch_1.pth") for t in runs)
    assert first["it"] == rerun["it"] == 1
    for key, val in first["model_state"].items():
        assert torch.equal(rerun["model_state"][key], val), key
    res = {t: out[t] / "eval" / "eval_with_train" / "epoch_1" / "val" / "result.pkl"
           for t in runs}
    merged = _annos(res["first"])
    assert [a["frame_id"] for a in merged] == ids
    _assert_same_annos(_annos(res["rerun"]), merged)
    assert not (res["first"].parent / "tmpdir").exists()

    _wait(_launch("dist_test.sh", ["--ckpt", str(ckpts[0]), "--extra_tag", "first"], work,
                  env), "dist_test.sh")
    res_dir = out["first"] / "eval" / "epoch_1" / "val" / "default"
    tested = _annos(res_dir / "result.pkl")
    assert [a["frame_id"] for a in tested] == ids
    for a in tested:
        assert {"name", "score", "boxes_lidar", "bbox", "location"} <= set(a)
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    logs = list(res_dir.glob("log_eval_*.txt"))
    assert len(logs) == 1 and "process group: backend gloo, world 2" in logs[0].read_text()


@pytest.mark.parametrize("env,want", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
      "MASTER_PORT": "29511"}, (1, 4, 1, "10.0.0.2", 29511)),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "host7:29600"},
     (3, 4, 1, "host7", 29600)),
    ({"RANK": "0", "WORLD_SIZE": "1"}, (0, 1, 0, "127.0.0.1", 18888)),
])
def test_init_dist_reads_torchrun_env(env, want, monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert common_utils._launch_env("pytorch", 18888) == want


def test_init_dist_reads_slurm_env(monkeypatch):
    for k, v in dict(SLURM_PROCID="5", SLURM_NTASKS="8", SLURM_LOCALID="1",
                     SLURM_NODELIST="gpu[012-015],login3").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    assert common_utils._launch_env("slurm", 29500) == (5, 8, 1, "gpu012", 29500)
    monkeypatch.delenv("SLURM_PROCID")
    with pytest.raises(RuntimeError, match="SLURM_PROCID"):
        common_utils._launch_env("slurm", 29500)


@pytest.mark.parametrize("env,match", [
    ({"WORLD_SIZE": "2"}, "needs RANK"),
    ({}, "needs RANK and WORLD_SIZE"),
    ({"RANK": "2", "WORLD_SIZE": "2"}, "out of range"),
])
def test_init_dist_raises_without_rank(env, match, monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        common_utils.init_dist("pytorch")
    assert not torch.distributed.is_initialized()


def test_merge_results_dist_simulated_world3(tmp_path):
    """Simulated 3-process eval merge (``tests/test_train.py::
    test_merge_results_dist_simulated_world3`` for the JAX package's
    copy): stride-sharded parts interleave back into dataset order and
    ranks other than 0 return None."""
    size = 8
    padded = [f"s{i}" for i in range(size)] + ["s0"]  # pad to 9 = 3 * 3
    parts = {r: [padded[i] for i in range(r, 9, 3)] for r in range(3)}
    barriers = []
    out = {}
    for r in (1, 2, 0):  # ranks 1, 2 write first; rank 0 merges
        out[r] = common_utils.merge_results_dist(parts[r], size, str(tmp_path / "merge"),
                                                 rank=r, world=3,
                                                 barrier=lambda: barriers.append(1))
    assert out[1] is None and out[2] is None
    assert out[0] == [f"s{i}" for i in range(size)]
    assert len(barriers) == 3 and not (tmp_path / "merge").exists()


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_interleave_parts_inverts_the_loader_shards(world):
    """``interleave_parts`` undoes ``SimpleLoader``'s pad + stride shard of
    an eval split, whatever the world size."""
    from pdanet_tpu_torch.datasets import SimpleLoader

    class Frames:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    n = 7
    parts = [[i for chunk in SimpleLoader(Frames(n), 2, shuffle=False, rank=r,
                                          world=world)._sample_plan() for i in chunk]
             for r in range(world)]
    assert common_utils.interleave_parts(parts, n) == list(range(n))


def _pp_frames(seed=3, n_frames=2):
    """Voxelized frames of the tiny PointPillar grid (300 uniform points
    and four dense clusters each) with a Car and a Pedestrian of gt."""
    rs = np.random.RandomState(seed)
    dp = DataProcessor([EasyDict(NAME="transform_points_to_voxels", VOXEL_SIZE=VOXEL,
                                 MAX_POINTS_PER_VOXEL=8,
                                 MAX_NUMBER_OF_VOXELS={"train": 512, "test": 512})],
                       point_cloud_range=np.asarray(PCR), training=False,
                       num_point_features=4)
    frames = []
    for _ in range(n_frames):
        xyz = rs.uniform([0, -12.8, -3], [25.6, 12.8, 1], (300, 3))
        for c in rs.uniform([2, -10, -2], [23, 10, 0], (4, 3)):
            xyz = np.concatenate([xyz, c + rs.uniform(-0.3, 0.3, (40, 3))])
        pts = np.concatenate([xyz, rs.rand(len(xyz), 1)], axis=1).astype(np.float32)
        dd = dp.forward({"points": pts})
        dd["gt_boxes"] = np.array([[*rs.uniform([4, -8], [20, 8]), -1.0, 3.9, 1.6, 1.56,
                                    rs.uniform(-1, 1), 1],
                                   [*rs.uniform([4, -8], [20, 8]), -0.6, 0.8, 0.6, 1.73,
                                    rs.uniform(-1, 1), 2]], np.float32)
        frames.append(dd)
    batch = DatasetTemplate.collate_batch_static(frames)
    return {k: batch[k] for k in ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")}


def test_pointpillar_two_ranks_step_like_one_process_float64(tmp_path):
    """Two Gloo processes take one frame each of a two-frame batch of the
    tiny PointPillar (``tests/test_pointpillar.py``'s config) from the same
    seeded weights, against one process on both frames, in float64: loss
    and tb scalars (the global batch's) within 1e-9 relative, every
    gradient leaf (summed over the ranks) within 1e-9 of its largest
    |gradient|, the BatchNorm running statistics within 1e-12, and the two
    ranks' state bit-equal."""
    cfg = EasyDict(PP_MODEL_CFG)
    build = dict(grid_size=GRID, voxel_size=tuple(VOXEL), point_cloud_range=tuple(PCR),
                 class_names=("Car", "Pedestrian"))
    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    model = init_random_weights(build_network(cfg, 2, device="cpu", **build), seed=5).double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _pp_frames()
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=cfg, num_class=2, build=build, state=state, optim_cfg=optim_cfg,
                         schedule=(4, 2), dtype=torch.float64,
                         ranks=[dict(batch={k: v[r:r + 1] for k, v in batch.items()})
                                for r in range(2)]), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]

    # one process on both frames, while the ranks run
    optimizer, schedule = build_optimizer_and_schedule(model, optim_cfg, 4, 2)
    loss, tb = make_train_step(model, optimizer, schedule)(
        {k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in batch.items()})
    assert tb["rpn_loss_loc"] > 0  # the gt has positives
    want_grads = {n: p.grad for n, p in model.named_parameters()}

    for r, proc in enumerate(procs):
        _wait(proc, f"rank {r}", timeout=300)
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key
    res = got[0]
    assert abs(res["loss"].item() - loss.item()) <= 1e-9 * abs(loss.item())
    for k, w in tb.items():
        assert abs(float(res["tb"][k]) - float(w)) <= 1e-9 * max(abs(float(w)), 1e-6), k
    worst = max((res["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for n, g in want_grads.items())
    assert worst <= 1e-9, worst
    for name, buf in model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(res["state"][name], buf, rtol=0, atol=1e-12)


def test_second_two_ranks_step_like_jax_float64(tmp_path):
    """Two Gloo processes take one frame each of the tiny SECOND's
    two-frame batch (``tests/test_torch_second.py``; 198 and 168 valid
    voxels, so each rank's masked BatchNorms count their own rows), from
    the JAX package's weights, against JAX's step on the global batch in
    float64: the loss and tb scalars within 1e-9 relative, every gradient
    leaf (summed over the ranks) within 1e-9 of its largest |gradient|, the
    running statistics within 1e-9 (JAX's Bessel factor is float32), and
    the two ranks' state bit-equal."""
    from test_torch_second import CLASSES as S_CLASSES
    from test_torch_second import GEOMETRY as S_GEOMETRY
    from test_torch_second import (_gt, jax_f64_step, jax_second, jax_variables, make_batch,
                                   second_cfg)

    batch = make_batch()
    gt = _gt()
    counts = (batch["voxel_coords"][..., 0] >= 0).sum(axis=1)
    assert counts[0] != counts[1]
    jmodel = jax_second()
    want = jax_f64_step(jmodel, jax_variables(jmodel, batch), batch, gt)
    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=EasyDict(second_cfg()), num_class=len(S_CLASSES),
                         build=dict(S_GEOMETRY), variables=want["variables"],
                         optim_cfg=optim_cfg, schedule=(4, 2), dtype=torch.float64,
                         ranks=[dict(batch={**{k: v[r:r + 1] for k, v in batch.items()},
                                            "gt_boxes": gt[r:r + 1]})
                                for r in range(2)]), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for r, proc in enumerate(procs):
        _wait(proc, f"rank {r}", timeout=300)
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key
    res = got[0]
    assert abs(res["loss"].item() - want["loss"]) <= 1e-9 * abs(want["loss"])
    assert want["tb"]["rpn_loss_loc"] > 0
    for k, w in want["tb"].items():
        assert abs(float(res["tb"][k]) - w) <= 1e-9 * max(abs(w), 1e-6), k
    model = build_network(EasyDict(second_cfg()), len(S_CLASSES), device="cpu",
                          **S_GEOMETRY).double()
    from pdanet_tpu_torch.utils.jax_weights import load_jax_variables

    load_jax_variables(model, {"params": want["grads"],
                               "batch_stats": want["variables"]["batch_stats"]})
    worst = max(((res["grads"][n] - g).abs().max().item() / g.abs().max().item(), n)
                for n, g in model.named_parameters())
    assert worst[0] <= 1e-9, worst
    load_jax_variables(model, {"params": want["variables"]["params"],
                               "batch_stats": want["stats"]})
    for name, buf in model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(res["state"][name], buf, rtol=0, atol=1e-9)


def test_voxel_rcnn_two_ranks_step_like_one_process_float64(tmp_path):
    """Two Gloo processes take one frame each of the tiny Voxel-RCNN's
    two-frame batch (``tests/test_torch_voxel_rcnn.py``; 138 and 116 valid
    voxels, so each rank's masked BatchNorms count their own rows) from the
    same seeded weights, against one process on both frames, in float64:
    each frame draws its RoI sample and dropout masks from its own
    generator (seed, step, index in the global batch), so the ranks draw
    what the one process draws.  The loss and tb scalars (the RCNN losses'
    counts global) within 1e-9 relative, every gradient leaf (summed over
    the ranks) within 1e-9 of its largest |gradient|, the BatchNorm
    running statistics within 1e-12, the two ranks' state bit-equal."""
    from test_torch_voxel_rcnn import GEOMETRY as V_GEOMETRY
    from test_torch_voxel_rcnn import gt_near_train_rois, make_batch, vrcnn_cfg

    cfg = EasyDict(vrcnn_cfg())
    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    model = init_random_weights(build_network(cfg, 2, device="cpu", **V_GEOMETRY),
                                seed=5).double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch()
    batch["gt_boxes"] = gt_near_train_rois(model, batch)
    counts = (batch["voxel_num_points"] > 0).sum(axis=1)
    assert counts[0] != counts[1]
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=cfg, num_class=2, build=dict(V_GEOMETRY), state=state,
                         optim_cfg=optim_cfg, schedule=(4, 2), dtype=torch.float64,
                         ranks=[dict(batch={k: v[r:r + 1] for k, v in batch.items()})
                                for r in range(2)]), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]

    optimizer, schedule = build_optimizer_and_schedule(model, optim_cfg, 4, 2)
    loss, tb = make_train_step(model, optimizer, schedule)(
        {k: torch.from_numpy(v).double() if v.dtype.kind == "f" else torch.from_numpy(v)
         for k, v in batch.items()})
    assert tb["rcnn_loss_corner"] > 0 and tb["rpn_loss_loc"] > 0
    want_grads = {n: p.grad for n, p in model.named_parameters()}

    for r, proc in enumerate(procs):
        _wait(proc, f"rank {r}", timeout=300)
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key
    res = got[0]
    assert abs(res["loss"].item() - loss.item()) <= 1e-9 * abs(loss.item())
    for k, w in tb.items():
        assert abs(float(res["tb"][k]) - float(w)) <= 1e-9 * max(abs(float(w)), 1e-6), k
    worst = max(((res["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                for n, g in want_grads.items())
    assert worst[0] <= 1e-9, worst
    for name, buf in model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(res["state"][name], buf, rtol=0, atol=1e-12)


def test_pvrcnn_two_ranks_step_like_one_process_float64(tmp_path):
    """Two Gloo processes take one frame each of the tiny PV-RCNN's
    two-frame batch (``tests/test_torch_pvrcnn.py``, the sparse backbone;
    140 and 118 valid voxels, 256 raw points a frame) from the same seeded
    weights, against one process on both frames, in float64: the RoI
    sample and dropout masks drawn from each frame's generator, the point
    loss normalized by the global batch's positives.  The loss and tb
    scalars within 1e-9 relative, every gradient leaf (summed over the
    ranks) within 1e-9 of its largest |gradient|, the BatchNorm running
    statistics within 1e-12, the two ranks' state bit-equal."""
    from test_torch_pvrcnn import GEOMETRY as PV_GEOMETRY
    from test_torch_pvrcnn import gt_near_train_rois, make_batch, pv_cfg

    cfg = EasyDict(pv_cfg())
    optim_cfg = EasyDict(dict(OPTIMIZER="adam_onecycle", LR=0.01, WEIGHT_DECAY=0.01,
                              MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
                              GRAD_NORM_CLIP=10))
    model = init_random_weights(build_network(cfg, 2, device="cpu", **PV_GEOMETRY),
                                seed=5).double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch()
    batch["gt_boxes"] = gt_near_train_rois(model, batch)
    spec = tmp_path / "spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(dict(cfg=cfg, num_class=2, build=dict(PV_GEOMETRY), state=state,
                         optim_cfg=optim_cfg, schedule=(4, 2), dtype=torch.float64,
                         ranks=[dict(batch={k: v[r:r + 1] for k, v in batch.items()})
                                for r in range(2)]), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_step.py"),
                               str(spec), str(r), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]

    optimizer, schedule = build_optimizer_and_schedule(model, optim_cfg, 4, 2)
    loss, tb = make_train_step(model, optimizer, schedule)(
        {k: torch.from_numpy(v).double() if v.dtype.kind == "f" else torch.from_numpy(v)
         for k, v in batch.items()})
    assert tb["rcnn_loss_corner"] > 0 and tb["point_pos_num"] > 0
    want_grads = {n: p.grad for n, p in model.named_parameters()}

    for r, proc in enumerate(procs):
        _wait(proc, f"rank {r}", timeout=300)
    got = [torch.load(f"{spec}.rank{r}.pt", weights_only=False) for r in range(2)]
    for key, val in got[0]["state"].items():
        assert torch.equal(got[1]["state"][key], val), key
    res = got[0]
    assert abs(res["loss"].item() - loss.item()) <= 1e-9 * abs(loss.item())
    for k, w in tb.items():
        assert abs(float(res["tb"][k]) - float(w)) <= 1e-9 * max(abs(float(w)), 1e-6), k
    worst = max(((res["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                for n, g in want_grads.items())
    assert worst[0] <= 1e-9, worst
    for name, buf in model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(res["state"][name], buf, rtol=0, atol=1e-12)

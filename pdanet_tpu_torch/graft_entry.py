"""Entry points of the port: counterpart of ``__graft_entry__.py``.

``entry(device=None)`` -> ``(fn, args)``: the flagship PDA-SSD of
``tools/cfgs/kitti_models/PDA-SSD.yaml`` at full width, seeded weights, in
eval mode; ``fn(*args)`` is a pure function of the model's state and one
x-sorted (1, 16384, 4) cloud and gives ``(batch_cls_preds,
batch_box_preds)``.

``dryrun_multichip(n)`` starts ``n`` ranks of a ``torch.distributed``
group (Gloo on the CPU or on one card the ranks share, NCCL with a card a
rank; the ``spawn`` start method) and runs, in order, each part printing
its line:

(a) one data-parallel train step of the tiny config at B = n, N 256, two
    planted boxes a frame, against one process on the same global batch;
(b) a checkpoint saved by rank 0, two more steps on the original (the
    direct result), then a fresh model, optimizer and group restored from
    the checkpoint: the model's and the optimizer's state (Adam's moments,
    the update count) equal to what was saved, and two steps, each loss
    held to the direct run's (a step's loss is taken before its update, so
    the second reads the first update);
(c) the same checkpoint and global batch on max(1, n // 2) ranks, each a
    contiguous slice of the batch, held to the direct run in the same way;
(d) each rank's frames through the eval-mode model and the IASSD
    post-processing, gathered by ``merge_results_dist`` over the group,
    against one process on all frames; then ``merge_results_dist`` over
    min(4, max(2, n // 2)) simulated ranks, rank 0 merging last, which
    must restore dataset order;
(e) one data-parallel step of a tiny two-stage Voxel-RCNN (MeanVFE, the
    sparse backbone with ``ACTIVE_BUDGETS``, the RoI grid pool) on seeded
    random voxels, its RoI sampler and dropout drawing from the per-frame
    generators, against one process on the same global batch: the draws
    agree only where ``rank * B + i`` names the same frame;
(f) unless ``PDANET_DRYRUN_SKIP_FULL=1``: one train step at the shipped
    yamls' full shapes, KITTI B = n x 16384 and ONCE B = 2n x 60000, each
    rank's peak device memory printed.

Parts (a)-(e) run in ``dtype`` with the yaml's bfloat16 compute dropped,
so that each gap measures reduction order alone; (f) runs the yamls as
shipped.  Randomness comes from numpy seeds and
``torch.Generator`` s only.

    python -m pdanet_tpu_torch.graft_entry                 # entry() on the card
    python -m pdanet_tpu_torch.graft_entry dryrun 2        # two ranks
    python -m pdanet_tpu_torch.graft_entry dryrun 2 --device cpu --dtype float64
"""

import copy
import json
import os
import shutil
import socket
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import cfg_from_yaml_file
from .utils.easydict import EasyDict

REPO = Path(__file__).resolve().parent.parent
KITTI_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
ONCE_YAML = REPO / "tools" / "cfgs" / "once_models" / "PDA-SSD.yaml"
ENTRY_SEED = 0  # the seeded weights and cloud of entry()
DRYRUN_SEED = 0  # the dryrun's weights and batches; fresh models take DRYRUN_SEED + 1
# relative bounds of the dryrun: the resumed steps against the direct ones,
# and n ranks or half of them against one process on the same global batch.
# float32: the JAX function's 1e-5 for the resume (__graft_entry__.py:162);
# its 3e-3 for the world (:194) was set for bfloat16 compute, which (a)-(e)
# drop: their float32 world gaps read up to 5.1e-6 on an H100 (the second
# step of (c), after a backward whose atomic sums vary run to run), so
# 5e-5.  float64: rounding
TOLERANCES = {torch.float32: dict(resume=1e-5, world=5e-5),
              torch.float64: dict(resume=1e-12, world=1e-10)}
# (d): counts equal, and more than this share of box entries within
# rtol 1e-3 / atol 1e-4 of one process's (__graft_entry__.py:250-257)
EVAL_BOX_SHARE = 0.95


def part_labels(n, full=True):
    """The words that open each part's line of ``dryrun_multichip(n)``,
    by part, (f)'s two steps only with ``full``."""
    labels = {"a": "one DP training step OK",
              "b": "checkpoint save/restore into a fresh group OK",
              "c": f"restore into a {max(1, n // 2)}-rank group OK",
              "d": f"sharded eval + NMS over {n} ranks",
              "e": "voxel-family two-stage (sparse Voxel-RCNN) DP step OK"}
    if n < 2:
        del labels["c"]
    if full:
        labels["f-kitti"] = f"full-shape (B={n}, N=16384) train step ran"
        labels["f-once"] = f"ONCE-shape (B={2 * n}, N=60000) train step ran"
    return labels


def _load_cfg(tiny=False):
    """The KITTI PDA-SSD yaml; with ``tiny`` the dryrun's SA and head
    widths (``__graft_entry__.py:16-40``)."""
    cfg = cfg_from_yaml_file(str(KITTI_YAML), EasyDict())
    if tiny:
        sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
        sa.NPOINT_LIST = [[64], [32], [16], [8], [-1], [8]]
        sa.NSAMPLE_LIST = [[4, 8], [4, 8], [4, 8], [], [], [4, 8]]
        sa.MLPS = [
            [[8, 8, 16], [8, 8, 16]],
            [[16, 16, 32], [16, 24, 32]],
            [[32, 32, 64], [32, 32, 64]],
            [],
            [32],
            [[64, 64, 128], [64, 64, 128]],
        ]
        sa.AGGREGATION_MLPS = [[16], [32], [64], [64], [], [128]]
        sa.CONFIDENCE_MLPS = [[], [32], [64], [], [], []]
        cfg.MODEL.POINT_HEAD.CLS_FC = [32, 32]
        cfg.MODEL.POINT_HEAD.REG_FC = [32, 32]
    return cfg


def _sorted_cloud(generator, B, N, scale):
    """(B, N, 4) normal points times ``scale``, x-sorted as the pipeline's
    ``sort_points`` emits them (the ball query's tile skip relies on it)."""
    points = torch.randn((B, N, 4), generator=generator) * scale
    order = torch.argsort(points[..., 0], dim=1, stable=True)
    return torch.take_along_dim(points, order[..., None], dim=1)


def entry(device=None):
    """``(fn, args)``: the full-width PDA-SSD forward of the KITTI yaml at
    eval, seeded weights (``ENTRY_SEED``), on the card unless ``device``
    says otherwise.  ``args`` is (the model's state: parameters and
    buffers, a (1, 16384, 4) x-sorted cloud), both on the device;
    ``fn(state, points)`` calls the model on them through
    ``torch.func.functional_call`` and returns ``(batch_cls_preds,
    batch_box_preds)``."""
    from .models import build_network
    from .models.blocks import init_random_weights

    cfg = _load_cfg()
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), input_channels=4,
                          device=device)
    init_random_weights(model, ENTRY_SEED).eval()
    device = next(model.parameters()).device
    points = _sorted_cloud(torch.Generator().manual_seed(ENTRY_SEED), 1, 16384, 10.0)

    def forward(state, points):
        out = torch.func.functional_call(model, state, (points,))
        return out["batch_cls_preds"], out["batch_box_preds"]

    return forward, (dict(model.state_dict()), points.to(device))


# ---------------------------------------------------------------- dryrun

def _train_cfg(dtype):
    """The tiny config with the yaml's bfloat16 compute dropped, so that the
    model computes in its parameters' dtype."""
    cfg = _load_cfg(tiny=True)
    for key in ("COMPUTE_DTYPE", "TRAIN_COMPUTE_DTYPE"):
        cfg.MODEL.BACKBONE_3D.pop(key, None)
    return cfg


def _point_batch(B, N, dtype):
    """``__graft_entry__.py:101-106``'s batch: B frames of N normal points
    times 5 and the two planted boxes, a car and a pedestrian."""
    rs = np.random.RandomState(DRYRUN_SEED)
    points = rs.standard_normal((B, N, 4)).astype(np.float32) * 5.0
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, 0] = [5.0, 1.0, 0.0, 3.9, 1.6, 1.56, 0.3, 1.0]
    gt[:, 1] = [-3.0, 2.0, 0.0, 0.8, 0.6, 1.73, -0.5, 2.0]
    return {"points": torch.from_numpy(points).to(dtype), "gt_boxes": torch.from_numpy(gt).to(dtype)}


VOXEL_RCNN_CFG = {  # __graft_entry__.py:296-368
    "NAME": "VoxelRCNN",
    "VFE": {"NAME": "MeanVFE"},
    "BACKBONE_3D": {"NAME": "SparseVoxelBackBone8x", "NUM_FILTERS": [4, 4, 8, 8, 8],
                    "NUM_OUTPUT_FEATURES": 8, "ACTIVE_BUDGETS": [64, 64, 64, 64]},
    "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 8},
    "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                    "NUM_FILTERS": [8], "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [8]},
    "DENSE_HEAD": {
        "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
        "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
        "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
        "ANCHOR_GENERATOR_CONFIG": [
            {"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
             "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
             "align_center": False, "feature_map_stride": 8, "matched_threshold": 0.6,
             "unmatched_threshold": 0.45},
        ],
        "TARGET_ASSIGNER_CONFIG": {
            "NAME": "AxisAlignedTargetAssigner", "POS_FRACTION": -1.0, "SAMPLE_SIZE": 512,
            "NORM_BY_NUM_EXAMPLES": False, "MATCH_HEIGHT": False,
            "BOX_CODER": "ResidualCoder"},
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {
            "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
            "code_weights": [1.0] * 7}},
    },
    "POST_PROCESSING": {
        "SCORE_THRESH": 0.3,
        "NMS_CONFIG": {"NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 16, "NMS_POST_MAXSIZE": 8},
    },
    "ROI_HEAD": {
        "NAME": "VoxelRCNNHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": [16, 16], "CLS_FC": [8], "REG_FC": [8], "DP_RATIO": 0.3,
        "NMS_CONFIG": {
            "TRAIN": {"NMS_PRE_MAXSIZE": 32, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.8},
            "TEST": {"NMS_PRE_MAXSIZE": 32, "NMS_POST_MAXSIZE": 8, "NMS_THRESH": 0.7},
        },
        "ROI_GRID_POOL": {
            "FEATURES_SOURCE": ["x_conv3", "x_conv4"], "PRE_MLP": True, "GRID_SIZE": 2,
            "POOL_LAYERS": {
                "x_conv3": {"MLPS": [[4, 4]], "QUERY_RANGES": [[2, 2, 2]],
                            "POOL_RADIUS": [1.6], "NSAMPLE": [8], "POOL_METHOD": "max_pool"},
                "x_conv4": {"MLPS": [[4, 4]], "QUERY_RANGES": [[2, 2, 2]],
                            "POOL_RADIUS": [3.2], "NSAMPLE": [8], "POOL_METHOD": "max_pool"},
            },
        },
        "TARGET_CONFIG": {
            "BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 8, "FG_RATIO": 0.5,
            "SAMPLE_ROI_BY_EACH_CLASS": True, "CLS_SCORE_TYPE": "roi_iou",
            "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
            "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55,
        },
        "LOSS_CONFIG": {
            "CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
            "CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7},
        },
    },
}
VOXEL_GRID = dict(grid_size=(32, 32, 8), voxel_size=(0.2, 0.2, 0.5),
                  point_cloud_range=(0, -3.2, -3, 6.4, 3.2, 1), class_names=("Car",))


def _voxel_batch(B, dtype, V=64, P=5):
    """B frames of V voxels of up to P uniform points on V distinct cells of
    the (z 8, y 32, x 32) grid, and one planted car a frame."""
    rs = np.random.RandomState(DRYRUN_SEED + 2)
    cells = np.stack([rs.choice(8 * 32 * 32, V, replace=False) for _ in range(B)])
    coords = np.stack([cells // 1024, cells // 32 % 32, cells % 32], -1).astype(np.int32)
    nums = rs.randint(1, P + 1, (B, V)).astype(np.int32)
    voxels = rs.uniform(size=(B, V, P, 4)).astype(np.float32)
    voxels *= (np.arange(P)[None, None, :, None] < nums[..., None, None])
    gt = np.zeros((B, 2, 8), np.float32)
    gt[:, 0] = [3.0, 0.5, -0.8, 3.9, 1.6, 1.56, 0.3, 1.0]
    return {"voxels": torch.from_numpy(voxels).to(dtype), "voxel_coords": torch.from_numpy(coords),
            "voxel_num_points": torch.from_numpy(nums), "gt_boxes": torch.from_numpy(gt).to(dtype)}


def _lidar_batch(B, N, seed):
    """B LiDAR-like x-sorted frames of N points (``tools/profiler``'s
    generator) and (B, 64, 8) gt: a car-sized box on each of the 12
    clusters."""
    from .tools.profiler import lidar_like_cloud

    points, centers = lidar_like_cloud(seed, B, N, with_centers=True)
    gt = np.zeros((B, 64, 8), np.float32)
    gt[:, :len(centers), 0:3] = centers
    gt[:, :len(centers), 3:8] = [3.9, 1.6, 1.56, 0.0, 1.0]
    return {"points": torch.from_numpy(np.ascontiguousarray(points, np.float32)),
            "gt_boxes": torch.from_numpy(gt)}


def _on(batch, dev, frames=slice(None)):
    return {k: v[frames].to(dev) for k, v in batch.items()}


def _model(cfg_model, num_class, dev, dtype, seed, **grid):
    from .models import build_network
    from .models.blocks import init_random_weights

    model = build_network(cfg_model, num_class=num_class, input_channels=4, device=dev, **grid)
    return init_random_weights(model, seed).to(dtype)


def _trainer(cfg, model):
    """The yaml's optimizer and schedule over 10 iterations of 2 epochs
    (``__graft_entry__.py:117``) and the port's train step."""
    from .train import build_optimizer_and_schedule, make_train_step

    optimizer, schedule = build_optimizer_and_schedule(model, cfg.OPTIMIZATION, 10, 2)
    return optimizer, make_train_step(model, optimizer, schedule)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


def _snapshot(model, optimizer):
    """Copies of the model's and the optimizer's state dicts."""
    return copy.deepcopy((model.state_dict(), optimizer.state_dict()))


def _same(a, b):
    """``a`` and ``b`` (nested dicts, lists and tensors) equal, tensors bit
    for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


class _Group:
    """The process groups of one rank, made and left in turn, each at its own
    ``tcp://127.0.0.1`` port; a rank outside a group's world skips it."""

    def __init__(self, rank, ports, backend, dev):
        self.rank, self.ports, self.backend, self.dev = rank, list(ports), backend, dev

    def join(self, world):
        port = self.ports.pop(0)
        if self.rank >= world:
            return False
        dist.init_process_group(self.backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=self.rank, world_size=world,
                                **({"device_id": self.dev} if self.backend == "nccl" else {}))
        return True

    @staticmethod
    def leave():
        dist.destroy_process_group()


def _say(n, text):
    print(f"dryrun_multichip({n}): {text}", flush=True)


def _rank_main(rank, n, dtype_name, device, backend, ports, work, threads, skip_full):
    """One rank of :func:`dryrun_multichip`: parts (a)-(f) in order.  Rank 0
    checks each part, prints its line and writes the results to
    ``work/result.json``; every rank writes its kernel launches to
    ``work/launches<rank>.json``."""
    from . import parallel
    from .models.detectors.iassd import post_processing
    from .ops import cuda_lib
    from .train import checkpoint_state, load_checkpoint, restore_from_checkpoint, save_checkpoint
    from .utils.common_utils import merge_results_dist

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    dev = torch.device(device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        cuda_lib.lib()
    tol = TOLERANCES[dtype]
    label = part_labels(n, full=not skip_full)
    groups = _Group(rank, ports, backend, dev)
    work = Path(work)
    res = {}
    cfg = _train_cfg(dtype)
    num_class = len(cfg.CLASS_NAMES)
    B = n
    batch = _point_batch(B, 256, dtype)

    # (a) one data-parallel step; one process on the whole batch first
    if rank == 0:
        model = _model(cfg.MODEL, num_class, dev, dtype, DRYRUN_SEED)
        res["loss_one"] = float(_trainer(cfg, model)[1](_on(batch, dev))[0])
        del model
    groups.join(n)
    model = _model(cfg.MODEL, num_class, dev, dtype, DRYRUN_SEED)
    parallel.broadcast_module(model)
    optimizer, step = _trainer(cfg, model)
    mine = slice(rank, rank + 1)
    res["loss"] = float(step(_on(batch, dev, mine))[0])
    if rank == 0:
        gap = _rel(res["loss"], res["loss_one"])
        assert np.isfinite(res["loss"]), f"non-finite loss {res['loss']}"
        assert gap <= tol["world"], (
            f"{n} ranks' step {res['loss']!r} against one process {res['loss_one']!r}")
        _say(n, f"{label['a']}, loss={res['loss']:.4f} (one process "
                f"{res['loss_one']:.4f}, relative gap {gap:.3g})")

    # (b) checkpoint save and resume: the update count (the learning rate,
    # Adam's b1, the frame generators) travels in the optimizer's state.
    # A step's loss is taken before its update, so the restored state is
    # held to the saved one and the second step's loss is held too
    ck = work / "checkpoint_epoch_1.pth"
    if rank == 0:
        save_checkpoint(checkpoint_state(model, optimizer, 1, 1), ck)
    parallel.barrier()
    saved, saved_count = _snapshot(model, optimizer), optimizer.count
    res["loss_direct"] = float(step(_on(batch, dev, mine))[0])
    res["loss_direct_next"] = float(step(_on(batch, dev, mine))[0])
    eval_model = model.eval()
    groups.leave()

    def resume(frames, key):
        """A fresh model and optimizer restored from the checkpoint, then
        two steps on ``frames``: whether the restored state equals the
        saved one, the update count and the two losses under ``key``."""
        fresh = _model(cfg.MODEL, num_class, dev, dtype, DRYRUN_SEED + 1)
        fresh_opt, fresh_step = _trainer(cfg, fresh)
        restore_from_checkpoint(load_checkpoint(ck), fresh, fresh_opt)
        res[f"restored_{key}"] = _same(_snapshot(fresh, fresh_opt), saved)
        res[f"count_{key}"] = fresh_opt.count
        res[f"loss_{key}"] = float(fresh_step(_on(batch, dev, frames))[0])
        res[f"loss_{key}_next"] = float(fresh_step(_on(batch, dev, frames))[0])

    def held(key, bound, what):
        """Rank 0: the saved state and update count restored exactly, the
        part's two losses within ``bound`` of the direct run's; returns
        the two gaps."""
        assert res[f"restored_{key}"], f"{what}: the restored state differs from the saved one"
        assert res[f"count_{key}"] == saved_count == 1, (
            f"update count {res[f'count_{key}']} restored, {saved_count} saved")
        gaps = (_rel(res[f"loss_{key}"], res["loss_direct"]),
                _rel(res[f"loss_{key}_next"], res["loss_direct_next"]))
        assert np.isfinite([res[f"loss_{key}"], res[f"loss_{key}_next"]]).all()
        assert max(gaps) <= bound, (
            f"{what} broke continuity: step-2 loss {res[f'loss_{key}']!r} against direct "
            f"{res['loss_direct']!r}, step-3 loss {res[f'loss_{key}_next']!r} against "
            f"{res['loss_direct_next']!r}")
        return gaps

    groups.join(n)
    resume(mine, "resumed")
    groups.leave()
    if rank == 0:
        gaps = held("resumed", tol["resume"], "resume")
        _say(n, f"{label['b']} (state restored bit-equal; step-2 loss "
                f"{res['loss_resumed']:.4f} == direct, relative gap {gaps[0]:.3g}; step 3 "
                f"{gaps[1]:.3g})")

    # (c) restore into half the world: contiguous slices keep rank * B + i
    # naming the same frame of the global batch
    half = max(1, n // 2)
    if n >= 2 and groups.join(half):
        frames = np.array_split(np.arange(B), half)[rank]
        resume(slice(frames[0], frames[-1] + 1), "half")
        groups.leave()
        if rank == 0:
            gaps = held("half", tol["world"], f"restore into world={half}")
            _say(n, f"{label['c']} (state restored bit-equal; loss {res['loss_half']:.4f} "
                    f"~= direct {res['loss_direct']:.4f}, relative gap {gaps[0]:.3g}; step 3 "
                    f"{gaps[1]:.3g})")

    # (d) sharded eval, gathered by merge_results_dist over the group, then
    # one process on every frame
    def serve(frames):
        with torch.inference_mode():
            out = eval_model(batch["points"][frames].to(dev))
            pp = post_processing(out["batch_cls_preds"], out["batch_box_preds"],
                                 cfg.MODEL.POST_PROCESSING)
        return [{"frame_id": int(i), **{k: v[j].cpu().numpy() for k, v in pp.items()}}
                for j, i in enumerate(frames)]

    groups.join(n)
    mine_eval = list(range(rank, B, n))
    gathered = merge_results_dist(serve(mine_eval), B, str(work / "eval_parts"))
    groups.leave()
    if rank == 0:
        one = serve(list(range(B)))
        assert [f["frame_id"] for f in gathered] == list(range(B)), "eval gather order"
        counts = np.array([f["pred_counts"] for f in gathered])
        counts_one = np.array([f["pred_counts"] for f in one])
        np.testing.assert_array_equal(counts, counts_one)
        close = np.isclose(np.stack([f["pred_boxes"] for f in gathered]),
                           np.stack([f["pred_boxes"] for f in one]), rtol=1e-3, atol=1e-4)
        res["counts"], res["box_share"] = counts.tolist(), float(close.mean())
        assert res["box_share"] > EVAL_BOX_SHARE, (
            f"sharded-vs-single eval boxes: {res['box_share']:.3f} close")
        # per-frame dicts stride-sharded over simulated ranks, rank 0 last
        world = min(4, max(2, n // 2))
        pad = one + one[: (-len(one)) % world]
        parts = {r: pad[r::world] for r in range(world)}
        merged = None
        for r in range(world - 1, -1, -1):
            out_r = merge_results_dist(parts[r], B, str(work / "merge"), rank=r, world=world,
                                       barrier=lambda: None)
            if r == 0:
                merged = out_r
        res["merged_order"] = [f["frame_id"] for f in merged]
        assert res["merged_order"] == list(range(B)), "merge_results_dist lost dataset order"
        for got, want in zip(merged, one):
            np.testing.assert_array_equal(got["pred_boxes"], want["pred_boxes"])
        _say(n, f"{label['d']}, {100 * res['box_share']:.2f} % of "
                f"box entries within rtol 1e-3 / atol 1e-4 of one process, "
                f"merge_results_dist(world={world}) OK (counts={res['counts']})")

    # (e) the two-stage voxel step; one process on the whole batch first.
    # Its RoI sampler and dropout draw from the per-frame generators, so
    # the ranks agree with it only where rank * B + i names the frame
    def voxel_step(frames):
        sec = _model(EasyDict(copy.deepcopy(VOXEL_RCNN_CFG)), 1, dev, dtype, DRYRUN_SEED,
                     **VOXEL_GRID)
        parallel.broadcast_module(sec)
        return float(_trainer(cfg, sec)[1](_on(_voxel_batch(B, dtype), dev, frames))[0])

    if rank == 0:
        res["voxel_loss_one"] = voxel_step(slice(None))
    groups.join(n)
    res["voxel_loss"] = voxel_step(mine)
    if rank == 0:
        gap = _rel(res["voxel_loss"], res["voxel_loss_one"])
        assert np.isfinite(res["voxel_loss"]), f"non-finite Voxel-RCNN loss {res['voxel_loss']}"
        assert gap <= tol["world"], (
            f"{n} ranks' Voxel-RCNN step {res['voxel_loss']!r} against one process "
            f"{res['voxel_loss_one']!r}")
        _say(n, f"{label['e']}, loss={res['voxel_loss']:.4f} (one process "
                f"{res['voxel_loss_one']:.4f}, relative gap {gap:.3g})")

    # (f) one train step at each shipped yaml's full shapes, as shipped
    if not skip_full:
        once = cfg_from_yaml_file(str(ONCE_YAML), EasyDict())
        for key, part, fcfg, per_rank, N in (("full-shape", "f-kitti", _load_cfg(), 1, 16384),
                                             ("ONCE-shape", "f-once", once, 2, 60000)):
            full = _model(fcfg.MODEL, len(fcfg.CLASS_NAMES), dev, torch.float32, DRYRUN_SEED)
            fbatch = _on(_lidar_batch(per_rank, N, DRYRUN_SEED + 3 + rank), dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            loss = float(_trainer(fcfg, full)[1](fbatch)[0])
            peak = torch.zeros(n, dtype=torch.float64, device=dev)
            if dev.type == "cuda":
                peak[rank] = torch.cuda.max_memory_allocated(dev)
            peak = parallel.all_reduce_detached(peak).tolist()
            del full, fbatch
            res[key] = dict(B=per_rank * n, N=N, loss=loss,
                              peak_bytes=peak if dev.type == "cuda" else None)
            if rank == 0:  # the step's loss is the global batch's on every rank
                assert np.isfinite(loss), f"{key} step: non-finite loss {loss}"
                mem = (", peak memory " + ", ".join(f"rank {r} {p / 1e6:.0f} MB"
                                                    for r, p in enumerate(peak))
                       if dev.type == "cuda" else ", peak memory not measured (CPU)")
                _say(n, f"{label[part]} over the group, loss={loss:.4f}{mem}")
    groups.leave()

    (work / f"launches{rank}.json").write_text(json.dumps(dict(cuda_lib.launches)))
    if rank == 0:
        (work / "result.json").write_text(json.dumps(res))


def _free_ports(k):
    """``k`` distinct free ports of 127.0.0.1, all held until each is known."""
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def dryrun_multichip(n_devices, dtype=torch.float32, device=None):
    """Run parts (a)-(f) of the module docstring over ``n_devices`` ranks of
    a process group on ``device`` (the card unless the caller says
    otherwise): Gloo on the CPU or on one card the ranks share, NCCL with a
    card a rank.  Raises if a part fails; returns rank 0's results (every
    part's losses, counts and shares, the peak memory of (f)), the backend
    and the ranks' kernel launches summed."""
    import torch.multiprocessing as mp

    from .ops import cuda_lib

    n = int(n_devices)
    dtype = torch.float64 if dtype in (torch.float64, "float64") else torch.float32
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu')")
        device = torch.device("cuda", device.index or 0)
        cuda_lib.lib()  # built once here, loaded by every rank
        backend = "nccl" if torch.cuda.device_count() >= n > 1 else "gloo"
    else:
        backend = "gloo"
    threads = max(1, torch.get_num_threads() // n)
    skip_full = os.environ.get("PDANET_DRYRUN_SKIP_FULL", "0") == "1"
    work = tempfile.mkdtemp(prefix="dryrun_")
    t0 = time.perf_counter()
    try:
        mp.start_processes(_rank_main, args=(n, str(dtype).split(".")[-1], str(device), backend,
                                             _free_ports(5), work, threads, skip_full),
                           nprocs=n, join=True, start_method="spawn")
        res = json.loads((Path(work) / "result.json").read_text())
        launches = {}
        for r in range(n):
            for k, v in json.loads((Path(work) / f"launches{r}.json").read_text()).items():
                launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res.update(backend=backend, dtype=str(dtype), launches=launches,
               seconds=time.perf_counter() - t0)
    return res


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=["dryrun"],
                    help="dryrun: dryrun_multichip over N ranks; without it, entry()")
    ap.add_argument("n", nargs="?", type=int, default=8, help="ranks of the dryrun (8)")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                    help="the dryrun's parts (a)-(e)")
    args = ap.parse_args(argv)
    if args.mode == "dryrun":
        res = dryrun_multichip(args.n, dtype=args.dtype, device=args.device)
        print(json.dumps(res), flush=True)
    else:
        fn, fargs = entry(args.device)
        with torch.inference_mode():
            out = fn(*fargs)
        print("entry forward:", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    from pdanet_tpu_torch import graft_entry  # the ranks unpickle its functions by this name

    graft_entry.main()

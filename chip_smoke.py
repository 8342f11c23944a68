#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of PDA-SSD (``pdanet_tpu_torch``) on one
NVIDIA GPU and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Preconditions: a CUDA device, its name and power limit from nvidia-smi,
   TF32 off for the float32 comparisons.
2. Build the hand-written kernels (``pdanet_tpu_torch/csrc``) with nvcc.
3. Each kernel against its plain PyTorch version on the card, at the
   KITTI main-path shapes, B = 1 and 2, on LiDAR-like x-sorted clouds:
   FPS, ball query and NMS equal; attention within 2e-5 (float32) and
   5e-2 (bfloat16); IoU within rtol 2e-4 / atol 2e-5 with a diagonal of 1.
   Times are medians of 20 runs under CUDA events.
4. Serve: PDA-SSD at the full width of tools/cfgs/kitti_models/PDA-SSD.yaml
   (bfloat16 compute as shipped, seeded random weights) answers three
   one-frame requests and one two-frame request through
   ``serving.make_predict_fn``; every kernel must have launched.
5. One frame in float32 on the card (kernels) against the same weights on
   the CPU (plain versions, the labelled reference): equal sampling and
   ball-query indices, centre features within 1e-3, logits within 2e-3,
   equal detection counts.
6. The attention backward kernel against its plain version on the card,
   at the B = 4 training shapes of SA1 (hd 64) and SA2 (hd 128), K 16 and
   32, float32 and bfloat16, and off the path at K 64 / hd 128 and K 8 /
   hd 32: max abs error <= 2e-5 in float32, <= 5e-2 of the largest
   |gradient| in bfloat16 (and <= 1e-12 in float64 at SA1 K 32).  The
   autograd Function on the card against the plain backward in float32,
   and ``torch.autograd.gradcheck`` of it on the card in float64.
7. Train: PDA-SSD at full width, bfloat16 train compute as shipped, takes
   5 steps of the yaml's adam_onecycle on 4 LiDAR-like frames with gt
   boxes of the three classes on their clusters, through
   ``train.make_train_step``; finite loss and gradients at every step;
   FPS, ball query and both attention kernels launched.  Then one step at
   B = 1 on the card against the CPU (plain versions) from the same
   weights.  In float32: equal D-FPS and ball-query indices (ctr-aware
   picks equal up to swaps of scores within 1e-5), loss within 1e-4
   relative, BatchNorm running statistics within 1e-5 (of max(1, |stat|)),
   every gradient leaf within 1e-1 of its scale (its largest |gradient|,
   floored at 1e-3 of the largest leaf's: one float32 step is chaotic at
   the 1e-3 level on either device, see ``compare_train``).  In float64,
   with the indices fed: loss within 1e-10, every gradient leaf within
   1e-3 of its scale (floored at 1e-6 of the largest leaf's), statistics
   within 1e-5.  And the max-pool gradient goes to
   the first of tied slots on the card.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
YAML = ROOT / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
N_POINTS = 16384

KERNELS = {  # name: (source, TPU kernel it replaces)
    "fps": ("pdanet_tpu_torch/csrc/fps.cu", "pdanet_tpu/ops/pallas/fps.py:365"),
    "ball_query": ("pdanet_tpu_torch/csrc/ball_query.cu",
                   "pdanet_tpu/ops/pallas/ball_query.py:306"),
    "neighbor_attention": ("pdanet_tpu_torch/csrc/neighbor_attention.cu",
                           "pdanet_tpu/ops/pallas/attention.py:201"),
    "neighbor_attention_bwd": ("pdanet_tpu_torch/csrc/neighbor_attention_bwd.cu",
                               "pdanet_tpu/ops/pallas/attention.py:256"),
    "rotated_iou": ("pdanet_tpu_torch/csrc/rotated_iou.cu",
                    "pdanet_tpu/ops/pallas/rotated_iou.py:244"),
    "nms": ("pdanet_tpu_torch/csrc/nms.cu", "pdanet_tpu/ops/pallas/nms.py:70"),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def lidar_like_cloud(seed, B, N, x_range=(0.0, 70.4), y_range=(-40.0, 40.0),
                     with_centers=False):
    """LiDAR-like frames (B, N, 4): a ground plane with 1/r density
    falloff, car-sized clusters and sparse mid-air returns, x-sorted like
    the pipeline's ``sort_points`` step (a numpy copy of bench.py's).
    ``with_centers`` also returns the (12, 3) cluster centres."""
    rs = np.random.RandomState(seed)
    n_ground = int(N * 0.72)
    n_obj = int(N * 0.2)
    n_air = N - n_ground - n_obj
    r = x_range[1] * np.sqrt(rs.rand(n_ground)) ** 1.4
    th = rs.uniform(-0.8, 0.8, n_ground)
    ground = np.stack([np.clip(r * np.cos(th), *x_range),
                       np.clip(r * np.sin(th), *y_range),
                       rs.normal(-1.7, 0.05, n_ground)], -1)
    n_clusters = 12
    centers = np.stack([rs.uniform(5, 60, n_clusters),
                        rs.uniform(-20, 20, n_clusters),
                        rs.uniform(-1.2, -0.4, n_clusters)], -1)
    member = rs.randint(0, n_clusters, n_obj)
    obj = centers[member] + rs.randn(n_obj, 3) * np.array([2.0, 0.9, 0.7]) * 0.5
    air = np.stack([rs.uniform(*x_range, n_air), rs.uniform(*y_range, n_air),
                    rs.uniform(-1.0, 2.5, n_air)], -1)
    pts = np.concatenate([ground, obj, air], 0).astype(np.float32)
    cloud = np.concatenate([pts, rs.rand(N, 1).astype(np.float32)], -1)
    out = np.stack([cloud] * B)
    out[:, :, :3] += rs.randn(B, N, 3).astype(np.float32) * 0.05
    for b in range(B):
        out[b] = out[b][np.argsort(out[b, :, 0], kind="stable")]
    return (out, centers) if with_centers else out


def lidar_like_batch(seed, B, N, mean_size, M=16):
    """A training batch: ``lidar_like_cloud`` frames and gt boxes (B, M, 8)
    on their 12 clusters, classes Car, Pedestrian, Cyclist in turn with the
    yaml's mean sizes, random headings; the last M - 12 rows are zero
    padding.  Every class holds points of every frame."""
    pts, centers = lidar_like_cloud(seed, B, N, with_centers=True)
    rs = np.random.RandomState(seed + 1)
    gt = np.zeros((B, M, 8), np.float32)
    for j, c in enumerate(centers):
        cls = j % 3
        gt[:, j, 0:3] = c
        gt[:, j, 3:6] = mean_size[cls]
        gt[:, j, 6] = rs.uniform(-np.pi, np.pi)
        gt[:, j, 7] = cls + 1
    for b in range(B):
        d = pts[b, :, None, :3] - gt[b, None, :12, 0:3]
        cosa, sina = np.cos(gt[b, :12, 6]), np.sin(gt[b, :12, 6])
        lx = d[..., 0] * cosa + d[..., 1] * sina
        ly = -d[..., 0] * sina + d[..., 1] * cosa
        inside = ((np.abs(lx) < gt[b, :12, 3] / 2) & (np.abs(ly) < gt[b, :12, 4] / 2)
                  & (np.abs(d[..., 2]) <= gt[b, :12, 5] / 2))
        for cls in range(3):
            n_in = int(inside[:, cls::3].sum())
            require(n_in > 0, f"frame {b}: no point in a box of class {cls + 1}")
    return pts, gt


def random_boxes(seed, B, K, spread=12.0):
    rs = np.random.RandomState(seed)
    b = np.zeros((B, K, 7), np.float32)
    b[..., 0:2] = rs.uniform(-spread, spread, (B, K, 2))
    b[..., 2] = rs.uniform(-1.5, 0.5, (B, K))
    b[..., 3:5] = rs.uniform(0.5, 4.5, (B, K, 2))
    b[..., 5] = rs.uniform(1.0, 2.0, (B, K))
    b[..., 6] = rs.uniform(-np.pi, np.pi, (B, K))
    return b


def cuda_ms(fn, reps=20, warmup=2):
    """Median milliseconds of ``fn`` under CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def check_kernels(dev):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns per kernel the largest error and the B = 1 headline times."""
    import torch

    from pdanet_tpu_torch.ops import attention, ball_query, nms, rotated_iou, sampling

    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for k in KERNELS}

    def record(name, err, kern_fn, plain_fn, headline, what):
        kern_ms, plain_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], float(err))
        if headline:
            st["ms"], st["plain_ms"] = kern_ms, plain_ms
        print(f"{name:18s} {what}: max_abs_err {err:.3g}; kernel {kern_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")

    def idx_err(a, b):
        return (a.long() - b.long()).abs().max().item()

    for B in (1, 2):
        pts = torch.from_numpy(lidar_like_cloud(B, B, N_POINTS)).to(dev)
        xyz = pts[..., :3].contiguous()
        k_idx = sampling.farthest_point_sample_cuda(xyz, 4096)
        p_idx = sampling.farthest_point_sample_plain(xyz, 4096)
        require(torch.equal(k_idx, p_idx), f"FPS B={B} indices differ from the plain version")
        record("fps", idx_err(k_idx, p_idx),
               lambda: sampling.farthest_point_sample_cuda(xyz, 4096),
               lambda: sampling.farthest_point_sample_plain(xyz, 4096),
               B == 1, f"B={B} 16384->4096 equal")

        sa0_ctr = torch.gather(xyz, 1, k_idx.long()[..., None].expand(B, 4096, 3)).contiguous()
        sa1_ctr = sa0_ctr[:, :1024].contiguous()
        for label, sup, ctr, radii, ks in (
            ("SA0", xyz, sa0_ctr, (0.2, 0.8), (16, 32)),
            ("SA1", sa0_ctr, sa1_ctr, (0.8, 1.6), (16, 32)),
        ):
            got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
            want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
            for g, w in zip(got, want):
                require(torch.equal(g, w), f"ball query {label} B={B} differs from the plain version")
            record("ball_query", max(idx_err(g, w) for g, w in zip(got, want)),
                   lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                   lambda: ball_query.ball_query_multi_plain(radii, ks, sup, ctr),
                   B == 1 and label == "SA0",
                   f"{label} B={B} N={sup.shape[1]} M={ctr.shape[1]} equal")

        rs = np.random.RandomState(B)
        for label, M, hd in (("SA1", 1024, 64), ("SA2", 512, 128)):
            for K in (16, 32):
                R, D = B * M * K, 4 * hd
                qkv32 = [torch.from_numpy(rs.randn(R, D).astype(np.float32)).to(dev)
                         for _ in range(3)]
                for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
                    q, k, v = (t.to(dt) for t in qkv32)
                    got = attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd)
                    want = attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd)
                    err = (got.float() - want.float()).abs().max().item()
                    require(got.dtype == dt and err <= tol,
                            f"attention {label} K={K} {dt} err {err} > {tol}")
                    record("neighbor_attention", err,
                           lambda: attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd),
                           lambda: attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd),
                           B == 1 and label == "SA1" and K == 32 and dt == torch.bfloat16,
                           f"{label} B={B} K={K} hd={hd} {str(dt)[6:]}")

        boxes = torch.from_numpy(random_boxes(B, B, 256)).to(dev)
        iou = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
        want = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
        err = (iou - want).abs().max().item()
        require(torch.allclose(iou, want, rtol=2e-4, atol=2e-5),
                f"IoU B={B} outside rtol 2e-4 / atol 2e-5 (max err {err})")
        diag = torch.diagonal(iou, dim1=1, dim2=2)
        require(torch.allclose(diag, torch.ones_like(diag), rtol=1e-5, atol=0),
                f"IoU B={B}: the diagonal is not 1")
        record("rotated_iou", err,
               lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
               lambda: rotated_iou.boxes_iou_bev_batched_self_plain(boxes),
               B == 1, f"B={B} K=256")

        valid = torch.from_numpy(np.random.RandomState(B).rand(B, 256) > 0.1).to(dev)
        k_keep = nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01)
        p_keep = nms.greedy_nms_mask_batched_plain(iou, valid, 0.01)
        require(torch.equal(k_keep, p_keep), f"NMS B={B} keep mask differs from the plain version")
        record("nms", idx_err(k_keep, p_keep),
               lambda: nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01),
               lambda: nms.greedy_nms_mask_batched_plain(iou, valid, 0.01),
               B == 1, f"B={B} K=256 equal, {int(k_keep.sum())} kept")

    # shapes off the KITTI path that the kernels take as well: FPS with
    # the min-distance in global scratch (N > 32768) and with N not a
    # multiple of the block, three radii up to K 64 (ONCE SA5), attention
    # at K 64 (opt-in shared memory) and K 8
    cloud = torch.from_numpy(lidar_like_cloud(7, 1, 40000)[..., :3].copy()).to(dev)
    for N, npoint in ((40000, 1024), (5000, 1000)):
        xyz = cloud[:, :N].contiguous()
        require(torch.equal(sampling.farthest_point_sample_cuda(xyz, npoint),
                            sampling.farthest_point_sample_plain(xyz, npoint)),
                f"FPS N={N} differs from the plain version")
    ctr = cloud[:, ::40].contiguous()
    radii, ks = (4.8, 8.4, 12.8), (16, 32, 64)
    for g, w in zip(ball_query.ball_query_multi_cuda(radii, ks, cloud, ctr),
                    ball_query.ball_query_multi_plain(radii, ks, cloud, ctr)):
        require(torch.equal(g, w), f"ball query K={w.shape[-1]} differs from the plain version")
    rs = np.random.RandomState(3)
    for K, hd in ((64, 128), (8, 32)):
        q, k, v = (torch.from_numpy(rs.randn(64 * K, 4 * hd).astype(np.float32)).to(dev)
                   for _ in range(3))
        err = (attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd)
               - attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd)).abs().max().item()
        require(err <= 2e-5, f"attention K={K} hd={hd} err {err} > 2e-5")
        stats["neighbor_attention"]["max_abs_err"] = max(
            stats["neighbor_attention"]["max_abs_err"], err)
    print("off-path shapes: FPS N=40000 and 5000 equal, ball query 3 radii K<=64 equal, "
          "attention K=64/hd=128 and K=8/hd=32 within 2e-5")
    return stats


def load_config():
    from pdanet_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(str(YAML))


def serve(cfg, dev):
    """Phase 4: serve three one-frame requests and one two-frame request
    through the serving closure.  Returns the launch counts of that run
    and a copy of the model's seeded weights."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.ops import cuda_lib
    from pdanet_tpu_torch.serving import example_device_batch, make_predict_fn

    model = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES)), seed=0)
    weights = copy.deepcopy(model.state_dict())
    predict = make_predict_fn(model.to(dev), cfg.MODEL)
    for B in (1, 2):  # warm-up: allocator and library set-up per batch size
        predict(example_device_batch(cfg, B, dev))
    requests = [torch.from_numpy(lidar_like_cloud(100 + i, 1, N_POINTS)).to(dev)
                for i in range(3)]
    requests.append(torch.from_numpy(lidar_like_cloud(200, 2, N_POINTS)).to(dev))
    torch.cuda.synchronize()

    cuda_lib.launches.clear()
    results = []
    for pts in requests:
        t0 = time.perf_counter()
        res = predict({"points": pts})
        torch.cuda.synchronize()
        results.append((pts.shape[0], (time.perf_counter() - t0) * 1e3, res))
    launches = dict(cuda_lib.launches)

    for i, (B, ms, res) in enumerate(results):
        counts = res["pred_counts"]
        for key, val in res.items():
            require(tuple(val.shape[:1]) == (B,), f"request {i}: {key} batch shape")
            require(bool(torch.isfinite(val.float()).all()), f"request {i}: {key} not finite")
        require(bool(((counts >= 0) & (counts <= 500)).all()), f"request {i}: counts {counts}")
        print(f"request {i}: B={B} latency {ms:.2f} ms, detections {counts.tolist()}")
    print(f"kernel launches in the served requests: {launches}")
    for name in KERNELS:
        if name != "neighbor_attention_bwd":  # training only (phase 7)
            require(launches.get(name, 0) > 0,
                    f"kernel {name} never launched on the main path")
    return launches, weights


def compare_f32(cfg, weights, dev):
    """Phase 5: one frame in float32 on the card (kernels) against the
    same weights on the CPU (plain versions, the reference)."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor

    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    mcfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    runs = {}
    frame = lidar_like_cloud(300, 1, N_POINTS)
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_network(mcfg, len(cfg.CLASS_NAMES))
        model.load_state_dict(weights)
        model.to(device).eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(torch.from_numpy(frame).to(device))
            post = get_post_processor(mcfg.NAME)(out, mcfg)
        print(f"float32 forward + NMS on the {name}: {time.perf_counter() - t0:.2f} s")
        runs[name] = (out, post)
    (g_out, g_post), (c_out, c_post) = runs["card"], runs["cpu"]

    sa_cfg = mcfg.BACKBONE_3D.SA_CONFIG
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        if "ctr_aware" in sa_cfg.SAMPLE_METHOD_LIST[k]:
            npoint = sa_cfg.NPOINT_LIST[k][0]
            sc = torch.sigmoid(c_out["sa_ins_preds"][k - 1].max(-1).values)
            sg = torch.sigmoid(g_out["sa_ins_preds"][k - 1].max(-1).values.cpu())
            srt = torch.sort(sc, dim=-1, descending=True).values
            print(f"SA{k} ctr-aware top-{npoint}: score gap at the cut "
                  f"{(srt[:, npoint - 1] - srt[:, npoint]).min().item():.3g}, "
                  f"max |card - cpu| score {(sg - sc).abs().max().item():.3g}")
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        if c_out["sampled_idx"][k] is not None:
            require(torch.equal(g_out["sampled_idx"][k].cpu(), c_out["sampled_idx"][k]),
                    f"SA{k} sampled indices differ card vs CPU")
        for r, (gb, cb) in enumerate(zip(g_out["ball_query_idx"][k] or (),
                                         c_out["ball_query_idx"][k] or ())):
            require(torch.equal(gb.cpu(), cb), f"SA{k} radius {r} ball query differs card vs CPU")
    err_f = (g_out["centers_features"].cpu() - c_out["centers_features"]).abs().max().item()
    err_c = (g_out["batch_cls_preds"].cpu() - c_out["batch_cls_preds"]).abs().max().item()
    err_b = (g_out["center_box_preds"].cpu() - c_out["center_box_preds"]).abs().max().item()
    print(f"float32 card vs CPU: indices equal; centers_features {err_f:.3g}, "
          f"cls logits {err_c:.3g}, box logits {err_b:.3g}; detections "
          f"{g_post['pred_counts'].tolist()} vs {c_post['pred_counts'].tolist()}")
    require(err_f <= 1e-3, f"centers_features err {err_f} > 1e-3")
    require(err_c <= 2e-3 and err_b <= 2e-3, f"logit errors {err_c}, {err_b} > 2e-3")
    require(torch.equal(g_post["pred_counts"].cpu(), c_post["pred_counts"]),
            "detection counts differ card vs CPU")


def check_attention_bwd(dev, stats):
    """Phase 6: the attention backward kernel against the plain backward
    at the B = 4 training shapes and off the path; the autograd Function
    on the card against the plain backward."""
    import torch

    from pdanet_tpu_torch.ops import attention, cuda_lib

    st = stats["neighbor_attention_bwd"]
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(f"{label} B=4", 4 * M, K, hd, dt, True)
             for label, M, hd in (("SA1", 1024, 64), ("SA2", 512, 128))
             for K in (16, 32) for dt in (torch.float32, torch.bfloat16)]
    cases += [("off-path", 64, K, hd, dt, False)
              for K, hd in ((64, 128), (8, 32)) for dt in (torch.float32, torch.bfloat16)]
    cases += [("SA1 B=4", 4 * 1024, 32, 64, torch.float64, False)]
    for label, centres, K, hd, dt, timed in cases:
        R, D = centres * K, 4 * hd
        q, k, v, do = (torch.randn(R, D, generator=gen, device=dev).to(dt) for _ in range(4))
        got = attention.neighbor_attention_flat_bwd_cuda(q, k, v, do, K, 4, hd)
        want = attention.neighbor_attention_flat_bwd_plain(q, k, v, do, K, 4, hd)
        torch.cuda.synchronize()
        abs_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        if dt == torch.float32:
            err, tol, what = abs_err, 2e-5, "max abs err"
        elif dt == torch.float64:
            err, tol, what = abs_err, 1e-12, "max abs err"
        else:
            err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                      for g, w in zip(got, want))
            tol, what = 5e-2, "max err / max |grad|"
        require(all(g.dtype == dt for g in got) and err <= tol,
                f"attention backward {label} K={K} hd={hd} {dt}: {what} {err} > {tol}")
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        line = (f"{'neighbor_attention_bwd':18s} {label} K={K} hd={hd} {str(dt)[6:]}: "
                f"{what} {err:.3g}")
        if timed:
            kern_ms = cuda_ms(lambda: attention.neighbor_attention_flat_bwd_cuda(
                q, k, v, do, K, 4, hd))
            plain_ms = cuda_ms(lambda: attention.neighbor_attention_flat_bwd_plain(
                q, k, v, do, K, 4, hd))
            line += f"; kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms"
            if label.startswith("SA1") and K == 32 and dt == torch.bfloat16:
                st["ms"], st["plain_ms"] = kern_ms, plain_ms
        print(line)
        del q, k, v, do, got, want

    # the autograd Function on the card, float32: its backward is the kernel
    K, hd = 32, 64
    q, k, v, do = (torch.randn(64 * K, 4 * hd, generator=gen, device=dev) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = cuda_lib.launches["neighbor_attention_bwd"]
    attention.neighbor_attention_flat(*leaves, K, 4, hd).backward(do)
    torch.cuda.synchronize()
    require(cuda_lib.launches["neighbor_attention_bwd"] == before + 1,
            "the autograd Function did not launch the backward kernel")
    want = attention.neighbor_attention_flat_bwd_plain(q, k, v, do, K, 4, hd)
    err = max((t.grad - w).abs().max().item() for t, w in zip(leaves, want))
    require(err <= 2e-5, f"autograd Function on the card: grad err {err} > 2e-5")
    print(f"autograd Function on the card (float32, K={K}, hd={hd}): grads within "
          f"{err:.3g} of the plain backward")

    # gradcheck of the Function on the card, float64 (both kernels take it)
    K, H, hd = 8, 2, 16
    leaves = [torch.randn(3 * K, H * hd, generator=gen, device=dev, dtype=torch.float64)
              .requires_grad_() for _ in range(3)]
    before = cuda_lib.launches["neighbor_attention_bwd"]
    torch.autograd.gradcheck(
        lambda a, b, c: attention.NeighborAttention.apply(a, b, c, K, H, hd), leaves)
    require(cuda_lib.launches["neighbor_attention_bwd"] > before,
            "gradcheck did not go through the backward kernel")
    print(f"torch.autograd.gradcheck of the Function on the card (float64, K={K}, "
          f"hd={hd}): passed")


def _train_model(cfg, mcfg, weights, dev):
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step

    model = build_network(mcfg, len(cfg.CLASS_NAMES))
    model.load_state_dict(weights)
    model.to(dev)
    ocfg = cfg.OPTIMIZATION
    # KITTI train split: 3712 frames at BATCH_SIZE_PER_GPU 4 per iteration
    optimizer, schedule = build_optimizer_and_schedule(
        model, ocfg, total_iters_each_epoch=3712 // ocfg.BATCH_SIZE_PER_GPU,
        total_epochs=ocfg.NUM_EPOCHS)
    return model, make_train_step(model, optimizer, schedule)


def _grads_finite(model):
    import torch

    flags = [torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None]
    return bool(torch.stack(flags).all())


def train(cfg, weights, dev):
    """Phase 7: 5 full-width train steps at B = 4 in bfloat16 compute
    (and, for the record, 3 in float32).  Returns the launch counts of the
    bfloat16 steps."""
    import torch

    from pdanet_tpu_torch.ops import cuda_lib

    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    mean_size = np.asarray(cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    pts, gt = lidar_like_batch(400, B, N_POINTS, mean_size)
    batch = {"points": torch.from_numpy(pts).to(dev), "gt_boxes": torch.from_numpy(gt).to(dev)}
    f32_cfg = copy.deepcopy(cfg.MODEL)
    f32_cfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    f32_cfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    launches = None
    for name, mcfg, n_steps in (("bf16", cfg.MODEL, 5), ("f32", f32_cfg, 3)):
        model, train_step = _train_model(cfg, mcfg, weights, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.launches.clear()
        times, losses = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            loss, tb = train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            require(np.isfinite(losses[-1]), f"{name} step {i}: loss {losses[-1]}")
            require(_grads_finite(model), f"{name} step {i}: gradients not finite")
        counts = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"train {name} B={B}: losses {[round(x, 4) for x in losses]}; ms/step "
              f"{[round(t, 2) for t in times]}, median after warm-up "
              f"{statistics.median(times[1:]):.2f} ms; peak memory {peak:.2f} GiB")
        print(f"train {name} B={B}: tb of the last step "
              f"{ {k: round(float(v), 4) for k, v in tb.items()} }")
        print(f"kernel launches in the {name} train steps: {counts}")
        if name == "bf16":
            launches = counts
        del model, train_step
    for kname in ("fps", "ball_query", "neighbor_attention", "neighbor_attention_bwd"):
        require(launches.get(kname, 0) > 0, f"kernel {kname} never launched in training")
    return launches


def _leaf_errors(got, want, floor):
    """Per gradient leaf, max |got - want| over the leaf's scale: its
    largest |want|, floored at ``floor`` times the largest |want| of any
    leaf.  Below that floor a gradient is rounding noise: the key
    projection's bias, the DensityNet's conv biases and the transformer's
    linear2 bias have a zero true gradient (a softmax row ignores a
    shift; a training-mode BatchNorm follows the others), measured at
    1e-15 to 1e-13 in float64 against 62 for the largest leaf, and at
    1e-7 to 1e-4 in float32."""
    top = floor * max(w.abs().max().item() for w in want.values())
    errs = sorted(((got[n] - w).abs().max().item() / max(w.abs().max().item(), top), n)
                  for n, w in want.items())
    return errs[::-1]


def _deciles(errs):
    vals = sorted(e for e, _ in errs)
    return [f"{vals[int(q * (len(vals) - 1))]:.2g}" for q in np.linspace(0, 1, 11)]


def compare_train(cfg, weights, dev):
    """Phase 7, second part: one train step at B = 1 on the card (kernels)
    against the CPU (plain versions), in float32 and in float64; and the
    max-pool tie routing on the card."""
    import contextlib

    import torch

    from pdanet_tpu_torch.models.backbones_3d import iassd_backbone
    from pdanet_tpu_torch.ops.grouping import group_points

    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    mcfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    mean_size = np.asarray(mcfg.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    sa_cfg = mcfg.BACKBONE_3D.SA_CONFIG
    pts, gt = lidar_like_batch(500, 1, N_POINTS, mean_size)

    @contextlib.contextmanager
    def fed(sampling=None, ball_query=None):
        """Replace the backbone's sampling and ball query for one run."""
        own = iassd_backbone.run_sampling, iassd_backbone.ball_query_multi
        if sampling is not None:
            iassd_backbone.run_sampling = sampling
        if ball_query is not None:
            iassd_backbone.ball_query_multi = ball_query
        try:
            yield
        finally:
            iassd_backbone.run_sampling, iassd_backbone.ball_query_multi = own

    def run(device, dtype):
        model, train_step = _train_model(cfg, mcfg, weights, device)
        model.to(dtype)
        captured = {}
        hook = model.register_forward_hook(lambda m, i, o: captured.update(o))
        t0 = time.perf_counter()
        loss, _ = train_step({"points": torch.from_numpy(pts).to(device, dtype),
                              "gt_boxes": torch.from_numpy(gt).to(device, dtype)})
        loss = loss.item()
        hook.remove()
        print(f"{str(dtype)[6:]} train step B=1 on the {device.type}: "
              f"{time.perf_counter() - t0:.2f} s, loss {loss!r}")
        return dict(
            loss=loss, out=captured, fps_identity=model.backbone_3d.fps_identity,
            grads={n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
            stats={n: b.detach().double().cpu() for n, b in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))})

    cpu = torch.device("cpu")
    card32 = run(dev, torch.float32)
    card_picks = [i.cpu() for k, i in enumerate(card32["out"]["sampled_idx"])
                  if i is not None and not card32["fps_identity"][k]]

    # float32.  The ctr-aware sampling sorts scores that the card and the
    # CPU compute to within ~1e-6 (float32 sums in another order): two
    # scores that close may swap, and the order of every later layer
    # follows (at full width a frame's top-k scores are seldom all 5e-6
    # apart).  So the CPU run takes the card's ctr-aware picks, after
    # checking them against its own: position by position, the CPU scores
    # of the two picks must agree within 1e-5.  D-FPS picks are the CPU's
    # own and must be equal.
    queue, checks = list(card_picks), []

    def card_ctr_picks(types, ranges, npoints, xyz, features, cls_features):
        own, card = own_sampling(types, ranges, npoints, xyz, features, cls_features), queue.pop(0)
        if not any("ctr" in t or "cls" in t for t in types):
            checks.append(("D-FPS", int((own != card).sum()), 0.0))
            return own
        score = torch.sigmoid(cls_features.detach().max(dim=-1).values)
        gap = (score.gather(1, card.long()) - score.gather(1, own.long())).abs().max().item()
        checks.append(("ctr-aware", int((own != card).sum()), gap))
        return card

    own_sampling = iassd_backbone.run_sampling
    with fed(sampling=card_ctr_picks):
        cpu32 = run(cpu, torch.float32)
    require(not queue, "the CPU run did not sample every layer")
    for what, n_diff, gap in checks:
        print(f"train {what} sampling, CPU's own against the card's: {n_diff} indices "
              f"differ, largest CPU-score difference of the picks {gap:.3g}")
        require((what == "D-FPS" and n_diff == 0) or (what == "ctr-aware" and gap <= 1e-5),
                f"train {what} sampling differs card vs CPU beyond near ties")
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        for r, (gb, cb) in enumerate(zip(card32["out"]["ball_query_idx"][k] or (),
                                         cpu32["out"]["ball_query_idx"][k] or ())):
            require(torch.equal(gb.cpu(), cb), f"train SA{k} radius {r} ball query differs")
    rel32 = abs(card32["loss"] - cpu32["loss"]) / abs(cpu32["loss"])
    require(rel32 <= 1e-4, f"float32 train loss card vs CPU: rel {rel32} > 1e-4")
    for n, cs in cpu32["stats"].items():
        err = (card32["stats"][n] - cs).abs().max().item()
        require(err <= 1e-5 * max(cs.abs().max().item(), 1.0),
                f"float32 BN statistic {n}: err {err} > 1e-5 of max(|stat|, 1)")
    errs32 = _leaf_errors(card32["grads"], cpu32["grads"], 1e-3)

    # float64: the same step with every sampling and ball-query index fed
    # from the float32 card run, on the card (the attention kernels in
    # float64) and on the CPU.  float32 gradients of one step are chaotic
    # at the 1e-3 level on either device (a max-pool or ReLU decision on a
    # near tie routes a gradient elsewhere; tests/test_train_trajectory_
    # twin.py:47-59); in float64 the two must agree to rounding.
    def feed_all():
        samp = list(card_picks)
        ball = [b for b in card32["out"]["ball_query_idx"] if b is not None]
        return dict(sampling=lambda *a: samp.pop(0).to(a[3].device),
                    ball_query=lambda r, n, xyz, c: tuple(t.to(xyz.device) for t in ball.pop(0)))

    with fed(**feed_all()):
        card64 = run(dev, torch.float64)
    with fed(**feed_all()):
        cpu64 = run(cpu, torch.float64)
    rel64 = abs(card64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
    errs64 = _leaf_errors(card64["grads"], cpu64["grads"], 1e-6)
    err_stats64 = max((card64["stats"][n] - cs).abs().max().item()
                      / max(cs.abs().max().item(), 1.0) for n, cs in cpu64["stats"].items())
    errs32_64 = _leaf_errors(card32["grads"], cpu64["grads"], 1e-3)
    errs_cpu32_64 = _leaf_errors(cpu32["grads"], cpu64["grads"], 1e-3)
    print(f"train step card vs CPU over {len(errs32)} gradient leaves (err / leaf scale): "
          f"float32 largest {errs32[0][0]:.3g} ({errs32[0][1]}), deciles {_deciles(errs32)}; "
          f"float64 largest {errs64[0][0]:.3g} ({errs64[0][1]}), deciles {_deciles(errs64)}")
    print(f"float32 against the float64 CPU step, deciles: card {_deciles(errs32_64)}, "
          f"CPU {_deciles(errs_cpu32_64)}")
    print(f"train step card vs CPU: loss rel float32 {rel32:.3g}, float64 {rel64:.3g}; "
          f"{len(cpu32['stats'])} BN statistics, float64 largest err {err_stats64:.3g}")
    require(rel64 <= 1e-10, f"float64 train loss card vs CPU: rel {rel64} > 1e-10")
    require(errs64[0][0] <= 1e-3, f"float64 gradient {errs64[0][1]}: {errs64[0][0]} > 1e-3")
    require(err_stats64 <= 1e-5, f"float64 BN statistics: err {err_stats64} > 1e-5")
    require(errs32[0][0] <= 1e-1, f"float32 gradient {errs32[0][1]}: {errs32[0][0]} > 1e-1")

    # tie routing: SA0's ball query pads each group with its first hit, so
    # the grouped features carry exact ties; the gradient of
    # Tensor.max(dim).values must go to the first tied slot only
    idx = card32["out"]["ball_query_idx"][0][1]  # (1, 4096, 32)
    feats = torch.randn(1, N_POINTS, 64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    grouped = group_points(feats, idx).requires_grad_()
    grouped.max(dim=2).values.sum().backward()
    top = grouped.detach().max(dim=2, keepdim=True).values
    is_max = grouped.detach() == top
    first = torch.argmax(is_max.to(torch.uint8), dim=2, keepdim=True)
    want = torch.zeros_like(grouped).scatter_(2, first, 1.0)
    ties = int((is_max.sum(dim=2) > 1).sum())
    require(ties > 0, "no tied slots to check the max-pool gradient on")
    require(torch.equal(grouped.grad, want),
            "max-pool gradient on the card does not go to the first tied slot")
    print(f"max-pool tie routing on the card: {ties} (centre, channel) pairs with tied "
          f"slots, every gradient on the first")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port is checked on a GPU only")
    sys.path.insert(0, str(ROOT))
    from pdanet_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    # ---- 1. preconditions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip())

    # ---- 3.-7.
    stats = check_kernels(dev)
    cfg = load_config()
    served, weights = serve(cfg, dev)
    compare_f32(cfg, weights, dev)
    check_attention_bwd(dev, stats)
    trained = train(cfg, weights, dev)
    compare_train(cfg, weights, dev)

    # launches: each kernel's count over the serving run (phase 4) and the
    # bfloat16 train steps (phase 7), each counted from 0
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": served.get(name, 0) + trained.get(name, 0), **stats[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
    "rotated_iou": ("pdanet_tpu_torch/csrc/rotated_iou.cu",
                    "pdanet_tpu/ops/pallas/rotated_iou.py:244"),
    "nms": ("pdanet_tpu_torch/csrc/nms.cu", "pdanet_tpu/ops/pallas/nms.py:70"),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def lidar_like_cloud(seed, B, N, x_range=(0.0, 70.4), y_range=(-40.0, 40.0)):
    """LiDAR-like frames (B, N, 4): a ground plane with 1/r density
    falloff, car-sized clusters and sparse mid-air returns, x-sorted like
    the pipeline's ``sort_points`` step (a numpy copy of bench.py's)."""
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
    return out


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
        require(launches.get(name, 0) > 0, f"kernel {name} never launched on the main path")
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

    # ---- 3.-5.
    stats = check_kernels(dev)
    cfg = load_config()
    launches, weights = serve(cfg, dev)
    compare_f32(cfg, weights, dev)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

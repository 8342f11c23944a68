"""Serve CLI: ``python -m pdanet_tpu_torch.tools.serve --artifact <.pt2>
--inputs '<glob>'``.

Counterpart of the JAX package's ``tools/serve.py``: loads a program
saved by ``pdanet_tpu_torch.tools.export`` and runs batched inference over
``.bin`` (KITTI velodyne layout, (N, 4) float32) or ``.npy`` point clouds,
writing one JSON line of detections per frame (to ``--out`` or stdout)
with scores at or above ``--score_thresh``.  The preprocessing is the
sidecar's: each cloud is brought to its point budget and x-sorted when
the test split sorts (``load_cloud``); a last batch short of frames is
padded with zero clouds.  A program that takes the voxel triplet (a voxel
detector's, PV-RCNN's beside its points) is refused, as the JAX package's
serve CLI takes point clouds only.  The frames per second, host I/O included, go to stderr.  No config
or model code is read.

Usage:
    python -m pdanet_tpu_torch.tools.serve --artifact PDA-SSD_b1.pt2 \\
        --inputs '/path/to/clouds/*.bin' [--out detections.jsonl] [--score_thresh 0.3]
"""

import argparse
import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..serving import load_serving


def load_cloud(path, n_points, num_feats, sort_points=True):
    """One cloud at the program's point budget: a larger one
    stride-subsampled (``linspace``), a smaller one padded by wrapping
    (duplicates are harmless to the detector), then x-sorted (stable) when
    ``sort_points``.  An empty cloud raises."""
    if path.endswith(".npy"):
        pts = np.load(path)
    else:  # KITTI velodyne .bin layout: (N, 4) f32
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts = pts[:, :num_feats].astype(np.float32)
    n = pts.shape[0]
    if n == 0:
        raise SystemExit(f"empty point cloud: {path!r} (0 points)")
    if n >= n_points:
        idx = np.linspace(0, n - 1, n_points).astype(np.int64)
        pts = pts[idx]
    else:
        reps = -(-n_points // n)
        pts = np.tile(pts, (reps, 1))[:n_points]
    if sort_points:
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
    return pts


def frame_detections(pred, score_thresh):
    """One dict a frame of a pred dict: the boxes (rounded to 3 places),
    scores (4 places) and labels of its detections scoring at least
    ``score_thresh``."""
    boxes, scores, labels, counts = (pred[k].cpu().numpy() for k in (
        "pred_boxes", "pred_scores", "pred_labels", "pred_counts"))
    out = []
    for b in range(boxes.shape[0]):
        keep = (np.arange(boxes.shape[1]) < counts[b]) & (scores[b] >= score_thresh)
        out.append({"boxes_lidar": boxes[b][keep].round(3).tolist(),
                    "scores": scores[b][keep].round(4).tolist(),
                    "labels": labels[b][keep].tolist()})
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="serve an exported program")
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--inputs", required=True, help="glob of .bin/.npy point clouds")
    ap.add_argument("--out", default=None, help="output jsonl (default stdout)")
    ap.add_argument("--score_thresh", type=float, default=0.3)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    predict, _ = load_serving(args.artifact)  # raises without the sidecar
    meta = json.loads(Path(args.artifact + ".json").read_text())
    if set(meta["inputs"]) != {"points"}:
        raise SystemExit(f"{args.artifact} takes {sorted(meta['inputs'])}: the serve CLI feeds "
                         f"point clouds to a point detector's program only")
    B, n_points, num_feats = meta["inputs"]["points"]["shape"]
    sort_points = meta["preprocess"]["sort_points"]
    device = torch.device(meta["device"])

    files = sorted(glob.glob(args.inputs))
    if not files:
        raise SystemExit(f"no inputs match {args.inputs!r}")
    sink = open(args.out, "w") if args.out else sys.stdout
    try:
        n_done = 0
        t0 = time.perf_counter()
        for start in range(0, len(files), B):
            batch_files = files[start:start + B]
            batch = np.stack(
                [load_cloud(f, n_points, num_feats, sort_points) for f in batch_files]
                + [np.zeros((n_points, num_feats), np.float32)] * (B - len(batch_files)))
            out = predict({"points": torch.from_numpy(batch).to(device)})
            for f, dets in zip(batch_files, frame_detections(out, args.score_thresh)):
                sink.write(json.dumps({"frame": os.path.basename(f), **dets}) + "\n")
                n_done += 1
        dt = time.perf_counter() - t0
        print(f"served {n_done} frames in {dt:.2f}s ({n_done / dt:.1f} fps incl. host IO)",
              file=sys.stderr)
    finally:
        if args.out:
            sink.close()


if __name__ == "__main__":
    main()

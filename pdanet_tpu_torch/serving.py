"""Serving path: forward plus post-processing on one device batch.

Counterpart of ``pdanet_tpu/serving.py:126-183``.  ``make_predict_fn``
returns the closure a server calls per request: the model's forward and
the rotated-NMS post-processing under ``torch.inference_mode()``,
returning the fixed-shape ``pred_boxes / pred_scores / pred_labels /
pred_counts`` dict.  The JAX package stages the same closure to a
StableHLO artifact; exporting the port is ROADMAP queue 1 item 8.
"""

import numpy as np
import torch

from .models.detectors import get_post_processor


def _processor_map(data_cfg):
    return {p["NAME"]: p for p in data_cfg.DATA_PROCESSOR}


def test_split_sorts_points(data_cfg):
    """True iff the pipeline x-sorts clouds on the test split."""
    procs = _processor_map(data_cfg)
    if "sort_points" not in procs:
        return False
    enabled = procs["sort_points"].get("ENABLED", {"train": True, "test": True})
    return bool(enabled["test"])


def _test_budget(value):
    return int(value["test"]) if isinstance(value, dict) else int(value)


def example_device_batch(cfg, batch_size, device, seed=0):
    """Synthetic device batch at the serving shapes: ``{"points": (B, N, C)}``
    with N the test-split ``sample_points`` budget, coordinates uniform over
    ``POINT_CLOUD_RANGE`` and x-sorted when the pipeline sorts."""
    data_cfg = cfg.DATA_CONFIG
    procs = _processor_map(data_cfg)
    if "sample_points" not in procs:
        raise ValueError("a point-cloud device batch needs a `sample_points` "
                         "DATA_PROCESSOR entry to fix its size")
    n = _test_budget(procs["sample_points"]["NUM_POINTS"])
    num_feats = len(data_cfg.POINT_FEATURE_ENCODING["used_feature_list"])
    pc_range = np.asarray(data_cfg.POINT_CLOUD_RANGE, np.float32)
    rs = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, num_feats), np.float32)
    pts[..., :3] = rs.uniform(pc_range[:3], pc_range[3:6], (batch_size, n, 3))
    if test_split_sorts_points(data_cfg):
        order = np.argsort(pts[..., 0], axis=1)
        pts = np.take_along_axis(pts, order[..., None], axis=1)
    return {"points": torch.from_numpy(pts).to(device)}


def make_predict_fn(model, model_cfg):
    """The serving closure: forward + post-processing, inference mode."""
    post_fn = get_post_processor(model_cfg.NAME)
    model.eval()

    def predict(batch):
        with torch.inference_mode():
            out = model.forward_batch(batch)
            return post_fn(out, model_cfg)

    return predict

"""Serving path: forward plus post-processing on one device batch, and
its export as one saved program.

Counterpart of ``pdanet_tpu/serving.py:63-228``.  ``make_predict_fn``
returns the closure a server calls per request: the model's forward and
the rotated-NMS post-processing under ``torch.inference_mode()``,
returning the fixed-shape ``pred_boxes / pred_scores / pred_labels /
pred_counts`` dict.

``export_serving`` traces the same forward and post-processing with
``torch.export`` into one ``ExportedProgram``, the weights inside it, at
the static shapes of ``serving_input_spec`` (the model's device batch:
the point cloud of a point detector, the voxel triplet of a voxel one,
both for PV-RCNN); ``save_serving`` writes it
(``.pt2``) with a JSON sidecar (the I/O contract, the test split's
x-sort and the device), and ``load_serving`` reads it back.  The kernels
are ``torch.library`` custom ops (``pdanet_tpu_torch.ops``), so the
program calls them by name.

What a saved program needs: unlike a ``jax.export`` artifact it does not
run with torch alone.  Loading it needs this package's ``ops`` module,
which registers the ops (``load_serving`` imports it), and running it on
the card needs ``nvcc`` to build the kernels at their first launch, as
every CUDA run of the port does.  The program is traced for one device:
one traced on CUDA runs on CUDA and ``load_serving`` raises where there is
none; it never falls back to the CPU.  No config, checkpoint or model
code is read at load time.
"""

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn


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


_EXCLUDED_KEYS = ("gt_boxes",)  # eval-only extras of a device batch


def serving_input_spec(cfg, batch_size, model):
    """``{key: (shape, dtype)}`` of the device batch (JAX :65-122): the keys
    of ``model``'s ``DEVICE_BATCH_KEYS`` (as ``select_device_batch`` takes
    them; the model or its class), the gt keys excluded; for a model that
    declares none, the voxel triplet for a voxelizing pipeline, else
    ``points``.  ``voxels`` is (B, V, P, C), ``voxel_coords`` (B, V, 3) and
    ``voxel_num_points`` (B, V), V and P the test split's
    ``MAX_NUMBER_OF_VOXELS`` and ``MAX_POINTS_PER_VOXEL``; ``points`` is
    (B, N, C), N the test split's ``sample_points`` budget (PV-RCNN's
    device batch carries both)."""
    data_cfg = cfg.DATA_CONFIG
    procs = _processor_map(data_cfg)
    num_feats = len(data_cfg.POINT_FEATURE_ENCODING["used_feature_list"])
    keys = getattr(model, "DEVICE_BATCH_KEYS", None)
    if keys is None:
        keys = (("voxels", "voxel_coords", "voxel_num_points")
                if "transform_points_to_voxels" in procs else ("points",))
    spec = {}
    for key in (k for k in keys if k not in _EXCLUDED_KEYS):
        if key == "points":
            if "sample_points" not in procs:
                raise ValueError(
                    "serving export of a model whose device batch carries 'points' requires "
                    "a `sample_points` DATA_PROCESSOR entry: its NUM_POINTS budget is what "
                    "fixes the static (B, N, C) point-cloud shape the program is traced at")
            n = _test_budget(procs["sample_points"]["NUM_POINTS"])
            spec[key] = ((batch_size, n, num_feats), torch.float32)
            continue
        if key not in ("voxels", "voxel_coords", "voxel_num_points"):
            raise NotImplementedError(
                f"serving export does not cover device-batch key {key!r} (the camera-family "
                f"CaDDN pipeline carries per-frame image/calibration tensors whose shapes live "
                f"in the data, not the config)")
        p = procs["transform_points_to_voxels"]
        v = _test_budget(p["MAX_NUMBER_OF_VOXELS"])
        spec[key] = {"voxels": ((batch_size, v, int(p["MAX_POINTS_PER_VOXEL"]), num_feats),
                                torch.float32),
                     "voxel_coords": ((batch_size, v, 3), torch.int32),
                     "voxel_num_points": ((batch_size, v), torch.int32)}[key]
    return spec


def sidecar_input_spec(meta):
    """The ``serving_input_spec`` a saved program was traced at, from its
    sidecar ``meta`` (``serving_meta``)."""
    return {k: (tuple(v["shape"]), getattr(torch, v["dtype"]))
            for k, v in meta["inputs"].items()}


def example_device_batch(cfg, spec, device, seed=0):
    """Synthetic device batch at the shapes and dtypes of ``spec``
    (``serving_input_spec`` or ``sidecar_input_spec``; JAX :125-168):
    coordinates uniform over ``POINT_CLOUD_RANGE``, points x-sorted when
    the pipeline sorts; full voxels at distinct random cells of the grid,
    uniform over a pillar grid, in clusters on a 3-D grid
    (:func:`clustered_cells`), whose sparse convs then find neighbours."""
    pc_range = np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    rs = np.random.RandomState(seed)
    batch = {}
    for key, (shape, dtype) in spec.items():
        if key == "points":
            arr = np.zeros(shape, np.float32)
            arr[..., :3] = rs.uniform(pc_range[:3], pc_range[3:6], shape[:2] + (3,))
            if test_split_sorts_points(cfg.DATA_CONFIG):
                order = np.argsort(arr[..., 0], axis=1)
                arr = np.take_along_axis(arr, order[..., None], axis=1)
        elif key == "voxels":
            arr = np.zeros(shape, np.float32)
            arr[..., :3] = rs.uniform(pc_range[:3], pc_range[3:6], shape[:3] + (3,))
        elif key == "voxel_coords":
            p = _processor_map(cfg.DATA_CONFIG)["transform_points_to_voxels"]
            grid = np.round((pc_range[3:6] - pc_range[:3])
                            / np.asarray(p["VOXEL_SIZE"], np.float32)).astype(int)
            # distinct cells, as the voxelizer gives: no two voxels of a
            # frame land on one cell of the scatter
            if grid[2] > 1:
                cells = np.stack([clustered_cells(rs, grid, shape[1])
                                  for _ in range(shape[0])])
            else:
                cells = np.stack([rs.choice(int(np.prod(grid)), shape[1], replace=False)
                                  for _ in range(shape[0])])
            z, rest = np.divmod(cells, grid[1] * grid[0])
            arr = np.stack([z, *np.divmod(rest, grid[0])], axis=-1)
        else:  # voxel_num_points
            p = _processor_map(cfg.DATA_CONFIG)["transform_points_to_voxels"]
            arr = np.full(shape, int(p["MAX_POINTS_PER_VOXEL"]))
        batch[key] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return batch


def clustered_cells(rs, grid, n):
    """``n`` distinct flat cells (z-major) of a (nx, ny, nz) grid, drawn in
    64 Gaussian blobs of 8 x 8 x 2 cells (x, y, z) around centres uniform
    over the grid, in the order drawn.  No permutation of the grid (90 M
    cells at 0.05 m KITTI) is made."""
    grid = np.asarray(grid, np.int64)
    centres = rs.uniform(0, grid, (64, 3))
    cells = np.zeros(0, np.int64)
    while len(cells) < n:
        pick = centres[rs.randint(64, size=2 * n)]
        xyz = np.clip(np.round(pick + rs.normal(0.0, (8.0, 8.0, 2.0), (2 * n, 3))), 0, grid - 1)
        x, y, z = xyz.astype(np.int64).T
        drawn = np.concatenate([cells, (z * grid[1] + y) * grid[0] + x])
        _, first = np.unique(drawn, return_index=True)
        cells = drawn[np.sort(first)]
    return cells[:n]


class _Predict(nn.Module):
    """The forward and the post-processing as one module: what the
    closure runs and what the export traces."""

    def __init__(self, model, model_cfg):
        super().__init__()
        from .models.detectors import get_post_processor, resolve_detector_name

        self.model = model.eval()
        self.model_cfg = model_cfg
        self.post_fn = get_post_processor(resolve_detector_name(model_cfg))

    def forward(self, batch, with_forward=False):
        out = self.model.forward_batch(batch)
        pred = self.post_fn(out, self.model_cfg)
        return (pred, out) if with_forward else pred


def make_predict_fn(model, model_cfg):
    """The serving closure: forward + post-processing, inference mode.
    ``predict(batch, with_forward=True)`` also returns the forward dict (the
    eval loop reads a two-stage detector's ``rois`` from it)."""
    module = _Predict(model, model_cfg)

    def predict(batch, with_forward=False):
        with torch.inference_mode():
            return module(batch, with_forward)

    return predict


def export_serving(model, model_cfg, example_batch):
    """The predict path traced by ``torch.export`` at the example batch's
    shapes, dtypes and device, in the model's own compute dtype; the
    weights travel in the returned ``ExportedProgram``."""
    with torch.no_grad():
        exported = torch.export.export(_Predict(model, model_cfg), (dict(example_batch),),
                                       strict=False)
    # the trace puts a host-side check of dtype, device and layout before
    # each ``.to()`` (hundreds in a PDA-SSD request); the program's input
    # spec fixes them already, and each is one more dispatch per request
    graph = exported.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
    exported.graph_module.recompile()
    return exported


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def serving_meta(cfg, cfg_file, example_batch, exported):
    """The sidecar's I/O contract for an export of ``cfg`` at
    ``example_batch``: the keys of the JAX package's sidecar
    (``platforms`` and ``jax_version`` replaced by ``device`` and
    ``torch_version``)."""
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in out_node.args[0]]
    outputs = torch.utils._pytree.tree_unflatten(vals, exported.call_spec.out_spec)
    first = next(iter(example_batch.values()))
    return {
        "cfg_file": str(cfg_file),
        "model": cfg.MODEL.NAME,
        "class_names": list(cfg.CLASS_NAMES),
        "batch_size": int(first.shape[0]),
        "inputs": {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                   for k, v in example_batch.items()},
        "outputs": {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                    for k, v in outputs.items()},
        "preprocess": {"sort_points": test_split_sorts_points(cfg.DATA_CONFIG)},
        "device": str(first.device),
        "torch_version": torch.__version__,
    }


def save_serving(exported, path, meta):
    """Write the program (``torch.export.save``) and its sidecar ``meta``
    (``serving_meta``) at ``<path>.json``.  Returns the program's size in
    bytes."""
    torch.export.save(exported, str(path))
    with open(f"{path}.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return Path(path).stat().st_size


def load_serving(path):
    """Load a saved program and return ``(predict, exported)``.
    ``predict`` takes the device-batch dict and returns the fixed-shape
    pred dict, under ``torch.inference_mode()``.  Raises if the sidecar is
    missing, or if it names a CUDA device and this process has none."""
    from . import ops  # noqa: F401  (registers the ops the program calls)

    sidecar = Path(f"{path}.json")
    if not sidecar.exists():
        raise FileNotFoundError(f"{sidecar}: the program's sidecar is missing; export with "
                                f"pdanet_tpu_torch.tools.export, which writes it")
    device = torch.device(json.loads(sidecar.read_text())["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for {device}, and this process has no "
                           f"CUDA device: the program runs where it was traced")
    exported = torch.export.load(str(path))
    module = exported.module()

    def predict(batch):
        with torch.inference_mode():
            return module(dict(batch))

    return predict, exported

"""The port's serving export (``pdanet_tpu_torch.serving``) and its export /
serve CLIs, on the CPU, at the tiny model of ``tests/model_cfg.py`` inside
the shipped KITTI yaml (256 sampled points, B = 2).

* ``torch.library.opcheck`` of each of the six kernel ops (schema, fake
  implementation, autograd registration, AOT dispatch); the attention
  forward in float64 with inputs that require grad, so that its
  ``register_autograd`` gradient is checked too.
* The exported, saved and reloaded program equals the eager closure
  exactly, calls the five serving ops by name and keeps none of the
  trace's tensor-metadata asserts.
* The same weights, carried from the flax variables by the weight bridge,
  through the JAX package's ``serving.make_predict_fn``: equal detection
  counts and labels, every box paired by mutual nearest centre within 1e-4
  (the slice's tolerance for post-processed boxes and scores,
  ``tests/test_torch_model.py``).
* The export CLI with ``--random_init --verify``, then ``--load``.
* ``tools/serve.load_cloud`` against the JAX package's on the same clouds
  (empty, wrapped, exact, subsampled; x-sorted or not), and the serve CLI
  over three ``.bin`` files: one JSON line each, equal to the closure.
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from model_cfg import tiny_model_cfg
from pdanet_tpu import serving as j_serving
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.detectors import __all__ as detectors
from pdanet_tpu_torch.ops import attention, ball_query, nms, rotated_iou, sampling
from pdanet_tpu_torch.tools import export as export_cli
from pdanet_tpu_torch.tools import serve as serve_cli
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables

REPO = Path(__file__).resolve().parent.parent
KITTI_YAML = REPO / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
N_POINTS = 256
B = 2
SERVING_OPS = ("fps", "ball_query", "neighbor_attention", "rotated_iou", "nms")


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


def _cfg():
    cfg = cfg_from_yaml_file(str(KITTI_YAML))
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": N_POINTS, "test": N_POINTS}
    cfg.MODEL = EasyDict(_plain(tiny_model_cfg(len(cfg.CLASS_NAMES))))
    return cfg


def _spec(cfg, batch_size):
    """The serving spec of ``cfg``'s detector (its class's keys)."""
    return serving.serving_input_spec(cfg, batch_size, detectors[cfg.MODEL.NAME])


def _op_cases():
    rs = np.random.RandomState(0)
    xyz = torch.tensor(rs.rand(2, 64, 3) * 4, dtype=torch.float32)
    K, H, hd = 8, 2, 16
    q, k, v, do = (torch.tensor(rs.randn(3 * K, H * hd), dtype=torch.float64)
                   for _ in range(4))
    boxes = torch.tensor(np.concatenate(
        [rs.rand(2, 20, 3) * 5, rs.rand(2, 20, 3) + 1, rs.rand(2, 20, 1) * 3], -1),
        dtype=torch.float32)
    iou = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
    valid = torch.tensor(rs.rand(2, 20) > 0.2)
    return {
        "fps": (sampling.fps_op, (xyz, 16)),
        "ball_query": (ball_query.ball_query_op,
                       ([0.5, 1.5], [4, 8], xyz, xyz[:, :16].clone(), "x_conv1")),
        "neighbor_attention": (attention.attention_op,
                               (*(t.clone().requires_grad_() for t in (q, k, v)), K, H, hd)),
        "neighbor_attention_bwd": (attention.attention_bwd_op, (q, k, v, do, K, H, hd)),
        "rotated_iou": (rotated_iou.rotated_iou_op, (boxes,)),
        "nms": (nms.nms_op, (iou, valid, 0.1)),
    }


@pytest.mark.parametrize("name", ["fps", "ball_query", "neighbor_attention",
                                  "neighbor_attention_bwd", "rotated_iou", "nms"])
def test_opcheck(name):
    op, args = _op_cases()[name]
    assert op._qualname == f"pdanet_tpu_torch::{name}"
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """The tiny model with the flax model's initial weights, exported at
    B = 2 on the CPU and saved with its sidecar; the flax model beside it."""
    cfg = _cfg()
    batch = serving.example_device_batch(cfg, _spec(cfg, B), "cpu")
    jcfg = JEasyDict(_plain(cfg.MODEL))
    jmodel = j_build(jcfg, num_class=len(cfg.CLASS_NAMES))
    variables = jax.device_get(jax.jit(
        lambda r, p: jmodel.init({"params": r}, p, train=False)
    )(jax.random.PRNGKey(0), jnp.asarray(batch["points"].numpy())))
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu")
    load_jax_variables(model, variables)
    exported = serving.export_serving(model, cfg.MODEL, batch)
    path = tmp_path_factory.mktemp("export") / "tiny_b2.pt2"
    serving.save_serving(exported, path, serving.serving_meta(cfg, "tiny.yaml", batch, exported))
    return SimpleNamespace(cfg=cfg, jcfg=jcfg, jmodel=jmodel, variables=variables,
                           model=model, exported=exported, path=path)


def _frames():
    return [serving.example_device_batch(_cfg(), _spec(_cfg(), B), "cpu", seed=s)
            for s in (1, 2, 3)]


def test_exported_program_equals_closure(program):
    called = {str(n.target).split(".")[1] for n in program.exported.graph.nodes
              if n.op == "call_function" and str(n.target).startswith("pdanet_tpu_torch.")}
    assert called == set(SERVING_OPS)
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   for n in program.exported.graph.nodes)
    meta = json.loads(Path(f"{program.path}.json").read_text())
    assert meta["inputs"] == {"points": {"shape": [B, N_POINTS, 4], "dtype": "float32"}}
    assert meta["outputs"]["pred_boxes"] == {"shape": [B, 8, 7], "dtype": "float32"}
    assert meta["preprocess"] == {"sort_points": True} and meta["device"] == "cpu"
    predict, _ = serving.load_serving(program.path)
    closure = serving.make_predict_fn(program.model, program.cfg.MODEL)
    for batch in _frames():
        got, want = predict(batch), closure(batch)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert int(want["pred_counts"].sum()) > 0


def _pairs(a_boxes, a_labels, b_boxes, b_labels):
    """Mutual nearest box centres among boxes of the same label."""
    d = np.linalg.norm(a_boxes[:, None, :3] - b_boxes[None, :, :3], axis=-1)
    d[a_labels[:, None] != b_labels[None, :]] = np.inf
    near_b, near_a = d.argmin(1), d.argmin(0)
    return [(i, j) for i, j in enumerate(near_b) if np.isfinite(d[i, j]) and near_a[j] == i]


def test_exported_program_against_jax(program):
    predict, _ = serving.load_serving(program.path)
    jpredict = jax.jit(j_serving.make_predict_fn(program.jmodel, program.variables,
                                                 program.jcfg))
    for batch in _frames():
        got = {k: v.numpy() for k, v in predict(batch).items()}
        want = jax.device_get(jpredict({"points": jnp.asarray(batch["points"].numpy())}))
        np.testing.assert_array_equal(got["pred_counts"], want["pred_counts"])
        for b in range(B):
            n = int(got["pred_counts"][b])
            gb, wb = got["pred_boxes"][b, :n], np.asarray(want["pred_boxes"][b, :n])
            gl, wl = got["pred_labels"][b, :n], np.asarray(want["pred_labels"][b, :n])
            pairs = _pairs(gb, gl, wb, wl)
            assert len(pairs) == n, f"frame {b}: {len(pairs)} of {n} boxes paired"
            for i, j in pairs:
                np.testing.assert_allclose(gb[i], wb[j], atol=1e-4)
                np.testing.assert_allclose(got["pred_scores"][b, i],
                                           want["pred_scores"][b, j], atol=1e-4)


def test_export_cli_verify_then_load(tmp_path, monkeypatch):
    cfg_file = tmp_path / "cfgs" / "tiny.yaml"
    cfg_file.parent.mkdir()
    cfg_file.write_text(yaml.safe_dump(_plain(_cfg())))
    monkeypatch.chdir(tmp_path)
    assert export_cli.parse_args(["--cfg_file", "x.yaml"]).device == "cuda"
    with pytest.raises(SystemExit, match="--random_init"):
        export_cli.main(["--cfg_file", "cfgs/tiny.yaml", "--device", "cpu"])
    out = export_cli.main(["--cfg_file", "cfgs/tiny.yaml", "--random_init", "--verify",
                           "--device", "cpu", "--batch_size", "2"])
    assert out == "tiny_b2.pt2" and (tmp_path / out).exists()
    meta = json.loads((tmp_path / f"{out}.json").read_text())
    assert set(meta) == {"cfg_file", "model", "class_names", "batch_size", "inputs",
                         "outputs", "preprocess", "device", "torch_version"}
    assert meta["batch_size"] == 2 and meta["class_names"] == ["Car", "Pedestrian", "Cyclist"]
    pred = export_cli.main(["--cfg_file", "cfgs/tiny.yaml", "--load", out, "--device", "cpu",
                            "--batch_size", "2"])
    assert pred["pred_boxes"].shape == (2, 8, 7)
    assert pred["pred_counts"].dtype == torch.int32


def test_serving_input_spec_and_device_guard(program, tmp_path):
    assert serving.serving_input_spec(program.cfg, 3, program.model) == {
        "points": ((3, N_POINTS, 4), torch.float32)}
    cfg = _cfg()
    cfg.DATA_CONFIG.DATA_PROCESSOR = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                                      if p.NAME != "sample_points"]
    with pytest.raises(ValueError, match="sample_points"):
        serving.serving_input_spec(cfg, 1, program.model)
    cfg.DATA_CONFIG.DATA_PROCESSOR.append(EasyDict(
        NAME="transform_points_to_voxels", VOXEL_SIZE=[0.16, 0.16, 4], MAX_POINTS_PER_VOXEL=32,
        MAX_NUMBER_OF_VOXELS={"train": 16000, "test": 40000}))
    assert serving.serving_input_spec(cfg, 1, program.model) == {
        "voxels": ((1, 40000, 32, 4), torch.float32),
        "voxel_coords": ((1, 40000, 3), torch.int32),
        "voxel_num_points": ((1, 40000), torch.int32)}
    # a program without its sidecar is refused
    bare = tmp_path / "bare.pt2"
    bare.write_bytes(program.path.read_bytes())
    with pytest.raises(FileNotFoundError, match="sidecar is missing"):
        serving.load_serving(bare)
    # a program traced on CUDA is refused where there is none
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    path = tmp_path / "cuda.pt2"
    path.write_bytes(program.path.read_bytes())
    meta = json.loads(Path(f"{program.path}.json").read_text())
    Path(f"{path}.json").write_text(json.dumps({**meta, "device": "cuda:0"}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_serving(path)


def _jax_serve_cli():
    spec = importlib.util.spec_from_file_location("jax_tools_serve", REPO / "tools" / "serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("sort_points", [True, False])
@pytest.mark.parametrize("n", [0, 100, N_POINTS, 1000])
def test_load_cloud_matches_jax(tmp_path, n, sort_points):
    """Empty (raises), wrapped, exact and stride-subsampled clouds, from
    ``.bin`` and ``.npy`` files."""
    pts = np.random.RandomState(n).rand(n, 4).astype(np.float32) * 30
    files = [tmp_path / "c.bin", tmp_path / "c.npy"]
    pts.tofile(files[0])
    np.save(files[1], pts)
    jax_cli = _jax_serve_cli()
    for f in map(str, files):
        if n == 0:
            for cli in (serve_cli, jax_cli):
                with pytest.raises(SystemExit, match="empty point cloud"):
                    cli.load_cloud(f, N_POINTS, 4, sort_points)
            continue
        got = serve_cli.load_cloud(f, N_POINTS, 4, sort_points)
        np.testing.assert_array_equal(got, jax_cli.load_cloud(f, N_POINTS, 4, sort_points))
        assert got.shape == (N_POINTS, 4) and got.dtype == np.float32
        assert np.all(np.diff(got[:, 0]) >= 0) == sort_points


def test_serve_cli_matches_closure(program, tmp_path):
    rs = np.random.RandomState(9)
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i, n in enumerate((1000, 100, 300)):  # subsampled, wrapped, subsampled
        pts = rs.uniform([0, -40, -3, 0], [70.4, 40, 1, 1], (n, 4)).astype(np.float32)
        pts.tofile(clouds / f"{i:06d}.bin")
    out = tmp_path / "dets.jsonl"
    serve_cli.main(["--artifact", str(program.path), "--inputs", f"{clouds}/*.bin",
                    "--out", str(out), "--score_thresh", "0.2"])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    files = sorted(clouds.glob("*.bin"))
    assert [d["frame"] for d in lines] == [f.name for f in files]

    closure = serving.make_predict_fn(program.model, program.cfg.MODEL)
    frames = [serve_cli.load_cloud(str(f), N_POINTS, 4) for f in files]
    frames.append(np.zeros((N_POINTS, 4), np.float32))  # the padded last batch
    n_dets = 0
    for start in range(0, len(files), B):
        res = {k: v.numpy() for k, v in closure(
            {"points": torch.from_numpy(np.stack(frames[start:start + B]))}).items()}
        for bi, line in enumerate(lines[start:start + B]):
            keep = (np.arange(res["pred_boxes"].shape[1]) < res["pred_counts"][bi]) & (
                res["pred_scores"][bi] >= 0.2)
            assert line["boxes_lidar"] == res["pred_boxes"][bi][keep].round(3).tolist()
            assert line["scores"] == res["pred_scores"][bi][keep].round(4).tolist()
            assert line["labels"] == res["pred_labels"][bi][keep].tolist()
            n_dets += len(line["scores"])
    assert n_dets > 0

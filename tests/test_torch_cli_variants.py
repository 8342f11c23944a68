"""The port's train and test CLIs with the SA ablations and the IoU head
switched on by ``--set``, on the CPU, over ``tests/test_torch_cli.py``'s
mini-KITTI and tiny PDA-SSD config.

The switches are V1's (``chip_smoke.py`` phase 21 runs it at full width):
SA1 sampled by FS, ``PDA_VARIANT: no_global``, ``PROPOSAL_AWARE_CBAM``
and ``POINT_HEAD.IOU_FC``, given as the CLIs' key-wise dict overrides (the
yaml has none of those keys).  The train CLI trains one epoch: its
checkpoint holds the CBAM and IoU-head weights and no global branch, and
its metrics log ``iou3d_loss_reg`` every step.  The test CLI, given the
same ``--set``, evaluates that checkpoint over every val frame.  The same
model exported by ``serving.export_serving`` calls the F-FPS op and
answers a request exactly as the eager closure does.
"""

import json
import pickle

import torch

from pdanet_tpu_torch.tools import test as test_cli
from pdanet_tpu_torch.train import load_checkpoint
from test_torch_cli import CFG_REL, KITTI_KEYS, _train, kitti_env, workdir  # noqa: F401

V1_SET = [
    "MODEL.BACKBONE_3D.SA_CONFIG",
    "{'SAMPLE_METHOD_LIST': [['D-FPS'], ['FS'], ['ctr_aware'], ['ctr_aware'], [], []], "
    "'NPOINT_LIST': [[64], [16], [16], [8], [-1], [8]], 'PDA_VARIANT': 'no_global', "
    "'PROPOSAL_AWARE_CBAM': True}",
    "MODEL.POINT_HEAD", "{'IOU_FC': [16, 16]}",
]


def test_v1_switches_through_train_and_test_cli(workdir):  # noqa: F811
    out = _train("--epochs", "1", "--num_epochs_to_eval", "0", "--set", *V1_SET)
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    keys = set(load_checkpoint(ckpt)["model_state"])
    assert {"backbone_3d.SA_modules_0.cbam.conv_layer.weight",
            "backbone_3d.SA_modules_5.cbam.conv_layer.weight",
            "point_head.box_iou3d_out.weight"} <= keys
    assert not any("global_mlps" in k for k in keys)
    # no_global: the transformer of SA1 runs at d_model 3 x 16
    q = load_checkpoint(ckpt)["model_state"][
        "backbone_3d.SA_modules_1.Local_pointformer_0.self_attn.query.weight"]
    assert tuple(q.shape) == (48, 48)
    lines = (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    iou = [r["value"] for r in rows if r["tag"] == "train/iou3d_loss_reg"]
    assert len(iou) == 2 and all(torch.isfinite(torch.tensor(iou)))

    result = test_cli.main(["--cfg_file", CFG_REL, "--ckpt", str(ckpt), "--device", "cpu",
                            "--workers", "0", "--batch_size", "1", "--set", *V1_SET])
    assert "Car_3d/moderate_R40" in result
    with open(out / "eval" / "epoch_1" / "val" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002", "000003"]
    for a in annos:
        assert set(a) >= KITTI_KEYS


def test_v1_program_equals_closure(kitti_env):  # noqa: F811
    """V1's tiny model exported by ``serving.export_serving`` (the F-FPS op
    traced through its fake) answers a request exactly as the eager
    closure does, and calls the F-FPS op by name."""
    import yaml

    from pdanet_tpu_torch import serving
    from pdanet_tpu_torch.config import cfg_from_list
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.utils.easydict import EasyDict

    cfg = cfg_from_list(list(V1_SET), EasyDict(yaml.safe_load(kitti_env[1])))
    model = init_random_weights(build_network(cfg.MODEL, 3, device="cpu"), seed=2).eval()
    spec = serving.serving_input_spec(cfg, 1, model)
    batch = serving.example_device_batch(cfg, spec, "cpu")
    exported = serving.export_serving(model, cfg.MODEL, batch)
    assert any("fps_features" in str(n.target) for n in exported.graph.nodes)
    got = exported.module()(dict(batch))
    want = serving.make_predict_fn(model, cfg.MODEL)(batch)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key

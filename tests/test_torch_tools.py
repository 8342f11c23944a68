"""The port's tools beside the train and test CLIs, on the CPU.

* The converter CLI (``python -m pdanet_tpu_torch.tools.ckpt_converter``),
  as ``tests/test_cli.py:316`` drives the JAX package's: the
  reference-shaped twin of ``tests/test_full_model_torch_parity.py`` saved
  in OpenPCDet's wrapper, in torch's zip format (converted in a fresh
  process where ``import jax`` fails) and in the legacy format (in
  process); both give the same checkpoint (CRC-checked, the twin's
  epoch and it, ``optimizer_state`` None, ``version``
  ``converted+<the twin's>``), which the test CLI evaluates on the
  mini-KITTI (4 frames in ``result.pkl``) and the train CLI takes as
  ``--pretrained_model`` and, resuming at the twin's epoch with a fresh
  optimizer as the JAX package's train CLI does, as ``--ckpt``.
* ``once_submit_result``: equal to the JAX tool's output on the same
  ``result.pkl``.
* The launch scripts under ``pdanet_tpu_torch/tools/scripts/`` with stub
  ``srun``, ``scontrol`` and ``torchrun`` on ``PATH`` that record their
  argv and environment: one task per GPU, the port's CLI module with its
  launcher, ``PYTHONPATH`` naming the repository from any working
  directory; the recorded SLURM task's environment read by the launcher.
* The profiler CLI with ``--device cpu`` on the tiny PDA-SSD yaml in each
  mode: each of the port's ops of the mode a family of its table.
"""

import json
import os
import pickle
import runpy
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdanet_tpu_torch.tools import ckpt_converter, once_submit_result, profiler
from pdanet_tpu_torch.train import load_checkpoint
from pdanet_tpu_torch.utils import common_utils
from test_torch_cli import CFG_REL, _log, _train, kitti_env, test_cli, workdir  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "pdanet_tpu_torch" / "tools" / "scripts"
TWIN_WRAPPER = {"epoch": 7, "it": 14, "version": "pcdet+0.5.2"}  # 7 of 8 epochs of 2 steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _twin_pth(path, legacy):
    """The tiny PDA-SSD's reference-shaped twin (``num_batches_tracked``
    kept) in OpenPCDet's checkpoint wrapper."""
    from model_cfg import tiny_model_cfg
    from test_full_model_torch_parity import _build_torch_twin

    cfg = tiny_model_cfg(3)
    torch.manual_seed(11)
    twin, _ = _build_torch_twin(torch, cfg.BACKBONE_3D.SA_CONFIG, cfg.POINT_HEAD, num_class=3,
                                code_size=30)
    with torch.no_grad():
        for mod in twin.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_var.uniform_(0.5, 2.0)
    opt = {"state": {}, "param_groups": [{"lr": 0.003, "betas": (0.95, 0.99), "params": [0]}]}
    torch.save({**TWIN_WRAPPER, "model_state": twin.state_dict(), "optimizer_state": opt},
               path, _use_new_zipfile_serialization=not legacy)
    return path


def test_converter_cli_to_test_and_train_clis(workdir):  # noqa: F811
    zipped, legacy = _twin_pth(workdir / "twin.pth", False), _twin_pth(workdir / "twin_legacy.pth",
                                                                       True)
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None  # no JAX importable\n"
            "sys.argv[0] = 'ckpt_converter'\n"
            "runpy.run_module('pdanet_tpu_torch.tools.ckpt_converter', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code, "--torch_ckpt", str(zipped), "--cfg_file",
                          CFG_REL, "--output", "converted.pth"], cwd=workdir,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ckpt_converter.main(["--torch_ckpt", str(legacy), "--cfg_file", CFG_REL, "--output",
                         "converted_legacy.pth"])
    ck, ck_legacy = load_checkpoint("converted.pth"), load_checkpoint("converted_legacy.pth")
    assert ck["optimizer_state"] is None and ck["version"] == "converted+pcdet+0.5.2"
    assert (ck["epoch"], ck["it"]) == (TWIN_WRAPPER["epoch"], TWIN_WRAPPER["it"])
    assert ck["model_state"].keys() == ck_legacy["model_state"].keys()
    for key, value in ck["model_state"].items():
        assert torch.equal(value, ck_legacy["model_state"][key]), key

    test_cli.main(["--cfg_file", CFG_REL, "--ckpt", "converted.pth", "--device", "cpu",
                   "--workers", "0", "--batch_size", "2", "--extra_tag", "converted"])
    results = [p for p in (workdir / "output").rglob("result.pkl") if "converted" in p.parts]
    assert len(results) == 1
    with open(results[0], "rb") as f:
        assert len(pickle.load(f)) == 4

    out = _train("--epochs", "1", "--num_epochs_to_eval", "0", "--extra_tag", "pretrained",
                 "--pretrained_model", "converted.pth")
    assert "loaded pretrained model converted.pth" in _log(out, "train")
    out = _train("--epochs", "8", "--num_epochs_to_eval", "0", "--extra_tag", "resumed",
                 "--ckpt", "converted_legacy.pth")
    assert "resumed from converted_legacy.pth at epoch 7" in _log(out, "train")
    resumed = load_checkpoint(out / "ckpt" / "checkpoint_epoch_8.pth")
    assert (resumed["epoch"], resumed["it"]) == (8, TWIN_WRAPPER["it"] + 2)
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["checkpoint_epoch_8.pth"]


def test_once_submit_result_equals_the_jax_tool(tmp_path, monkeypatch):
    rs = np.random.RandomState(5)
    classes = np.array(["Car", "Bus", "Truck", "Pedestrian", "Cyclist"])
    results = []
    for i in range(6):
        n = int(rs.randint(0, 9))
        results.append({"frame_id": f"{1616100800000 + 100 * i}", "name": classes[rs.randint(
            0, 5, n)], "score": rs.rand(n).astype(np.float32),
            "boxes_3d": rs.randn(n, 7).astype(np.float32)})
    with open(tmp_path / "result.pkl", "wb") as f:
        pickle.dump(results, f)
    (tmp_path / "test.txt").write_text("\n".join(r["frame_id"] for r in results[1::2]) + "\n")
    args = ["--result_pkl", str(tmp_path / "result.pkl"), "--testset_list",
            str(tmp_path / "test.txt"), "--score_thresh", "0.3"]
    monkeypatch.setattr(sys, "argv", ["once_submit_result.py", *args, "--output",
                                      str(tmp_path / "jax.pkl")])
    runpy.run_path(str(REPO / "tools" / "once_submit_result.py"), run_name="__main__")
    once_submit_result.main([*args, "--output", str(tmp_path / "port.pkl")])
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert [g["frame_id"] for g in got] == [r["frame_id"] for r in results[1::2]]
    assert any(len(g["score"]) for g in got) and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["frame_id"] == w["frame_id"]
        for key in ("name", "score", "boxes_3d"):
            np.testing.assert_array_equal(g[key], w[key])


STUB = """#!/usr/bin/env bash
exec python3 -c 'import json, os, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps({"tool": sys.argv[1], "argv": sys.argv[2:], "cwd": os.getcwd(),
                        "env": dict(os.environ)}) + "\\n")' "$(basename "$0")" "$@"
"""
SLURM_ENV = {"SLURM_PROCID": "3", "SLURM_NTASKS": "16", "SLURM_LOCALID": "3",
             "SLURM_NODELIST": "gpu-node[07-08]"}
SCRIPT_CASES = {
    # script: (its arguments, extra environment, the recorded tool, what it must hold)
    "slurm_train.sh": (["p1", "job", "16", "--cfg_file", "cfgs/x.yaml"], {"PORT": "29501"},
                       "srun", ["-p", "p1", "--job-name=job", "--gres=gpu:8", "--ntasks=16",
                                "--ntasks-per-node=8", "--cpus-per-task=5",
                                "--kill-on-bad-exit=1", "--exclusive", "python3", "-u", "-m",
                                "pdanet_tpu_torch.tools.train", "--launcher", "slurm",
                                "--tcp_port", "29501", "--cfg_file", "cfgs/x.yaml"]),
    "slurm_test.sh": (["p1", "job", "16", "--cfg_file", "cfgs/x.yaml", "--ckpt", "c.pth"],
                      {"PORT": "29502"}, "srun",
                      ["-p", "p1", "--job-name=job", "--gres=gpu:8", "--ntasks=16",
                       "--ntasks-per-node=8", "--cpus-per-task=5", "--kill-on-bad-exit=1",
                       "--exclusive", "python3", "-u", "-m", "pdanet_tpu_torch.tools.test",
                       "--launcher", "slurm", "--tcp_port", "29502", "--cfg_file",
                       "cfgs/x.yaml", "--ckpt", "c.pth"]),
    "slurm_test_mgpu.sh": (["p1", "4", "--cfg_file", "cfgs/x.yaml"], {"PORT": "29503"}, "srun",
                           ["-p", "p1", "--job-name=eval", "--gres=gpu:4", "--ntasks=4",
                            "--ntasks-per-node=4", "--kill-on-bad-exit=1", "--exclusive",
                            "python3", "-u", "-m", "pdanet_tpu_torch.tools.test", "--launcher",
                            "slurm", "--tcp_port", "29503", "--cfg_file", "cfgs/x.yaml"]),
    "slurm_test_single.sh": (["p1", "--cfg_file", "cfgs/x.yaml"], {}, "srun",
                             ["-p", "p1", "--job-name=eval", "--gres=gpu:1", "--ntasks=1",
                              "--ntasks-per-node=1", "--kill-on-bad-exit=1", "--exclusive",
                              "python3", "-u", "-m", "pdanet_tpu_torch.tools.test",
                              "--cfg_file", "cfgs/x.yaml"]),
    "torch_train.sh": (["2", "--cfg_file", "cfgs/x.yaml"], {"PORT": "29504"}, "torchrun",
                       ["--nproc_per_node=2", "--rdzv_endpoint=localhost:29504", "-m",
                        "pdanet_tpu_torch.tools.train", "--launcher", "pytorch", "--cfg_file",
                        "cfgs/x.yaml"]),
}


@pytest.mark.parametrize("script", sorted(SCRIPT_CASES))
def test_launch_script_with_stub_launchers(script, tmp_path):
    args, env, tool, want = SCRIPT_CASES[script]
    stubs = tmp_path / "bin"
    stubs.mkdir()
    for name in ("srun", "scontrol", "torchrun"):
        (stubs / name).write_text(STUB)
        (stubs / name).chmod(stat.S_IRWXU)
    log, cwd = tmp_path / "calls.jsonl", tmp_path / "elsewhere"
    cwd.mkdir()
    base = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "PORT")}
    res = subprocess.run(["bash", str(SCRIPTS / script), *args], cwd=cwd, timeout=60,
                         env={**base, **env, "SRUN_ARGS": "--exclusive", "STUB_LOG": str(log),
                              "PATH": f"{stubs}{os.pathsep}{os.environ['PATH']}"},
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert [c["tool"] for c in calls] == [tool]
    call = calls[0]
    if tool == "torchrun":
        want = [w for w in want if w != "--exclusive"]
    assert call["argv"] == want
    assert call["cwd"] == str(cwd)
    assert call["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    if tool == "srun" and "--launcher" in want:
        # what srun gives a task, read by the port's launcher
        port = int(want[want.index("--tcp_port") + 1])
        for key, value in SLURM_ENV.items():
            os.environ[key] = value
        try:
            got = common_utils._launch_env("slurm", port)
        finally:
            for key in SLURM_ENV:
                del os.environ[key]
        assert got == (3, 16, 3, "gpu-node07", port)


@pytest.fixture(scope="module")
def tiny_yaml(kitti_env, tmp_path_factory):  # noqa: F811
    path = tmp_path_factory.mktemp("profiler") / "PDA-SSD-tiny.yaml"
    path.write_text(kitti_env[1])
    return path


@pytest.mark.parametrize("mode,ops", [
    ("forward", ("fps", "ball_query", "neighbor_attention")),
    ("e2e", ("fps", "ball_query", "neighbor_attention", "rotated_iou", "nms")),
    ("train", ("fps", "ball_query", "neighbor_attention", "neighbor_attention_bwd")),
])
def test_profiler_cli_on_the_cpu(tiny_yaml, mode, ops, capsys):
    report = profiler.main(["--cfg_file", str(tiny_yaml), "--mode", mode, "--device", "cpu",
                            "--batch_size", "2", "--repeats", "2", "--top", "5"])
    out = capsys.readouterr().out
    assert "CPU time (operators' self time, not a device number) per call" in out
    assert report["busy_ms"] is None and report["per_call_ms"] > 0
    assert np.isclose(sum(report["families"].values()), report["per_call_ms"])
    for op in ops:
        assert report["families"].get(op, 0) > 0, (op, report["families"])
    assert len(report["top"]) == 5


def test_profiler_refuses_a_voxel_detector_and_a_missing_card(monkeypatch):
    """A voxel detector takes its grid from a dataset, which the profiler
    does not build (the JAX package's raises too); without a card the
    default device raises rather than profile the CPU."""
    with pytest.raises(ValueError, match="point detectors"):
        profiler.build_model(str(REPO / "tools" / "cfgs" / "kitti_models" / "pointpillar.yaml"),
                             "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.main(["--cfg_file", str(REPO / "tools" / "cfgs" / "kitti_models" /
                                         "PDA-SSD.yaml")])


def test_short_name_and_family():
    name = ("void (anonymous namespace)::attn_fwd_mma<32, 64, __nv_bfloat16>(float const*, "
            "int)")
    assert profiler.short_name(name) == "attn_fwd_mma<32>"
    assert profiler.family("attn_fwd_mma<32>") == "neighbor_attention"
    assert profiler.family("nms_walk_kernel<5,8>") == "nms"
    assert profiler.family("pdanet_tpu_torch::rotated_iou") == "rotated_iou"
    assert profiler.family("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul/conv"
    assert profiler.family("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"

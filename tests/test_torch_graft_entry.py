"""``pdanet_tpu_torch.graft_entry`` against ``__graft_entry__.py``, on the CPU.

* ``_load_cfg(tiny)``: the port's copy equals the JAX module's, as plain
  dicts.
* ``dryrun_multichip(2)`` in float64 on the CPU (two Gloo ranks, the
  full-shape part off by ``PDANET_DRYRUN_SKIP_FULL=1``), run once in a
  fresh process: (a) the two ranks' step equals one process on the same
  global batch within 1e-10; (b) a fresh model, optimizer and group
  restored from the checkpoint hold the saved state bit for bit (Adam's
  moments and the update count with it), and their two steps equal the
  direct steps within 1e-12 relative; (c) one rank restored from the same
  checkpoint on the whole global batch, held so within 1e-10; (d) the sharded eval's
  counts equal one process's and every box entry within rtol 1e-3 / atol
  1e-4, dataset order restored by the merges; (e) the two ranks' Voxel-RCNN
  step, its RoI sampler and dropout drawn per frame, equals one process
  within 1e-10.  Port against port on one CPU: no picks need feeding.
* Slow tier: ``entry()``'s forward at full width against JAX's
  ``entry()`` from the same initial weights (JAX's ``model.init``, carried
  over by ``load_jax_variables``) on JAX's cloud, both in float32 compute
  (the yaml's bfloat16 dropped on both sides), logits within 2e-3 and boxes
  within 2e-3 of max(1, |value|) (ROADMAP, "How a slice is checked");
  ``tiny`` runs the same at the dryrun's tiny widths.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from pdanet_tpu_torch import graft_entry as ge

REPO = Path(__file__).resolve().parent.parent


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
def test_load_cfg_equals_jax(tiny):
    got, want = _plain(ge._load_cfg(tiny)), _plain(jge._load_cfg(tiny))
    assert type(got) is dict and got == want
    assert got["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["NPOINT_LIST"][0] == ([64] if tiny else [4096])


@pytest.fixture(scope="module")
def dryrun():
    """``python -m pdanet_tpu_torch.graft_entry dryrun 2 --device cpu
    --dtype float64`` once: (its printed lines, its result dict)."""
    env = dict(os.environ, PDANET_DRYRUN_SKIP_FULL="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pdanet_tpu_torch.graft_entry", "dryrun", "2", "--device", "cpu",
         "--dtype", "float64"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    lines = proc.stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_dryrun_prints_every_part(dryrun):
    lines, res = dryrun
    parts = ge.part_labels(2, full=False).values()
    assert len(parts) == 5
    assert [p for p in parts if not any(ln.startswith("dryrun_multichip(2): ") and p in ln
                                        for ln in lines)] == []
    assert not any("full-shape" in ln or "ONCE-shape" in ln for ln in lines)
    assert res["backend"] == "gloo" and res["dtype"] == "torch.float64"
    assert res["launches"] == {}  # the CPU runs the plain versions


def test_dryrun_a_two_ranks_equal_one_process(dryrun):
    res = dryrun[1]
    assert np.isfinite(res["loss"])
    assert abs(res["loss"] - res["loss_one"]) <= 1e-10 * abs(res["loss_one"])


def _continues(res, key, bound):
    """The saved state restored exactly and the part's two steps held to
    the direct run's within ``bound``."""
    assert res[f"restored_{key}"] is True and res[f"count_{key}"] == 1
    assert abs(res[f"loss_{key}"] - res["loss_direct"]) <= bound * abs(res["loss_direct"])
    assert (abs(res[f"loss_{key}_next"] - res["loss_direct_next"])
            <= bound * abs(res["loss_direct_next"]))


def test_dryrun_b_resume_continues_the_loss(dryrun):
    res = dryrun[1]
    # the second and third steps are other steps
    assert len({res["loss"], res["loss_direct"], res["loss_direct_next"]}) == 3
    _continues(res, "resumed", 1e-12)


def test_dryrun_c_half_world_continues_the_loss(dryrun):
    _continues(dryrun[1], "half", 1e-10)


def test_dryrun_d_sharded_eval_and_merge(dryrun):
    res = dryrun[1]
    assert len(res["counts"]) == 2 and min(res["counts"]) > 0
    assert res["box_share"] == 1.0
    assert res["merged_order"] == [0, 1]


def test_dryrun_e_voxel_rcnn_step(dryrun):
    res = dryrun[1]
    assert np.isfinite(res["voxel_loss"])
    assert abs(res["voxel_loss"] - res["voxel_loss_one"]) <= 1e-10 * abs(res["voxel_loss_one"])


def _f32(load, tiny):
    """``load`` (a ``_load_cfg``) at ``tiny`` widths or as called, the
    yaml's bfloat16 compute dropped."""
    def cfg(tiny_arg=False):
        c = load(tiny or tiny_arg)
        for key in ("COMPUTE_DTYPE", "TRAIN_COMPUTE_DTYPE"):
            c.MODEL.BACKBONE_3D.pop(key, None)
        return c
    return cfg


@pytest.mark.slow
@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_entry_matches_jax_entry(tiny, monkeypatch):
    import jax

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.utils.jax_weights import load_jax_variables

    monkeypatch.setattr(jge, "_load_cfg", _f32(jge._load_cfg, tiny))
    monkeypatch.setattr(ge, "_load_cfg", _f32(ge._load_cfg, tiny))
    jfn, (jvars, jpoints) = jge.entry()
    want = [np.asarray(o) for o in jax.jit(jfn)(jvars, jpoints)]

    fn, (state, points) = ge.entry(device="cpu")
    assert points.shape == (1, 16384, 4) and bool((points[0, 1:, 0] >= points[0, :-1, 0]).all())
    cfg = ge._load_cfg()
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, jax.device_get(jvars)))
    assert model.state_dict().keys() == state.keys()
    with torch.inference_mode():
        cls, box = fn(model.state_dict(), torch.from_numpy(np.array(jpoints)))
    np.testing.assert_allclose(cls.numpy(), want[0], atol=2e-3)
    scale = np.maximum(1.0, np.abs(want[1]))
    np.testing.assert_array_less(np.abs(box.numpy() - want[1]) / scale, 2e-3)

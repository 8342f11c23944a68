"""The port's reference checkpoint converter
(``pdanet_tpu_torch/tools/ckpt_converter.py``) against the JAX package's
(``tools/ckpt_converter.py``), on the CPU.

Each roundtrip of ``tests/test_converter.py`` and
``tests/test_converter_two_stage.py`` is mirrored as a case: a flax tree of
the JAX model at the JAX test's tiny config (shapes from ``jax.eval_shape``,
seeded random values, so that every transpose and flip shows), emitted into
the reference's ``state_dict`` by the JAX tests' emitters
(``build_torch_state_dict``, ``_emit_*``), with BatchNorm's
``num_batches_tracked`` and OpenPCDet's ``global_step`` beside.  The port's
``load_reference_state_dict`` must give a ``state_dict`` bit-equal to the
weight bridge's (``load_jax_variables``) on the same flax tree, read every
reference key but those two, and its flax tree must equal the JAX
converter's bit for bit.  ``utils/jax_weights.port_variables`` must give the
tree back.  The module cases (the dense and sparse voxel backbones) convert
the JAX tests' random ``state_dict`` and fill the port's module.

Beside: Voxel-RCNN over the sparse backbone and PDA-SSD through
``chip_smoke.reference_state_dict`` (the JAX-free emitter the card's phase
22 writes its ``.pth`` with); the shipped ``PartA2_free.yaml`` at full
width; the refusals (CaDDN with the JAX converter's message, the
multi-head anchor head and PDA-SSD's four ablations, each confirmed against
the JAX converter); and the full-model twin of
``tests/test_full_model_torch_parity.py``, its ``state_dict`` converted
into the port, the port's forward held to the twin's with the port's
sampling and ball-query indices fed to the twin, at that test's tolerances.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import ckpt_converter as j_conv  # noqa: E402
import chip_smoke  # noqa: E402
from model_cfg import tiny_model_cfg  # noqa: E402
from pdanet_tpu.datasets.dataset import DatasetTemplate as JDatasetTemplate  # noqa: E402
from pdanet_tpu.models import build_network as j_build  # noqa: E402
from pdanet_tpu.models.detectors.part_a2_free import PartA2Free as JPartA2Free  # noqa: E402
from pdanet_tpu.utils.easydict import EasyDict as JEasyDict  # noqa: E402
from pdanet_tpu_torch.config import cfg_from_yaml_file  # noqa: E402
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate  # noqa: E402
from pdanet_tpu_torch.models import build_network  # noqa: E402
from pdanet_tpu_torch.models.backbones_3d import sparse_backbone, voxel_backbone  # noqa: E402
from pdanet_tpu_torch.tools import ckpt_converter as conv  # noqa: E402
from pdanet_tpu_torch.utils.easydict import EasyDict  # noqa: E402
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables, port_variables  # noqa: E402
from test_converter import (  # noqa: E402
    TrackingDict, _emit_bn, _emit_conv2d, _emit_conv3d_spconv, _tree_paths,
    build_torch_state_dict,
)
from test_converter_two_stage import (  # noqa: E402
    _emit_bev_backbone, _emit_conv3d_seq, _emit_dense_unet, _emit_fc_bn_stack, _emit_first_stage,
    _emit_mlpstack, _emit_plain_mlp, _emit_vector_pool,
)
from test_torch_parta2 import random_variables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CLASSES = ("Car", "Pedestrian")
VOXEL = (0.2, 0.2, 0.5)  # the JAX converter tests' voxel families
PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
UNREAD = ("num_batches_tracked", "global_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _with_unread_keys(sd):
    """``sd`` with the keys a reference ``.pth`` holds and no converter
    reads: each BatchNorm's ``num_batches_tracked``, the detector's
    ``global_step``."""
    out = dict(sd)
    for key in sd:
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = np.asarray(7)
    out["global_step"] = np.asarray([7])
    return out


def _unread(tracking):
    return sorted(k for k in set(tracking) - tracking.read if not k.endswith(UNREAD))


def _assert_bit_equal(got, want):
    """Two flax trees (or two state_dicts) equal in paths, dtypes and bits."""
    got, want = _tree_paths(got), _tree_paths(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for path, arr in want.items():
        g, w = np.asarray(got[path]), np.asarray(arr)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


# ---- the families: (JAX model, its init arguments, the port model, emitter)


def _voxel_inputs(seed, points=False):
    from test_pvrcnn import _make_inputs as pv_inputs
    from test_second import _make_inputs

    return pv_inputs(seed=seed) if points else _make_inputs(seed=seed)


def _voxel_geometry():
    from test_second import GRID

    return dict(grid_size=GRID, voxel_size=VOXEL, point_cloud_range=PCR, class_names=CLASSES)


def _emit_iassd(variables, cfg):
    return build_torch_state_dict(variables, cfg)


def _emit_pointpillar(variables, cfg):
    """``test_pointpillar_converter_roundtrip``'s emission."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for name, lp in params["vfe"].items():
        i = name.replace("pfn_layers_", "")
        sd[f"vfe.pfn_layers.{i}.linear.weight"] = np.asarray(lp["linear"]["kernel"]).T
        _emit_bn(sd, f"vfe.pfn_layers.{i}.norm", lp["norm"], stats["vfe"][name]["norm"])
    _emit_bev_backbone(sd, "backbone_2d", params["backbone_2d"], stats["backbone_2d"],
                       cfg.BACKBONE_2D)
    for hname, hp in params["dense_head"].items():
        _emit_conv2d(sd, f"dense_head.{hname}", hp["kernel"], hp["bias"])
    return sd


def _emit_centerpoint(variables, cfg):
    """``test_centerpoint_converter_roundtrip``'s emission (zero conv biases
    in the residual blocks)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    bp, bs = params["backbone_3d"], stats["backbone_3d"]

    def seq3d(flax_name, prefix):
        _emit_conv3d_spconv(sd, prefix + ".0", bp[flax_name]["Conv_0"]["kernel"])
        _emit_bn(sd, prefix + ".1", bp[flax_name]["BatchNorm_0"], bs[flax_name]["BatchNorm_0"])

    def res(flax_name, prefix):
        for c, b in (("conv1", "bn1"), ("conv2", "bn2")):
            k = bp[flax_name][c]["kernel"]
            _emit_conv3d_spconv(sd, f"{prefix}.{c}", k, bias=np.zeros(k.shape[-1], np.float32))
            _emit_bn(sd, f"{prefix}.{b}", bp[flax_name][b], bs[flax_name][b])

    seq3d("conv_input", "backbone_3d.conv_input")
    res("res1_a", "backbone_3d.conv1.0")
    res("res1_b", "backbone_3d.conv1.1")
    for lvl in (2, 3, 4):
        seq3d(f"conv{lvl}_down", f"backbone_3d.conv{lvl}.0")
        res(f"res{lvl}_a", f"backbone_3d.conv{lvl}.1")
        res(f"res{lvl}_b", f"backbone_3d.conv{lvl}.2")
    seq3d("conv_out", "backbone_3d.conv_out")
    _emit_bev_backbone(sd, "backbone_2d", params["backbone_2d"], stats["backbone_2d"],
                       cfg.BACKBONE_2D)
    hp, hs = params["dense_head"], stats["dense_head"]
    _emit_conv2d(sd, "dense_head.shared_conv.0", hp["shared_conv"]["kernel"],
                 hp["shared_conv"].get("bias"))
    _emit_bn(sd, "dense_head.shared_conv.1", hp["shared_bn"], hs["shared_bn"])
    head_dict = {k: dict(v) for k, v in dict(cfg.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT).items()}
    head_dict["hm"] = {"out_channels": len(CLASSES), "num_conv": int(cfg.DENSE_HEAD.NUM_HM_CONV)}
    for name, spec in head_dict.items():
        nc = int(spec["num_conv"])
        for k in range(nc - 1):
            lp = hp["head_0"][f"{name}_conv{k}"]
            _emit_conv2d(sd, f"dense_head.heads_list.0.{name}.{k}.0", lp["kernel"],
                         lp.get("bias"))
            _emit_bn(sd, f"dense_head.heads_list.0.{name}.{k}.1", hp["head_0"][f"{name}_bn{k}"],
                     hs["head_0"][f"{name}_bn{k}"])
        fin = hp["head_0"][f"{name}_out"]
        _emit_conv2d(sd, f"dense_head.heads_list.0.{name}.{nc - 1}", fin["kernel"], fin["bias"])
    return sd


def _emit_rcnn_heads(sd, rp, rs, roi, heads, pred_dims):
    """The cls / reg (or IoU) stacks of a RoI head with the Dropout slot
    after the first layer, and their final layers."""
    dp = float(roi.DP_RATIO)
    for prefix, torch_name, pred, fcs in heads:
        idx = _emit_fc_bn_stack(sd, f"roi_head.{torch_name}", rp, rs, len(fcs),
                                lambda k: dp >= 0 and k == 0, prefix)
        w = np.asarray(rp[pred]["kernel"]).T
        sd[f"roi_head.{torch_name}.{idx}.weight"] = w.reshape(w.shape + (1,) * (pred_dims - 2))
        sd[f"roi_head.{torch_name}.{idx}.bias"] = np.asarray(rp[pred]["bias"])


def _emit_shared_fc(sd, rp, rs, roi):
    dp, n = float(roi.DP_RATIO), len(roi.SHARED_FC)
    _emit_fc_bn_stack(sd, "roi_head.shared_fc_layer", rp, rs, n,
                      lambda k: k != n - 1 and dp > 0, "shared")


def _emit_second_iou(variables, cfg):
    """``test_second_iou_converter_roundtrip``'s emission."""
    sd = {}
    _emit_first_stage(sd, variables, cfg)
    rp, rs = variables["params"]["roi_head"], variables["batch_stats"]["roi_head"]
    _emit_shared_fc(sd, rp, rs, cfg.ROI_HEAD)
    _emit_rcnn_heads(sd, rp, rs, cfg.ROI_HEAD, [("iou", "iou_layers", "iou_out",
                                                 cfg.ROI_HEAD.IOU_FC)], 2)
    return sd


def _emit_voxel_rcnn_head(sd, rp, rs, roi):
    """``test_voxel_rcnn_converter_roundtrip``'s RoI head emission."""
    dp = float(roi.DP_RATIO)
    for k, src in enumerate(roi.ROI_GRID_POOL.FEATURES_SOURCE):
        pp, ps = rp[f"pool_{src}"], rs[f"pool_{src}"]
        base = f"roi_head.roi_grid_pool_layers.{k}"
        for tname, fname in (("mlps_in.0", "in"), ("mlps_pos.0", "pos"), ("mlps_out.0", "out")):
            sd[f"{base}.{tname}.0.weight"] = np.asarray(pp[f"mlp_{fname}"]["kernel"]).T[:, :, None]
            _emit_bn(sd, f"{base}.{tname}.1", pp[f"bn_{fname}"], ps[f"bn_{fname}"])
    for torch_name, prefix, fcs in (("shared_fc_layer", "shared", roi.SHARED_FC),
                                    ("cls_fc_layers", "cls", roi.CLS_FC),
                                    ("reg_fc_layers", "reg", roi.REG_FC)):
        n = len(fcs)
        _emit_fc_bn_stack(sd, f"roi_head.{torch_name}", rp, rs, n,
                          lambda k, n=n: k != n - 1 and dp > 0, prefix)
    for torch_name, flax_name in (("cls_pred_layer", "cls_pred"), ("reg_pred_layer", "reg_pred")):
        sd[f"roi_head.{torch_name}.weight"] = np.asarray(rp[flax_name]["kernel"]).T
        sd[f"roi_head.{torch_name}.bias"] = np.asarray(rp[flax_name]["bias"])


def _emit_voxel_rcnn(variables, cfg):
    sd = {}
    _emit_first_stage(sd, variables, cfg)
    _emit_voxel_rcnn_head(sd, variables["params"]["roi_head"],
                          variables["batch_stats"]["roi_head"], cfg.ROI_HEAD)
    return sd


def _emit_pointrcnn(variables, cfg):
    """``test_pointrcnn_converter_roundtrip``'s emission."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    bb_p, bb_s = params["backbone_3d"], stats["backbone_3d"]
    for mod, mp in bb_p.items():
        if mod.startswith("SA_modules_"):
            k = mod.replace("SA_modules_", "")
            for sub, sp in mp.items():
                _emit_mlpstack(sd, f"backbone_3d.SA_modules.{k}.mlps.{sub.replace('mlps_', '')}",
                               sp, bb_s[mod][sub])
        elif mod.startswith("FP_modules_"):
            _emit_mlpstack(sd, f"backbone_3d.FP_modules.{mod.replace('FP_modules_', '')}.mlp",
                           mp["mlp"], bb_s[mod]["mlp"])
    hp, hs = params["point_head"], stats["point_head"]
    for prefix, torch_name, fc_key in (("cls", "cls_layers", "CLS_FC"),
                                       ("box", "box_layers", "REG_FC")):
        idx = _emit_fc_bn_stack(sd, f"point_head.{torch_name}", hp, hs,
                                len(cfg.POINT_HEAD[fc_key]), lambda k: False, prefix)
        sd[f"point_head.{torch_name}.{idx}.weight"] = np.asarray(hp[f"{prefix}_out"]["kernel"]).T
        sd[f"point_head.{torch_name}.{idx}.bias"] = np.asarray(hp[f"{prefix}_out"]["bias"])
    rp, rs, roi = params["roi_head"], stats["roi_head"], cfg.ROI_HEAD
    use_bn = bool(roi.USE_BN)
    _emit_plain_mlp(sd, "roi_head.xyz_up_layer", rp["xyz_up"], rs.get("xyz_up", {}),
                    len(roi.XYZ_UP_LAYER), use_bn)
    _emit_plain_mlp(sd, "roi_head.merge_down_layer", rp["merge_down"], rs.get("merge_down", {}),
                    1, use_bn)
    for k in range(len(roi.SA_CONFIG.NPOINTS)):
        _emit_plain_mlp(sd, f"roi_head.SA_modules.{k}.mlps.0", rp[f"SA_{k}"]["mlp"],
                        rs[f"SA_{k}"]["mlp"], len(roi.SA_CONFIG.MLPS[k]), True)
    _emit_rcnn_heads(sd, rp, rs, roi, [("cls", "cls_layers", "cls_out", roi.CLS_FC),
                                       ("reg", "reg_layers", "reg_out", roi.REG_FC)], 3)
    return sd


def _emit_pv_common(sd, variables, cfg, emit_source):
    """PV-RCNN's (and PV-RCNN++'s) emission after the first stage: the
    PFE's sources by ``emit_source``, the fusion, the point head, the RoI
    head's shared / cls / reg stacks."""
    params, stats = variables["params"], variables["batch_stats"]
    pp, ps = params["pfe"], stats["pfe"]
    sources = [s for s in cfg.PFE.FEATURES_SOURCE if s not in ("bev", "raw_points")]
    for name in pp:
        if name == "SA_rawpoints":
            emit_source("pfe.SA_rawpoints", pp[name], ps[name], "raw_points")
        elif name.startswith("SA_"):
            emit_source(f"pfe.SA_layers.{sources.index(name[3:])}", pp[name], ps[name], name[3:])
    sd["pfe.vsa_point_feature_fusion.0.weight"] = np.asarray(pp["fusion"]["kernel"]).T
    _emit_bn(sd, "pfe.vsa_point_feature_fusion.1", pp["fusion_bn"], ps["fusion_bn"])
    hp, hs = params["point_head"], stats["point_head"]
    idx = _emit_fc_bn_stack(sd, "point_head.cls_layers", hp, hs, len(cfg.POINT_HEAD.CLS_FC),
                            lambda k: False, "cls")
    sd[f"point_head.cls_layers.{idx}.weight"] = np.asarray(hp["cls_out"]["kernel"]).T
    sd[f"point_head.cls_layers.{idx}.bias"] = np.asarray(hp["cls_out"]["bias"])
    rp, rs, roi = params["roi_head"], stats["roi_head"], cfg.ROI_HEAD
    _emit_shared_fc(sd, rp, rs, roi)
    _emit_rcnn_heads(sd, rp, rs, roi, [("cls", "cls_layers", "cls_pred", roi.CLS_FC),
                                       ("reg", "reg_layers", "reg_pred", roi.REG_FC)], 3)


def _emit_pvrcnn(variables, cfg):
    """``test_pvrcnn_converter_roundtrip``'s emission."""
    sd = {}
    _emit_first_stage(sd, variables, cfg)

    def msg(base, mp, ms, _src):
        for sub, sp in mp.items():
            _emit_mlpstack(sd, f"{base}.mlps.{sub.replace('mlps_', '')}", sp, ms[sub])

    _emit_pv_common(sd, variables, cfg, msg)
    rp, rs = variables["params"]["roi_head"], variables["batch_stats"]["roi_head"]
    msg("roi_head.roi_grid_pool_layer", rp["roi_grid_pool"], rs["roi_grid_pool"], None)
    return sd


def _emit_pvrcnn_pp(variables, cfg):
    """``test_pvrcnn_pp_converter_roundtrip``'s emission."""
    sd = {}
    _emit_first_stage(sd, variables, cfg)
    _emit_pv_common(sd, variables, cfg, lambda base, mp, ms, src: _emit_vector_pool(
        sd, base, mp, ms, cfg.PFE.SA_LAYER[src]))
    rp, rs = variables["params"]["roi_head"], variables["batch_stats"]["roi_head"]
    _emit_vector_pool(sd, "roi_head.roi_grid_pool_layer", rp["roi_grid_pool"],
                      rs["roi_grid_pool"], cfg.ROI_HEAD.ROI_GRID_POOL)
    return sd


def _emit_parta2_heads(sd, variables, cfg):
    """The intra-part point head (its box layers too where it has them)
    and the Part-A2 RoI head of ``test_parta2_converter_roundtrip``."""
    params, stats = variables["params"], variables["batch_stats"]
    hp, hs = params["point_head"], stats.get("point_head", {})
    heads = [("cls", "cls_layers", cfg.POINT_HEAD.CLS_FC),
             ("part", "part_reg_layers", cfg.POINT_HEAD.PART_FC)]
    if "box_out" in hp:
        heads.append(("box", "box_layers", cfg.POINT_HEAD.REG_FC))
    for prefix, torch_name, fcs in heads:
        idx = _emit_fc_bn_stack(sd, f"point_head.{torch_name}", hp, hs, len(fcs),
                                lambda k: False, prefix)
        sd[f"point_head.{torch_name}.{idx}.weight"] = np.asarray(hp[f"{prefix}_out"]["kernel"]).T
        sd[f"point_head.{torch_name}.{idx}.bias"] = np.asarray(hp[f"{prefix}_out"]["bias"])
    rp, rs, roi = params["roi_head"], stats["roi_head"], cfg.ROI_HEAD
    for base in ("conv_part", "conv_rpn"):
        for j, suffix in enumerate(("a", "b")):
            _emit_conv3d_seq(sd, f"roi_head.{base}.{j}", rp, rs, f"{base}_{suffix}")
    _emit_shared_fc(sd, rp, rs, roi)
    _emit_rcnn_heads(sd, rp, rs, roi, [("cls", "cls_layers", "cls_pred", roi.CLS_FC),
                                       ("reg", "reg_layers", "reg_pred", roi.REG_FC)], 3)


def _emit_parta2(variables, cfg):
    sd = {}
    params, stats = variables["params"], variables["batch_stats"]
    _emit_dense_unet(sd, "backbone_3d", params["backbone_3d"], stats["backbone_3d"])
    _emit_bev_backbone(sd, "backbone_2d", params["backbone_2d"], stats["backbone_2d"],
                       cfg.BACKBONE_2D)
    for hname, hp in params["dense_head"].items():
        _emit_conv2d(sd, f"dense_head.{hname}", hp["kernel"], hp["bias"])
    _emit_parta2_heads(sd, variables, cfg)
    return sd


def _emit_sparse_block(sd, prefix, kernel, bn, stats):
    """A sparse conv's (K, in, out) taps as spconv 1.x's (kz, ky, kx, in,
    out) and its BatchNorm: the inverse of ``convert_sparse_unet``'s
    blocks."""
    sd[f"{prefix}.0.weight"] = chip_smoke._ref_spconv(kernel)
    _emit_bn(sd, f"{prefix}.1", bn, stats)


def _emit_sparse_unet(sd, prefix, bp, bs):
    """The sparse UNetV2 (``SparseUNetV2``) into the reference's
    ``spconv_unet`` keys: the inverse of ``convert_sparse_unet``."""
    _emit_sparse_block(sd, f"{prefix}.conv_input", bp["conv_input"]["kernel"],
                       bp["conv_input"]["bn"], bs["conv_input"]["bn"])
    _emit_sparse_block(sd, f"{prefix}.conv1.0", bp["conv1"]["kernel"], bp["conv1"]["bn"],
                       bs["conv1"]["bn"])
    for lvl in (2, 3, 4):
        _emit_sparse_block(sd, f"{prefix}.conv{lvl}.0", bp[f"conv{lvl}_down_kernel"],
                           bp[f"conv{lvl}_down_bn"], bs[f"conv{lvl}_down_bn"])
        for i, suf in ((1, "a"), (2, "b")):
            name = f"conv{lvl}_{suf}"
            _emit_sparse_block(sd, f"{prefix}.conv{lvl}.{i}", bp[name]["kernel"], bp[name]["bn"],
                               bs[name]["bn"])
    if "conv_out_kernel" in bp:
        _emit_sparse_block(sd, f"{prefix}.conv_out", bp["conv_out_kernel"], bp["conv_out_bn"],
                           bs["conv_out_bn"])
    for k in (4, 3, 2, 1):
        up, us = bp[f"ur{k}"], bs[f"ur{k}"]
        for i in (1, 2):
            t = up["conv_up_t"]
            sd[f"{prefix}.conv_up_t{k}.conv{i}.weight"] = chip_smoke._ref_spconv(t[f"kernel{i}"])
            _emit_bn(sd, f"{prefix}.conv_up_t{k}.bn{i}", t[f"bn{i}"], us["conv_up_t"][f"bn{i}"])
        _emit_sparse_block(sd, f"{prefix}.conv_up_m{k}", up["conv_up_m"]["kernel"],
                           up["conv_up_m"]["bn"], us["conv_up_m"]["bn"])
        if k > 1:
            _emit_sparse_block(sd, f"{prefix}.inv_conv{k}", bp[f"inv_conv{k}"]["kernel"],
                               bp[f"inv_conv{k}"]["bn"], bs[f"inv_conv{k}"]["bn"])
    _emit_sparse_block(sd, f"{prefix}.conv5.0", bp["conv5"]["kernel"], bp["conv5"]["bn"],
                       bs["conv5"]["bn"])


def _emit_parta2_free(variables, cfg):
    sd = {}
    _emit_sparse_unet(sd, "backbone_3d", variables["params"]["backbone_3d"],
                      variables["batch_stats"]["backbone_3d"])
    _emit_parta2_heads(sd, variables, cfg)
    return sd


def _case_iassd():
    cfg = EasyDict(tiny_model_cfg(3))
    jmodel = j_build(cfg, num_class=3, input_channels=4)
    return (cfg, jmodel, (np.zeros((1, 128, 4), np.float32),), 3, None,
            lambda: build_network(cfg, 3, device="cpu"), _emit_iassd)


def _case_pointpillar():
    from test_pointpillar import GRID, PCR as PP_PCR, PP_MODEL_CFG, VOXEL as PP_VOXEL

    cfg = EasyDict(copy.deepcopy(PP_MODEL_CFG))
    geometry = dict(grid_size=GRID, voxel_size=tuple(PP_VOXEL), point_cloud_range=tuple(PP_PCR),
                    class_names=CLASSES)
    V, P = 32, 8
    args = (np.zeros((1, V, P, 4), np.float32), np.zeros((1, V, 3), np.int32),
            np.zeros((1, V), np.int32))
    return (cfg, j_build(JEasyDict(cfg), num_class=2, input_channels=4, **geometry), args, 2,
            CLASSES, lambda: build_network(cfg, 2, device="cpu", **geometry), _emit_pointpillar)


def _voxel_case(cfg, emit, points=False, geometry=None, seed=11):
    cfg = EasyDict(copy.deepcopy(dict(cfg)))
    geometry = geometry or _voxel_geometry()
    return (cfg, j_build(JEasyDict(cfg), num_class=2, input_channels=4, **geometry),
            _voxel_inputs(seed, points), 2, CLASSES,
            lambda: build_network(cfg, 2, device="cpu", **geometry), emit)


def _case_centerpoint():
    from test_centerpoint import CP_MODEL_CFG

    return _voxel_case(CP_MODEL_CFG, _emit_centerpoint)


def _case_second_iou():
    from test_two_stage import _second_iou_tiny_cfg

    return _voxel_case(_second_iou_tiny_cfg(), _emit_second_iou)


def _case_voxel_rcnn():
    from test_two_stage import _voxel_rcnn_tiny_cfg

    return _voxel_case(_voxel_rcnn_tiny_cfg(), _emit_voxel_rcnn, seed=12)


def _case_voxel_rcnn_sparse():
    from test_torch_voxel_rcnn import vrcnn_cfg

    return _voxel_case(vrcnn_cfg(), lambda v, cfg: chip_smoke.reference_state_dict(v, cfg))


def _case_pointrcnn():
    from test_pointrcnn import POINTRCNN_MODEL_CFG

    cfg = EasyDict(copy.deepcopy(POINTRCNN_MODEL_CFG))
    return (cfg, j_build(JEasyDict(cfg), num_class=2, input_channels=4, class_names=CLASSES),
            (np.zeros((1, 256, 4), np.float32),), 2, CLASSES,
            lambda: build_network(cfg, 2, device="cpu", class_names=CLASSES), _emit_pointrcnn)


def _case_pvrcnn():
    from test_pvrcnn import PVRCNN_MODEL_CFG

    return _voxel_case(PVRCNN_MODEL_CFG, _emit_pvrcnn, points=True, seed=13)


def _case_pvrcnn_pp():
    from test_pvrcnn_pp import GRID, PC_RANGE, VOXEL_SIZE, _pp_cfg

    geometry = dict(grid_size=GRID, voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
                    class_names=CLASSES)
    return _voxel_case(_pp_cfg(), _emit_pvrcnn_pp, points=True, geometry=geometry, seed=23)


def _case_parta2():
    from test_parta2 import PARTA2_MODEL_CFG

    return _voxel_case(PARTA2_MODEL_CFG, _emit_parta2, seed=17)


CASES = {"iassd": _case_iassd, "pointpillar": _case_pointpillar,
         "centerpoint": _case_centerpoint, "second_iou": _case_second_iou,
         "voxel_rcnn": _case_voxel_rcnn, "voxel_rcnn_sparse": _case_voxel_rcnn_sparse,
         "pointrcnn": _case_pointrcnn, "pvrcnn": _case_pvrcnn, "pvrcnn_pp": _case_pvrcnn_pp,
         "parta2": _case_parta2}


def _check_family(cfg, jmodel, args, num_class, class_names, build, emit, seed=0):
    variables = random_variables(jmodel, args, seed)
    sd = _with_unread_keys(emit(variables, cfg))
    # the JAX converter maps the emitted dict back onto the tree
    _assert_bit_equal(j_conv.convert_checkpoint_any(
        dict(sd), JEasyDict(cfg), num_class=num_class, class_names=list(class_names or [])),
        variables)
    tracking = TrackingDict(sd)
    got = build()
    conv.load_reference_state_dict(got, tracking, cfg, num_class, class_names)
    assert not _unread(tracking), _unread(tracking)[:10]
    want = load_jax_variables(build(), variables)
    _assert_bit_equal(_state(got), _state(want))
    _assert_bit_equal(port_variables(got), variables)
    _assert_bit_equal(conv.reference_variables(sd, cfg, num_class, class_names), variables)


@pytest.mark.parametrize("family", sorted(CASES))
def test_reference_state_dict_into_the_port(family):
    """Every family the JAX converter maps, at its roundtrip's tiny config:
    the port's state_dict bit-equal to the bridge's on the emitting tree,
    every reference key read but ``num_batches_tracked`` / ``global_step``."""
    _check_family(*CASES[family]())


def _random_backbone_sd(rng, c_in, widths, c_out, res=False, input_bias=True):
    """The JAX structure tests' random spconv ``state_dict`` of
    VoxelBackBone8x (``res``: VoxelResBackBone8x, biased residual convs;
    ``input_bias``: a bias on ``conv_input``, which the sparse converters
    fold into its BatchNorm's mean)."""
    def seq(sd, prefix, cin, cout, k=(3, 3, 3), bias=False):
        sd[prefix + ".0.weight"] = rng.randn(*k, cin, cout).astype(np.float32)
        if bias:
            sd[prefix + ".0.bias"] = rng.randn(cout).astype(np.float32)
        sd[prefix + ".1.weight"] = rng.rand(cout).astype(np.float32)
        sd[prefix + ".1.bias"] = rng.randn(cout).astype(np.float32)
        sd[prefix + ".1.running_mean"] = rng.randn(cout).astype(np.float32)
        sd[prefix + ".1.running_var"] = rng.rand(cout).astype(np.float32)

    def resblock(sd, prefix, c):
        for i in (1, 2):
            sd[f"{prefix}.conv{i}.weight"] = rng.randn(3, 3, 3, c, c).astype(np.float32)
            sd[f"{prefix}.conv{i}.bias"] = rng.randn(c).astype(np.float32)
            sd[f"{prefix}.bn{i}.weight"] = rng.rand(c).astype(np.float32)
            sd[f"{prefix}.bn{i}.bias"] = rng.randn(c).astype(np.float32)
            sd[f"{prefix}.bn{i}.running_mean"] = rng.randn(c).astype(np.float32)
            sd[f"{prefix}.bn{i}.running_var"] = rng.rand(c).astype(np.float32)

    sd = {}
    seq(sd, "conv_input", c_in, widths[0], bias=input_bias)
    if res:
        resblock(sd, "conv1.0", widths[1])
        resblock(sd, "conv1.1", widths[1])
    else:
        seq(sd, "conv1.0", widths[0], widths[1])
    for lvl in (2, 3, 4):
        cin, cout = widths[lvl - 1], widths[lvl]
        seq(sd, f"conv{lvl}.0", cin, cout)
        for i in (1, 2):
            if res:
                resblock(sd, f"conv{lvl}.{i}", cout)
            else:
                seq(sd, f"conv{lvl}.{i}", cout, cout)
    seq(sd, "conv_out", widths[4], c_out, k=(3, 1, 1))
    return sd


BACKBONES = {
    # name: (the JAX test's converter, seed, widths, c_out, res, the port's module)
    "dense": (lambda t, w, c: j_conv.convert_voxel_backbone_dense(t, w, c, input_channels=4),
              lambda t, w, c: conv.convert_voxel_backbone_dense(t, w, c, input_channels=4),
              29, [4, 4, 8, 12, 12], 16, False,
              lambda w, c: voxel_backbone.VoxelBackBone8x(
                  {"NUM_FILTERS": w, "NUM_OUTPUT_FEATURES": c}, 4, (16, 16, 8))),
    "sparse": (lambda t, w, c: j_conv.convert_sparse_voxel_backbone(t, w, c, input_channels=4),
               lambda t, w, c: conv.convert_sparse_voxel_backbone(t, w, c, input_channels=4),
               31, [4, 4, 8, 12, 12], 16, False,
               lambda w, c: sparse_backbone.SparseVoxelBackBone8x(
                   {"NUM_FILTERS": w, "NUM_OUTPUT_FEATURES": c,
                    "ACTIVE_BUDGETS": [32, 32, 32, 32]}, 4, (16, 16, 8))),
    "sparse_res": (lambda t, w, c: j_conv.convert_sparse_voxel_res_backbone(t, input_channels=4),
                   lambda t, w, c: conv.convert_sparse_voxel_res_backbone(t, input_channels=4),
                   37, [16, 16, 32, 64, 128], 128, True,
                   lambda w, c: sparse_backbone.SparseVoxelResBackBone8x(
                       {"ACTIVE_BUDGETS": [32, 32, 32, 32]}, 4, (16, 16, 24))),
}


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_voxel_backbone_state_dict_into_the_port(backbone):
    """The structure tests of the dense (``tests/test_converter.py:1177``) and
    sparse voxel backbones (``tests/test_converter_two_stage.py:824, 899``):
    their random spconv ``state_dict`` (biases folded into the BatchNorm
    means), every key read, the port's converter's tree bit-equal to
    JAX's, and the port's module filled by it."""
    j_fn, p_fn, seed, widths, c_out, res, port = BACKBONES[backbone]
    sd = _random_backbone_sd(np.random.RandomState(seed), 4, widths, c_out, res,
                             input_bias=backbone != "dense")
    tracking = TrackingDict(sd)
    params, stats = p_fn(conv.TorchTree(tracking), widths, c_out)
    assert not _unread(tracking)
    want = j_fn(j_conv.TorchTree(dict(sd)), widths, c_out)
    _assert_bit_equal({"params": params, "batch_stats": stats},
                      {"params": want[0], "batch_stats": want[1]})
    module = port(widths, c_out)
    load_jax_variables(module, {"params": params, "batch_stats": stats})
    _assert_bit_equal(port_variables(module), {"params": want[0], "batch_stats": want[1]})
    # spconv 2.x's native layout (k, k, k, out, in) is transposed back
    sd2 = dict(sd)
    sd2["conv2.0.0.weight"] = np.ascontiguousarray(
        np.swapaxes(sd["conv2.0.0.weight"], -1, -2))
    p2, _ = p_fn(conv.TorchTree(sd2), widths, c_out)
    _assert_bit_equal(p2, params)


def test_shipped_parta2_free_yaml_converts_and_loads():
    """The shipped ``PartA2_free.yaml`` (MODEL.NAME PointRCNN over
    ``SparseUNetV2``) at full width: the converter dispatches it to the
    Part-A2 converter without the BEV stage, as the port's resolver builds
    ``PartA2Free``, and the port's model is filled bit for bit."""
    cfg = cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "kitti_models" / "PartA2_free.yaml"))
    ds = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                         training=False, root_path=".")
    jds = JDatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                           training=False, root_path=".")
    geometry = dict(grid_size=tuple(int(g) for g in jds.grid_size),
                    voxel_size=tuple(jds.voxel_size),
                    point_cloud_range=tuple(float(x) for x in jds.point_cloud_range),
                    class_names=tuple(cfg.CLASS_NAMES))
    jmodel = JPartA2Free(model_cfg=JEasyDict(cfg.MODEL), num_class=3, input_channels=4,
                         **geometry)
    args = (np.zeros((1, 64, 5, 4), np.float32), np.zeros((1, 64, 3), np.int32),
            np.zeros((1, 64), np.int32))
    _check_family(cfg.MODEL, jmodel, args, 3, list(cfg.CLASS_NAMES),
                  lambda: build_network(cfg.MODEL, 3, dataset=ds, device="cpu"),
                  _emit_parta2_free, seed=5)


def test_chip_smoke_emitter_equals_the_jax_tests():
    """``chip_smoke.reference_state_dict`` (the JAX-free emitter of the
    card's phase 22) gives the JAX test's ``build_torch_state_dict`` for
    PDA-SSD bit for bit; for Voxel-RCNN its dict converts back onto the
    tree (``test_reference_state_dict_into_the_port[voxel_rcnn_sparse]``)."""
    cfg, jmodel, args, *_ = _case_iassd()
    variables = random_variables(jmodel, args, 3)
    _assert_bit_equal(chip_smoke.reference_state_dict(variables, cfg),
                      build_torch_state_dict(variables, cfg))


# ---- the refusals


def _ablation(key):
    cfg = EasyDict(tiny_model_cfg(3))
    if key == "IOU_FC":
        cfg.POINT_HEAD.IOU_FC = [16]
    else:
        cfg.BACKBONE_3D.SA_CONFIG.update({
            "no_global": {"PDA_VARIANT": "no_global"},
            "encoder_layer": {"POINTFORMER_IMPL": "encoder_layer"},
            "cbam": {"PROPOSAL_AWARE_CBAM": True}}[key])
    return cfg


@pytest.mark.parametrize("ablation", ["no_global", "encoder_layer", "cbam", "IOU_FC"])
def test_pda_ssd_ablations_refused(ablation):
    """The JAX converter maps none of PDA-SSD's ablations: under the
    ablation's config, its tree of the shipped model's reference keys (all
    it reads) differs from the ablation's own tree in its leaves or their
    shapes; the port refuses each, naming it."""
    cfg = _ablation(ablation)
    jmodel = j_build(cfg, num_class=3, input_channels=4)
    variables = random_variables(jmodel, (np.zeros((1, 128, 4), np.float32),), 1)
    base = random_variables(j_build(EasyDict(tiny_model_cfg(3)), num_class=3, input_channels=4),
                            (np.zeros((1, 128, 4), np.float32),), 1)
    got = j_conv.convert_checkpoint(build_torch_state_dict(base, cfg), JEasyDict(cfg))
    shapes = lambda tree: {p: np.shape(a) for p, a in _tree_paths(tree).items()}  # noqa: E731
    assert shapes(got) != shapes(variables)
    with pytest.raises(NotImplementedError, match="IASSD ablation"):
        conv.load_reference_state_dict(build_network(cfg, 3, device="cpu"), {}, cfg, 3)


def test_multihead_and_caddn_refused():
    """``AnchorHeadMulti`` (``second_multihead.yaml``): the JAX converter
    reads none of its ``rpn_heads.*`` and leaves ``dense_head`` empty where
    JAX's own tree has the heads; the port refuses it.  CaDDN is refused
    with the JAX converter's message."""
    from test_torch_multihead import GEOMETRY as MH_GEOMETRY, multihead_cfg

    cfg = EasyDict(multihead_cfg())
    jmodel = j_build(JEasyDict(cfg), num_class=2, input_channels=4, **MH_GEOMETRY)
    tree = random_variables(jmodel, _voxel_inputs(11), 2)
    assert tree["params"]["dense_head"]
    sd = {"dense_head.rpn_heads.0.conv_cls.weight": np.zeros((2, 16, 1, 1), np.float32)}
    got = j_conv.convert_anchor_head_single(j_conv.TorchTree(sd).sub("dense_head"))
    assert got == {}
    with pytest.raises(NotImplementedError, match="AnchorHeadMulti"):
        conv.check_convertible(cfg)
    caddn = cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "kitti_models" / "CaDDN.yaml"))
    with pytest.raises(NotImplementedError) as want:
        j_conv.convert_checkpoint_any({}, JEasyDict(caddn.MODEL))
    with pytest.raises(NotImplementedError) as got:
        conv.reference_variables({}, caddn.MODEL, 3, caddn.CLASS_NAMES)
    assert str(got.value) == str(want.value)


def test_missing_reference_key_and_short_tree_raise_naming_the_model():
    cfg, jmodel, args, num_class, _, build, emit = _case_iassd()
    sd = emit(random_variables(jmodel, args, 4), cfg)
    short = dict(sd)
    short.pop("point_head.cls_center_layers.1.running_var")
    with pytest.raises(ValueError, match="IASSD: the reference state_dict lacks"):
        conv.load_reference_state_dict(build(), short, cfg, num_class)
    variables = conv.reference_variables(sd, cfg, num_class)
    del variables["batch_stats"]["point_head"]
    with pytest.raises(ValueError, match="IASSD: the converted reference checkpoint does not "
                                         "fill the port's model"):
        conv.fill_model(build(), variables, cfg)


# ---- the reference-shaped twin, its forward against the port's


def test_full_model_twin_converted_into_the_port():
    """``tests/test_full_model_torch_parity.py``'s reference-shaped torch
    twin of the tiny PDA-SSD, its ``state_dict`` (``num_batches_tracked``
    kept) through the port's converter; the port's forward on the same
    cloud, free-running, and the twin's reference backbone loop fed the
    port's sampling and ball-query indices: coordinates, sa_ins logits,
    centre features and cls / box logits within that test's tolerances."""
    from test_full_model_torch_parity import (_build_torch_twin, _gather_cf, _twin_sa_ellipsoid,
                                              _twin_sa_with)

    num_class, code_size = 3, 30
    cfg = EasyDict(tiny_model_cfg(num_class))
    sa_cfg = cfg.BACKBONE_3D.SA_CONFIG
    torch.manual_seed(20)
    twin, layer_meta = _build_torch_twin(torch, sa_cfg, cfg.POINT_HEAD, num_class, code_size)
    with torch.no_grad():
        for mod in twin.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.5, 2.0)
    twin.eval()
    sd = {k: v.numpy() for k, v in twin.state_dict().items()}
    tracking = TrackingDict(_with_unread_keys(sd))
    model = conv.load_reference_state_dict(build_network(cfg, num_class, device="cpu").eval(),
                                           tracking, cfg, num_class)
    assert not _unread(tracking), _unread(tracking)[:10]

    rng = np.random.RandomState(17)
    B, N = 2, 128
    xyz = rng.rand(B, N, 3).astype(np.float32) * np.array([6.0, 6.0, 3.0], np.float32)
    intensity = rng.rand(B, N, 1).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(np.concatenate([xyz, intensity], axis=-1)))

    n_layers = len(sa_cfg.NSAMPLE_LIST)
    enc_xyz, enc_feat = [torch.from_numpy(xyz)], [torch.from_numpy(intensity.transpose(0, 2, 1)
                                                                   .copy())]
    sa_ins = [None] * n_layers
    with torch.no_grad():
        for k in range(n_layers):
            mod = twin.backbone_3d.SA_modules[k]
            xin, fin = enc_xyz[sa_cfg.LAYER_INPUT[k]], enc_feat[sa_cfg.LAYER_INPUT[k]]
            kind = layer_meta[k][0]
            if kind == "vote":
                off = mod.ctr_reg(mod.mlp_modules(fin)).transpose(1, 2)
                lim = torch.tensor(sa_cfg.MAX_TRANSLATE_RANGE).view(1, 1, 3).float()
                li_xyz, li_feat = xin + torch.min(torch.max(off, -lim), lim), fin
                centers, ctr_offsets = li_xyz, off
            else:
                idx = out["sampled_idx"][k]
                idx = None if idx is None else idx.long()
                idxl = out["ball_query_idx"][k]
                idxl = [i.long() for i in idxl] if idxl else None
                if kind == "gather":
                    li_xyz = _gather_cf(torch, xin.transpose(1, 2), idx).transpose(1, 2)
                    li_feat, cls = _gather_cf(torch, fin, idx), None
                elif kind == "with":
                    ctr = enc_xyz[sa_cfg.CTR_INDEX[k]] if sa_cfg.CTR_INDEX[k] != -1 else None
                    li_xyz, li_feat, cls = _twin_sa_with(torch, mod, xin, fin, idx, idxl,
                                                         sa_cfg.NSAMPLE_LIST[k], ctr_xyz=ctr)
                else:
                    li_xyz, li_feat, cls = _twin_sa_ellipsoid(
                        torch, mod, xin, fin, idx, idxl, sa_cfg.RADIUS_LIST[k],
                        sa_cfg.NSAMPLE_LIST[k], layer_meta[k][1])
                sa_ins[k] = cls
            enc_xyz.append(li_xyz)
            enc_feat.append(li_feat)
        flat = enc_feat[-1].transpose(1, 2).reshape(-1, enc_feat[-1].shape[1])
        t_cls = twin.point_head.cls_center_layers(flat).reshape(B, -1, num_class)
        t_box = twin.point_head.box_center_layers(flat).reshape(B, -1, code_size)

    for k in range(n_layers):
        got, want = out["encoder_xyz"][k + 1].numpy(), enc_xyz[k + 1].numpy()
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer" and sa_cfg.CTR_INDEX[k] == -1:
            np.testing.assert_array_equal(got, want, err_msg=f"L{k}")
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"L{k}")
        if sa_ins[k] is not None:
            np.testing.assert_allclose(out["sa_ins_preds"][k].numpy(), sa_ins[k].numpy(),
                                       atol=3e-4, err_msg=f"sa_ins L{k}")
    np.testing.assert_allclose(out["centers"].numpy(), centers.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["ctr_offsets"].numpy(), ctr_offsets.numpy(), atol=1e-4)
    np.testing.assert_allclose(out["centers_features"].numpy(),
                               enc_feat[-1].transpose(1, 2).numpy(), atol=1e-3)
    np.testing.assert_allclose(out["batch_cls_preds"].numpy(), t_cls.numpy(), atol=2e-3)
    np.testing.assert_allclose(out["center_box_preds"].numpy(), t_box.numpy(), atol=2e-3)

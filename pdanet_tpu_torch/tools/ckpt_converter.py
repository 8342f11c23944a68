"""Reference checkpoint converter: a PDANet / OpenPCDet ``.pth`` into the
port.

    python -m pdanet_tpu_torch.tools.ckpt_converter --torch_ckpt <.pth> \\
        --cfg_file <yaml> --output <checkpoint>

The mapping is a copy of the JAX package's ``tools/ckpt_converter.py``
(``:21-1368``, numpy only): each ``convert_*`` reads a reference
``state_dict`` (torch layout, numpy arrays) and gives the flax variable
tree of the same model, and ``convert_checkpoint_any`` dispatches by
``MODEL.NAME``.  ``load_reference_state_dict`` chains that tree into the
weight bridge, ``utils/jax_weights.load_jax_variables``, which alone knows
the port's layouts.  Reference keys that no converter reads (BatchNorm's
``num_batches_tracked``, OpenPCDet's ``global_step``) are ignored; a
converted tree that leaves a port tensor empty raises, naming the model.

Layout translations of the mapping:
  Conv1d/Conv2d 1x1 weight (out, in, 1[, 1]) -> Dense kernel (in, out)
  Linear weight (out, in)                    -> Dense kernel (in, out)
  BatchNorm weight/bias/running_mean/var     -> bn scale/bias + batch_stats
  nn.MultiheadAttention in_proj (3d, d)      -> flax MHA q/k/v kernels
                                                (d, heads, head_dim)

What the JAX converter cannot map is refused (``check_convertible``):
CaDDN, ``AnchorHeadMulti`` and PDA-SSD's SA and head ablations.

``main`` reads the ``.pth`` (zip or legacy format) with
``torch.load(..., weights_only=True)``, builds the model on the CPU from
the yaml, fills it, and writes the port's checkpoint with
``train.train_utils.save_checkpoint``: ``model_state`` the port's
``state_dict``, ``epoch`` and ``it`` carried over, ``optimizer_state``
None, ``version`` ``converted+<the reference's version>``.  The test
CLI's ``--ckpt`` and the train CLI's ``--pretrained_model`` and ``--ckpt``
take it.
"""

import argparse

import numpy as np
import torch

from ..config import cfg_from_yaml_file
from ..datasets.dataset import DatasetTemplate
from ..models import build_network
from ..train.train_utils import save_checkpoint
from ..utils.jax_weights import load_jax_variables


def _dense(w):
    w = np.asarray(w)
    if w.ndim == 4:  # Conv2d 1x1
        w = w[:, :, 0, 0]
    elif w.ndim == 3:  # Conv1d k=1
        w = w[:, :, 0]
    return w.T  # (in, out)


class TorchTree:
    """Flat state_dict with prefix-scoped access."""

    def __init__(self, sd, prefix=""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name):
        return TorchTree(self.sd, self.prefix + name + ".")

    def __getitem__(self, key):
        return np.asarray(self.sd[self.prefix + key])

    def __contains__(self, key):
        return (self.prefix + key) in self.sd


def _bn(tree, params, stats, name="bn"):
    params[name] = {"scale": tree["weight"], "bias": tree["bias"]}
    stats[name] = {"mean": tree["running_mean"], "var": tree["running_var"]}


def convert_mlp_stack(tree, num_layers, stride=3, start=0):
    """[Conv, BN, ReLU] x n sequential -> MLPStack params/batch_stats."""
    params, stats = {}, {}
    for j in range(num_layers):
        conv = tree.sub(str(start + stride * j))
        bn = tree.sub(str(start + stride * j + 1))
        lp, ls = {}, {}
        lp["dense"] = {"kernel": _dense(conv["weight"])}
        if "bias" in conv:
            lp["dense"]["bias"] = conv["bias"]
        _bn(bn, lp, ls)
        params[f"layer{j}"] = lp
        stats[f"layer{j}"] = ls
    return params, stats


def convert_attention(tree, d_model, nhead):
    """nn.MultiheadAttention -> flax MultiHeadDotProductAttention."""
    hd = d_model // nhead
    in_w = tree["in_proj_weight"]  # (3d, d)
    in_b = tree["in_proj_bias"]  # (3d,)
    out = {}
    for i, name in enumerate(["query", "key", "value"]):
        w = in_w[i * d_model : (i + 1) * d_model]  # (d, d): (out, in)
        b = in_b[i * d_model : (i + 1) * d_model]
        out[name] = {
            "kernel": w.T.reshape(d_model, nhead, hd),
            "bias": b.reshape(nhead, hd),
        }
    wo = tree.sub("out_proj")["weight"]  # (d, d)
    bo = tree.sub("out_proj")["bias"]
    out["out"] = {"kernel": wo.T.reshape(nhead, hd, d_model), "bias": bo}
    return out


def convert_transformer_layer(tree, d_model, nhead):
    params = {
        "self_attn": convert_attention(tree.sub("self_attn"), d_model, nhead),
        "norm1": {"scale": tree.sub("norm1")["weight"], "bias": tree.sub("norm1")["bias"]},
        "norm2": {"scale": tree.sub("norm2")["weight"], "bias": tree.sub("norm2")["bias"]},
        "linear1": {"kernel": tree.sub("linear1")["weight"].T, "bias": tree.sub("linear1")["bias"]},
        "linear2": {"kernel": tree.sub("linear2")["weight"].T, "bias": tree.sub("linear2")["bias"]},
    }
    return params


def convert_densitynet(tree):
    params, stats = {}, {}
    for j in range(3):
        conv = tree.sub(f"mlp_convs.{j}")
        bn = tree.sub(f"mlp_bns.{j}")
        params[f"conv{j}"] = {"kernel": _dense(conv["weight"]), "bias": conv["bias"]}
        params[f"bn{j}"] = {"scale": bn["weight"], "bias": bn["bias"]}
        stats[f"bn{j}"] = {"mean": bn["running_mean"], "var": bn["running_var"]}
    return params, stats


def convert_fc_head(tree, fc_cfg):
    """make_fc_layers: [Linear(no bias), BN1d, ReLU] x n + Linear(bias).

    Returns (mlpstack params, mlpstack stats, final dense params).
    """
    params, stats = {}, {}
    for j in range(len(fc_cfg)):
        lin = tree.sub(str(3 * j))
        bn = tree.sub(str(3 * j + 1))
        lp = {"dense": {"kernel": lin["weight"].T}}
        ls = {}
        _bn(bn, lp, ls)
        params[f"layer{j}"] = lp
        stats[f"layer{j}"] = ls
    final = tree.sub(str(3 * len(fc_cfg)))
    return params, stats, {"kernel": final["weight"].T, "bias": final["bias"]}


def convert_sa_withsampling(tree, mlps, aggregation_mlp, confidence_mlp):
    params, stats = {}, {}
    for i, spec in enumerate(mlps):
        p, s = convert_mlp_stack(tree.sub(f"mlps.{i}"), len(spec) - 1)
        params[f"mlps_{i}"] = p
        stats[f"mlps_{i}"] = s
    if aggregation_mlp:
        p, s = convert_mlp_stack(tree.sub("aggregation_layer"), len(aggregation_mlp))
        params["aggregation_layer"] = p
        stats["aggregation_layer"] = s
    if confidence_mlp:
        p, s = convert_mlp_stack(tree.sub("confidence_layers"), len(confidence_mlp))
        params["confidence_mlp"] = p
        stats["confidence_mlp"] = s
        final = tree.sub(f"confidence_layers.{3 * len(confidence_mlp)}")
        params["confidence_out"] = {
            "kernel": _dense(final["weight"]), "bias": final["bias"],
        }
    return params, stats


def convert_sa_ellipsoid(tree, mlps, aggregation_mlp, confidence_mlp):
    params, stats = {}, {}
    for i, spec in enumerate(mlps):
        d = spec[0]
        p, s = convert_mlp_stack(tree.sub(f"position_mlp.{i}"), 2)
        params[f"position_mlp_{i}"], stats[f"position_mlp_{i}"] = p, s
        p, s = convert_mlp_stack(tree.sub(f"global_mlps.{i}"), 2)
        params[f"global_mlps_{i}"], stats[f"global_mlps_{i}"] = p, s
        p, s = convert_densitynet(tree.sub(f"point_density.{i}.densitynet"))
        params[f"point_density_{i}"], stats[f"point_density_{i}"] = p, s
        params[f"Local_pointformer_{i}"] = convert_transformer_layer(
            tree.sub(f"Local_pointformer.{i}"), 4 * d, 4
        )
        p, s = convert_mlp_stack(tree.sub(f"fin_conv.{i}"), 2)
        params[f"fin_conv_{i}"], stats[f"fin_conv_{i}"] = p, s
    if aggregation_mlp:
        p, s = convert_mlp_stack(tree.sub("aggregation_layer"), len(aggregation_mlp))
        params["aggregation_layer"], stats["aggregation_layer"] = p, s
    if confidence_mlp:
        p, s = convert_mlp_stack(tree.sub("confidence_layers"), len(confidence_mlp))
        params["confidence_mlp"], stats["confidence_mlp"] = p, s
        final = tree.sub(f"confidence_layers.{3 * len(confidence_mlp)}")
        params["confidence_out"] = {
            "kernel": _dense(final["weight"]), "bias": final["bias"],
        }
    return params, stats


def convert_vote_layer(tree, mlp_list):
    params, stats = {}, {}
    if mlp_list:
        p, s = convert_mlp_stack(tree.sub("mlp_modules"), len(mlp_list))
        params["mlp_modules"], stats["mlp_modules"] = p, s
    params["ctr_reg"] = {
        "kernel": _dense(tree.sub("ctr_reg")["weight"]),
        "bias": tree.sub("ctr_reg")["bias"],
    }
    return params, stats


def _conv2d_kernel(w):
    """torch Conv2d weight (out, in, kh, kw) -> flax Conv kernel
    (kh, kw, in, out)."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _deconv2d_kernel(w):
    """torch ConvTranspose2d weight (in, out, kh, kw) -> flax ConvTranspose
    kernel (kh, kw, in, out).

    flax's ConvTranspose (transpose_kernel=False) runs an input-dilated
    correlation, which is the torch gradient-of-conv semantics with the
    spatial axes mirrored — so the taps are flipped here (verified by the
    activation-parity test in tests/test_converter.py)."""
    w = np.transpose(np.asarray(w), (2, 3, 0, 1))
    return w[::-1, ::-1]


def convert_pillar_vfe(tree, num_filters):
    """PillarVFE pfn_layers.{i}.{linear,norm} (pillar_vfe.py PFNLayer) ->
    flax PFNLayer {linear, norm}."""
    params, stats = {}, {}
    for i in range(len(num_filters)):
        lt = tree.sub(f"pfn_layers.{i}")
        lp = {"linear": {"kernel": lt.sub("linear")["weight"].T}}
        if "linear.bias" in lt:
            lp["linear"]["bias"] = lt.sub("linear")["bias"]
        ls = {}
        if "norm.weight" in lt:
            _bn(lt.sub("norm"), lp, ls, name="norm")
        params[f"pfn_layers_{i}"] = lp
        stats[f"pfn_layers_{i}"] = ls
    return params, stats


def convert_bev_backbone(tree, cfg):
    """BaseBEVBackbone blocks.{i}/deblocks.{i} Sequentials
    (base_bev_backbone.py:30-80; ZeroPad2d offsets the first conv to
    index 1) -> flax blocks_{i}_down / blocks_{i}_{k} / deblocks_{i}_*."""
    layer_nums = list(cfg.get("LAYER_NUMS", []) or [])
    upsample_strides = list(cfg.get("UPSAMPLE_STRIDES", []) or [])
    params, stats = {}, {}

    def conv_bn(conv_tree, bn_tree, name, kernel_fn=_conv2d_kernel):
        lp = {"conv": {"kernel": kernel_fn(conv_tree["weight"])}}
        ls = {}
        _bn(bn_tree, lp, ls)
        params[name] = lp
        stats[name] = ls

    for idx in range(len(layer_nums)):
        bt = tree.sub(f"blocks.{idx}")
        conv_bn(bt.sub("1"), bt.sub("2"), f"blocks_{idx}_down")
        for k in range(layer_nums[idx]):
            conv_bn(bt.sub(str(4 + 3 * k)), bt.sub(str(5 + 3 * k)),
                    f"blocks_{idx}_{k}")
        if upsample_strides:
            dt = tree.sub(f"deblocks.{idx}")
            if upsample_strides[idx] >= 1:
                params[f"deblocks_{idx}_deconv"] = {
                    "kernel": _deconv2d_kernel(dt.sub("0")["weight"])
                }
            else:
                params[f"deblocks_{idx}_conv"] = {
                    "kernel": _conv2d_kernel(dt.sub("0")["weight"])
                }
            bp, bs = {}, {}
            _bn(dt.sub("1"), bp, bs)
            params[f"deblocks_{idx}_bn"] = bp["bn"]
            stats[f"deblocks_{idx}_bn"] = bs["bn"]
    if len(upsample_strides) > len(layer_nums):
        dt = tree.sub(f"deblocks.{len(layer_nums)}")
        params["deblocks_final_deconv"] = {
            "kernel": _deconv2d_kernel(dt.sub("0")["weight"])
        }
        bp, bs = {}, {}
        _bn(dt.sub("1"), bp, bs)
        params["deblocks_final_bn"] = bp["bn"]
        stats["deblocks_final_bn"] = bs["bn"]
    return params, stats


def convert_anchor_head_single(tree):
    """AnchorHeadSingle conv_cls/conv_box/conv_dir_cls 1x1 Conv2d
    (anchor_head_single.py:30-43) -> flax AnchorHeadSingleNet."""
    params = {}
    for name in ("conv_cls", "conv_box", "conv_dir_cls"):
        if f"{name}.weight" in tree:
            sub = tree.sub(name)
            params[name] = {
                "kernel": _conv2d_kernel(sub["weight"]),
                "bias": sub["bias"],
            }
    return params


def _conv3d_kernel(w, cin, cout):
    """spconv Conv3d weight -> flax Conv kernel (k1, k2, k3, in, out).
    Accepts the layouts the reference's load shim handles
    (detector3d_template.py ckpt load):
      spconv 1.x            (k1, k2, k3, in, out)  — already flax layout
      spconv 2.x native     (k1, k2, k3, out, in)
      spconv 2.x implicit   (out, k1, k2, k3, in)
    Disambiguated by the caller-known (in, out) channel pair; when
    cin == cout the 1.x and 2.x-native layouts coincide shape-wise
    and 1.x is assumed (the published reference checkpoints)."""
    w = np.asarray(w)
    if w.shape[-2:] == (cin, cout):  # spconv 1.x == flax layout
        return w
    if w.shape[-2:] == (cout, cin):  # spconv 2.x native
        return np.swapaxes(w, -1, -2)
    if w.shape[0] == cout and w.shape[-1] == cin:  # implicit gemm
        return np.moveaxis(w, 0, -1).swapaxes(-1, -2)
    raise ValueError(
        f"unrecognized spconv weight shape {w.shape} for "
        f"cin={cin} cout={cout}")


def convert_voxel_backbone_dense(tree, widths, c_out, input_channels=4):
    """Reference VoxelBackBone8x (spconv_backbone.py:70-120) onto the
    DENSE flax analogue ``voxel_backbone.VoxelBackBone8x`` — a COMPLETE
    mapping: each level's down conv (conv{L}.0) plus BOTH subm blocks
    (conv{L}.1 -> conv{L}_a, conv{L}.2 -> conv{L}_b)."""
    conv3d_kernel = _conv3d_kernel

    params, stats = {}, {}

    def seq(conv_tree, bn_tree, name, cin, cout):
        params[name] = {
            "Conv_0": {"kernel": conv3d_kernel(conv_tree["weight"],
                                               cin, cout)},
            "BatchNorm_0": {"scale": bn_tree["weight"],
                            "bias": bn_tree["bias"]},
        }
        stats[name] = {"BatchNorm_0": {"mean": bn_tree["running_mean"],
                                       "var": bn_tree["running_var"]}}

    # conv_input: SubM(Cin->w0); conv1: 1 subm block (w0->w1)
    seq(tree.sub("conv_input.0"), tree.sub("conv_input.1"), "conv_input",
        input_channels, widths[0])
    seq(tree.sub("conv1.0.0"), tree.sub("conv1.0.1"), "conv1",
        widths[0], widths[1])
    pairs = [("conv2", widths[1], widths[2]),
             ("conv3", widths[2], widths[3]),
             ("conv4", widths[3], widths[4])]
    for lvl, cin, cout in pairs:
        seq(tree.sub(f"{lvl}.0.0"), tree.sub(f"{lvl}.0.1"), f"{lvl}_down",
            cin, cout)
        seq(tree.sub(f"{lvl}.1.0"), tree.sub(f"{lvl}.1.1"), f"{lvl}_a",
            cout, cout)
        seq(tree.sub(f"{lvl}.2.0"), tree.sub(f"{lvl}.2.1"), f"{lvl}_b",
            cout, cout)
    seq(tree.sub("conv_out.0"), tree.sub("conv_out.1"), "conv_out",
        widths[4], c_out)
    return params, stats


def convert_res_block3d(tree, name, params, stats):
    """SparseBasicBlock (spconv_backbone.py:30-67) -> flax ResBlock3D
    {conv1, bn1, conv2, bn2}.

    The reference's SubM convs inside the block carry a bias even though
    a BN follows (``bias = norm_fn is not None``, :38) — a redundant
    shift which is folded EXACTLY into the BN running mean here
    (BN(Wx + b) == BN'(Wx) with mean' = mean - b)."""
    p, s = {}, {}
    for conv_name, bn_name in (("conv1", "bn1"), ("conv2", "bn2")):
        ct, bt = tree.sub(conv_name), tree.sub(bn_name)
        p[conv_name] = {"kernel": np.asarray(ct["weight"])}
        mean = np.asarray(bt["running_mean"])
        if "bias" in ct:
            mean = mean - np.asarray(ct["bias"])
        p[bn_name] = {"scale": bt["weight"], "bias": bt["bias"]}
        s[bn_name] = {"mean": mean, "var": bt["running_var"]}
    params[name], stats[name] = p, s


def convert_voxel_res_backbone_dense(tree, input_channels=4):
    """Reference VoxelResBackBone8x (spconv_backbone.py:183-240) onto the
    dense flax ``voxel_backbone.VoxelResBackBone8x`` — a COMPLETE mapping
    (down block + 2 residual blocks per level on both sides): conv_input,
    conv1.{0,1} residual pair, conv{2..4}.0 down + .{1,2} residual pairs,
    conv_out.  spconv kernels (k,k,k,in,out) pass through; the in-block
    conv biases are folded into BN means (see convert_res_block3d)."""
    widths = [16, 16, 32, 64, 128]
    params, stats = {}, {}

    def seq(conv_tree, bn_tree, name):
        params[name] = {
            "Conv_0": {"kernel": np.asarray(conv_tree["weight"])},
            "BatchNorm_0": {"scale": bn_tree["weight"],
                            "bias": bn_tree["bias"]},
        }
        stats[name] = {"BatchNorm_0": {"mean": bn_tree["running_mean"],
                                       "var": bn_tree["running_var"]}}

    seq(tree.sub("conv_input.0"), tree.sub("conv_input.1"), "conv_input")
    convert_res_block3d(tree.sub("conv1.0"), "res1_a", params, stats)
    convert_res_block3d(tree.sub("conv1.1"), "res1_b", params, stats)
    for lvl in (2, 3, 4):
        seq(tree.sub(f"conv{lvl}.0.0"), tree.sub(f"conv{lvl}.0.1"),
            f"conv{lvl}_down")
        convert_res_block3d(tree.sub(f"conv{lvl}.1"), f"res{lvl}_a",
                            params, stats)
        convert_res_block3d(tree.sub(f"conv{lvl}.2"), f"res{lvl}_b",
                            params, stats)
    seq(tree.sub("conv_out.0"), tree.sub("conv_out.1"), "conv_out")
    return params, stats


def convert_sparse_voxel_backbone(tree, widths, c_out, input_channels=4,
                                  with_out=True):
    """Reference VoxelBackBone8x (spconv_backbone.py:70-120) onto the
    SPARSE flax ``sparse_backbone.SparseVoxelBackBone8x`` (gather-matmul
    submanifold formulation) — a COMPLETE mapping, both subm blocks per
    level included.

    spconv weights normalize to (kz, ky, kx, in, out) and flatten
    row-major onto the (K, in, out) tap axis — the same z-major
    ``_kernel_offsets`` order ``build_neighbor_table`` walks.  Any conv
    bias (spconv 1.x builds some) folds into the following BN's running
    mean (BN(Wx + b) == BN'(Wx) with mean' = mean - b)."""
    params, stats = {}, {}

    def block(conv_tree, bn_tree, name, cin, cout):
        w = _conv3d_kernel(conv_tree["weight"], cin, cout)
        params[name] = {"kernel": w.reshape(-1, cin, cout)}
        mean = np.asarray(bn_tree["running_mean"])
        if "bias" in conv_tree:
            mean = mean - np.asarray(conv_tree["bias"])
        params[name]["bn"] = {"scale": bn_tree["weight"],
                              "bias": bn_tree["bias"]}
        stats[name] = {"bn": {"mean": mean, "var": bn_tree["running_var"]}}

    def down(conv_tree, bn_tree, name, cin, cout):
        w = _conv3d_kernel(conv_tree["weight"], cin, cout)
        params[f"{name}_kernel"] = w.reshape(-1, cin, cout)
        mean = np.asarray(bn_tree["running_mean"])
        if "bias" in conv_tree:
            mean = mean - np.asarray(conv_tree["bias"])
        params[f"{name}_bn"] = {"scale": bn_tree["weight"],
                                "bias": bn_tree["bias"]}
        stats[f"{name}_bn"] = {"mean": mean, "var": bn_tree["running_var"]}

    block(tree.sub("conv_input.0"), tree.sub("conv_input.1"), "conv_input",
          input_channels, widths[0])
    block(tree.sub("conv1.0.0"), tree.sub("conv1.0.1"), "conv1",
          widths[0], widths[1])
    pairs = [(2, widths[1], widths[2]), (3, widths[2], widths[3]),
             (4, widths[3], widths[4])]
    for lvl, cin, cout in pairs:
        down(tree.sub(f"conv{lvl}.0.0"), tree.sub(f"conv{lvl}.0.1"),
             f"conv{lvl}_down", cin, cout)
        block(tree.sub(f"conv{lvl}.1.0"), tree.sub(f"conv{lvl}.1.1"),
              f"conv{lvl}_a", cout, cout)
        block(tree.sub(f"conv{lvl}.2.0"), tree.sub(f"conv{lvl}.2.1"),
              f"conv{lvl}_b", cout, cout)
    if with_out:  # absent under RETURN_ENCODED_TENSOR: False (UNet free)
        down(tree.sub("conv_out.0"), tree.sub("conv_out.1"), "conv_out",
             widths[4], c_out)
    return params, stats


def convert_sparse_res_block(tree, cin, cout):
    """SparseBasicBlock (spconv_backbone.py:121-160) -> flax
    ``SparseResBlock`` {kernel1, bn1, kernel2, bn2}; in-block conv
    biases fold into the BN running means."""
    p, s = {}, {}
    for i, c_in in ((1, cin), (2, cout)):
        ct, bt = tree.sub(f"conv{i}"), tree.sub(f"bn{i}")
        w = _conv3d_kernel(ct["weight"], c_in, cout)
        p[f"kernel{i}"] = w.reshape(-1, c_in, cout)
        mean = np.asarray(bt["running_mean"])
        if "bias" in ct:
            mean = mean - np.asarray(ct["bias"])
        p[f"bn{i}"] = {"scale": bt["weight"], "bias": bt["bias"]}
        s[f"bn{i}"] = {"mean": mean, "var": bt["running_var"]}
    return p, s


def convert_sparse_voxel_res_backbone(tree, input_channels=4):
    """Reference VoxelResBackBone8x (spconv_backbone.py:183-293) onto
    the SPARSE flax ``SparseVoxelResBackBone8x``: conv_input SubM block,
    conv1.{0,1} SparseBasicBlocks -> res1_a/res1_b, conv{2..4}.0 downs
    -> conv{L}_down_kernel/_bn, conv{2..4}.{1,2} -> res{L}_a/_b,
    conv_out -> conv_out_kernel/_bn.  Same tap flattening and
    bias-folding rules as convert_sparse_voxel_backbone."""
    widths = [16, 16, 32, 64, 128]
    params, stats = {}, {}

    def seq(conv_tree, bn_tree, kname, bnname, cin, cout):
        w = _conv3d_kernel(conv_tree["weight"], cin, cout)
        mean = np.asarray(bn_tree["running_mean"])
        if "bias" in conv_tree:
            mean = mean - np.asarray(conv_tree["bias"])
        bn_p = {"scale": bn_tree["weight"], "bias": bn_tree["bias"]}
        bn_s = {"mean": mean, "var": bn_tree["running_var"]}
        return w.reshape(-1, cin, cout), bn_p, bn_s

    k, bp, bs = seq(tree.sub("conv_input.0"), tree.sub("conv_input.1"),
                    None, None, input_channels, widths[0])
    params["conv_input"] = {"kernel": k, "bn": bp}
    stats["conv_input"] = {"bn": bs}
    for i, name in ((0, "res1_a"), (1, "res1_b")):
        p, s = convert_sparse_res_block(
            tree.sub(f"conv1.{i}"), widths[1], widths[1])
        params[name], stats[name] = p, s
    for lvl, cin, cout in ((2, widths[1], widths[2]),
                           (3, widths[2], widths[3]),
                           (4, widths[3], widths[4])):
        k, bp, bs = seq(tree.sub(f"conv{lvl}.0.0"),
                        tree.sub(f"conv{lvl}.0.1"), None, None, cin, cout)
        params[f"conv{lvl}_down_kernel"] = k
        params[f"conv{lvl}_down_bn"] = bp
        stats[f"conv{lvl}_down_bn"] = bs
        for i, suf in ((1, "a"), (2, "b")):
            p, s = convert_sparse_res_block(
                tree.sub(f"conv{lvl}.{i}"), cout, cout)
            params[f"res{lvl}_{suf}"], stats[f"res{lvl}_{suf}"] = p, s
    k, bp, bs = seq(tree.sub("conv_out.0"), tree.sub("conv_out.1"),
                    None, None, widths[4], 128)
    params["conv_out_kernel"] = k
    params["conv_out_bn"] = bp
    stats["conv_out_bn"] = bs
    return params, stats


def convert_fc_bn_stack(tree, n, drop_after, prefix):
    """Torch Sequential of [Linear/Conv1d(no bias), BN1d, ReLU
    (+ Dropout when drop_after(k))] x n -> flax {prefix}_fc{k} Dense +
    {prefix}_bn{k} BatchNorm params.

    Returns (params, stats, next_index) — next_index is the Sequential
    slot AFTER the stack (= the final pred layer in make_fc_layers)."""
    params, stats = {}, {}
    idx = 0
    for k in range(n):
        lin, bn = tree.sub(str(idx)), tree.sub(str(idx + 1))
        lp = {"kernel": _dense(lin["weight"])}
        if "bias" in lin:
            lp["bias"] = lin["bias"]
        params[f"{prefix}_fc{k}"] = lp
        params[f"{prefix}_bn{k}"] = {"scale": bn["weight"],
                                     "bias": bn["bias"]}
        stats[f"{prefix}_bn{k}"] = {"mean": bn["running_mean"],
                                    "var": bn["running_var"]}
        idx += 3 + (1 if drop_after(k) else 0)
    return params, stats, idx


def convert_second_roi_head(tree, roi_cfg):
    """SECONDHead (second_head.py:10-32) -> flax SECONDHeadNet:
    shared_fc_layer (Dropout after each non-final layer when DP_RATIO>0)
    + iou_layers from RoIHeadTemplate.make_fc_layers (Dropout after
    k==0 when DP_RATIO>=0, roi_head_template.py:29-43)."""
    dp = float(roi_cfg.get("DP_RATIO", 0.0))
    n_sh = len(list(roi_cfg.SHARED_FC))
    params, stats, _ = convert_fc_bn_stack(
        tree.sub("shared_fc_layer"), n_sh,
        lambda k: k != n_sh - 1 and dp > 0, "shared")
    n_iou = len(list(roi_cfg.IOU_FC))
    p, s, idx = convert_fc_bn_stack(
        tree.sub("iou_layers"), n_iou, lambda k: dp >= 0 and k == 0, "iou")
    params.update(p)
    stats.update(s)
    fin = tree.sub("iou_layers").sub(str(idx))
    params["iou_out"] = {"kernel": _dense(fin["weight"]),
                         "bias": fin["bias"]}
    return params, stats


def convert_voxelrcnn_roi_head(tree, roi_cfg):
    """VoxelRCNNHead (voxelrcnn_head.py:8-95) -> flax VoxelRCNNHeadNet:
    per-source NeighborVoxelSAModuleMSG pool layers (mlps_in/mlps_pos/
    mlps_out, voxel_pool_modules.py:24-53) + shared/cls/reg FC stacks
    (Dropout after non-final layers when DP_RATIO>0) + pred Linears."""
    dp = float(roi_cfg.get("DP_RATIO", 0.0))
    params, stats = {}, {}
    for k, src in enumerate(list(roi_cfg.ROI_GRID_POOL.FEATURES_SOURCE)):
        pt = tree.sub(f"roi_grid_pool_layers.{k}")
        pp, ps = {}, {}
        for tname, fname in (("mlps_in.0", "in"), ("mlps_pos.0", "pos"),
                             ("mlps_out.0", "out")):
            ct, bt = pt.sub(f"{tname}.0"), pt.sub(f"{tname}.1")
            pp[f"mlp_{fname}"] = {"kernel": _dense(ct["weight"])}
            pp[f"bn_{fname}"] = {"scale": bt["weight"], "bias": bt["bias"]}
            ps[f"bn_{fname}"] = {"mean": bt["running_mean"],
                                 "var": bt["running_var"]}
        params[f"pool_{src}"], stats[f"pool_{src}"] = pp, ps
    for torch_name, prefix, fc_key in (
        ("shared_fc_layer", "shared", "SHARED_FC"),
        ("cls_fc_layers", "cls", "CLS_FC"),
        ("reg_fc_layers", "reg", "REG_FC"),
    ):
        n = len(list(roi_cfg[fc_key]))
        p, s, _ = convert_fc_bn_stack(
            tree.sub(torch_name), n,
            lambda k, n=n: k != n - 1 and dp > 0, prefix)
        params.update(p)
        stats.update(s)
    for torch_name, flax_name in (("cls_pred_layer", "cls_pred"),
                                  ("reg_pred_layer", "reg_pred")):
        sub = tree.sub(torch_name)
        params[flax_name] = {"kernel": _dense(sub["weight"]),
                             "bias": sub["bias"]}
    return params, stats


def convert_pointnet2_msg_backbone(tree, model_cfg, input_channels=4):
    """PointNet2MSG (pointnet2_backbone.py:12-102 in the reference) ->
    flax PointNet2MSG: SA_modules.{k}.mlps.{i} Conv2d+BN2d stacks and
    FP_modules.{i}.mlp stacks."""
    sa_cfg = model_cfg.SA_CONFIG
    params, stats = {}, {}
    channel_in = input_channels - 3
    skip = [channel_in]
    for k in range(len(sa_cfg.NPOINTS)):
        mp, ms = {}, {}
        for i, spec in enumerate(sa_cfg.MLPS[k]):
            p, s = convert_mlp_stack(
                tree.sub(f"SA_modules.{k}.mlps.{i}"), len(list(spec)))
            mp[f"mlps_{i}"], ms[f"mlps_{i}"] = p, s
        params[f"SA_modules_{k}"], stats[f"SA_modules_{k}"] = mp, ms
        channel_in = sum(list(m)[-1] for m in sa_cfg.MLPS[k])
        skip.append(channel_in)
    for i in range(len(model_cfg.FP_MLPS)):
        p, s = convert_mlp_stack(
            tree.sub(f"FP_modules.{i}.mlp"),
            len(list(model_cfg.FP_MLPS[i])))
        params[f"FP_modules_{i}"] = {"mlp": p}
        stats[f"FP_modules_{i}"] = {"mlp": s}
    return params, stats


def convert_point_head_box(tree, head_cfg):
    """PointHeadBox (point_head_box.py): cls_layers + box_layers from
    point_head_template.make_fc_layers (Linear/BN/ReLU x n + Linear,
    NO dropout) -> flax PointHeadBoxNet cls_/box_ flat names."""
    params, stats = {}, {}
    for torch_name, prefix, fc_key in (("cls_layers", "cls", "CLS_FC"),
                                       ("box_layers", "box", "REG_FC")):
        n = len(list(head_cfg[fc_key]))
        p, s, idx = convert_fc_bn_stack(
            tree.sub(torch_name), n, lambda k: False, prefix)
        params.update(p)
        stats.update(s)
        fin = tree.sub(torch_name).sub(str(idx))
        params[f"{prefix}_out"] = {"kernel": _dense(fin["weight"]),
                                   "bias": fin["bias"]}
    return params, stats


def convert_plain_mlp(tree, n, use_bn, prefix_params, prefix_stats):
    """The PointRCNN head's _MLP: Conv2d(bias=not use_bn) [+BN] +ReLU
    x n (pointrcnn_head.py:19-31) -> flax _MLP fc{k}/bn{k}."""
    stride = 3 if use_bn else 2
    for k in range(n):
        conv = tree.sub(str(stride * k))
        lp = {"kernel": _dense(conv["weight"])}
        if "bias" in conv:
            lp["bias"] = conv["bias"]
        prefix_params[f"fc{k}"] = lp
        if use_bn:
            bn = tree.sub(str(stride * k + 1))
            prefix_params[f"bn{k}"] = {"scale": bn["weight"],
                                       "bias": bn["bias"]}
            prefix_stats[f"bn{k}"] = {"mean": bn["running_mean"],
                                      "var": bn["running_var"]}


def convert_pointrcnn_roi_head(tree, roi_cfg):
    """PointRCNNHead (pointrcnn_head.py:10-60) -> flax PointRCNNHeadNet:
    xyz_up/merge_down honor USE_BN; the SA stages are ALWAYS BN'd (the
    reference's PointnetSAModuleMSG ignores its bn arg); cls/reg stacks
    from RoIHeadTemplate.make_fc_layers (Dropout slot after k==0 since
    DP_RATIO >= 0)."""
    use_bn = bool(roi_cfg.get("USE_BN", False))
    dp = float(roi_cfg.get("DP_RATIO", 0.0))
    params, stats = {}, {}

    xp, xs = {}, {}
    convert_plain_mlp(tree.sub("xyz_up_layer"),
                      len(list(roi_cfg.XYZ_UP_LAYER)), use_bn, xp, xs)
    params["xyz_up"], stats["xyz_up"] = xp, xs
    mp, ms = {}, {}
    convert_plain_mlp(tree.sub("merge_down_layer"), 1, use_bn, mp, ms)
    params["merge_down"], stats["merge_down"] = mp, ms

    for k in range(len(list(roi_cfg.SA_CONFIG.NPOINTS))):
        sp, ss = {}, {}
        convert_plain_mlp(tree.sub(f"SA_modules.{k}.mlps.0"),
                          len(list(roi_cfg.SA_CONFIG.MLPS[k])), True,
                          sp, ss)
        params[f"SA_{k}"] = {"mlp": sp}
        stats[f"SA_{k}"] = {"mlp": ss}

    for torch_name, prefix, fc_key in (("cls_layers", "cls", "CLS_FC"),
                                       ("reg_layers", "reg", "REG_FC")):
        n = len(list(roi_cfg[fc_key]))
        p, s, idx = convert_fc_bn_stack(
            tree.sub(torch_name), n,
            lambda k: dp >= 0 and k == 0, prefix)
        params.update(p)
        stats.update(s)
        fin = tree.sub(torch_name).sub(str(idx))
        params[f"{prefix}_out"] = {"kernel": _dense(fin["weight"]),
                                   "bias": fin["bias"]}
    return params, stats


def convert_pointrcnn_checkpoint(state_dict, model_cfg, input_channels=4):
    """PointRCNN (detectors/PointRCNN.py): PointNet2MSG backbone +
    PointHeadBox + PointRCNNHead."""
    tree = TorchTree(state_dict)
    params, stats = {}, {}
    p, s = convert_pointnet2_msg_backbone(
        tree.sub("backbone_3d"), model_cfg.BACKBONE_3D,
        input_channels=input_channels)
    params["backbone_3d"], stats["backbone_3d"] = p, s
    p, s = convert_point_head_box(tree.sub("point_head"),
                                  model_cfg.POINT_HEAD)
    params["point_head"], stats["point_head"] = p, s
    p, s = convert_pointrcnn_roi_head(tree.sub("roi_head"),
                                      model_cfg.ROI_HEAD)
    params["roi_head"], stats["roi_head"] = p, s
    return {"params": params, "batch_stats": stats}


def convert_masked_sa_msg(tree, mlps_cfg):
    """StackSAModuleMSG (pointnet2_stack/pointnet2_modules.py:30-115)
    mlps.{i} Conv2d+BN2d stacks -> flax MaskedSAModuleMSG mlps_{i}
    MLPStacks (the padded-dense subsumption)."""
    params, stats = {}, {}
    for i, spec in enumerate(mlps_cfg):
        p, s = convert_mlp_stack(tree.sub(f"mlps.{i}"), len(list(spec)))
        params[f"mlps_{i}"], stats[f"mlps_{i}"] = p, s
    return params, stats


def convert_vector_pool_msg(tree, cfg):
    """VectorPoolAggregationModuleMSG
    (pointnet2_stack/pointnet2_modules.py:427-470) -> flax
    ``vector_pool.VectorPoolAggregationModuleMSG``: per-group
    ``layer_{k}.separate_local_aggregation_layer.0`` is a grouped Conv1d
    (out = V*c_agg, groups = V, in-per-group = red+9) whose group-major
    rows reshape onto the (V, red+9, c_agg) einsum kernel; its BN1d maps
    to ``sla_bn``; ``post_mlps``/``msg_post_mlps`` Conv1d+BN1d triplets
    map to post_{j}/post_bn_{j} and msg_post_{j}/msg_post_bn_{j}."""
    params, stats = {}, {}

    def conv1d_bn(sub, j, dense_name, bn_name, p, s):
        ct = sub.sub(f"{3 * j}")
        bt = sub.sub(f"{3 * j + 1}")
        p[dense_name] = {"kernel": np.asarray(ct["weight"])[..., 0].T}
        p[bn_name] = {"scale": bt["weight"], "bias": bt["bias"]}
        s[bn_name] = {"mean": bt["running_mean"], "var": bt["running_var"]}

    for k in range(int(cfg.NUM_GROUPS)):
        g = cfg[f"GROUP_CFG_{k}"]
        V = int(np.prod([int(v) for v in g.NUM_LOCAL_VOXEL]))
        lt = tree.sub(f"layer_{k}")
        lp, ls = {}, {}
        w = np.asarray(
            lt.sub("separate_local_aggregation_layer.0")["weight"])
        c_agg = w.shape[0] // V
        lp["separate_local_aggregation"] = np.ascontiguousarray(
            w[..., 0].reshape(V, c_agg, w.shape[1]).transpose(0, 2, 1))
        bt = lt.sub("separate_local_aggregation_layer.1")
        lp["sla_bn"] = {"scale": bt["weight"], "bias": bt["bias"]}
        ls["sla_bn"] = {"mean": bt["running_mean"],
                        "var": bt["running_var"]}
        pm = lt.sub("post_mlps")
        for j in range(len(list(g.POST_MLPS))):
            conv1d_bn(pm, j, f"post_{j}", f"post_bn_{j}", lp, ls)
        params[f"layer_{k}"], stats[f"layer_{k}"] = lp, ls
    mm = tree.sub("msg_post_mlps")
    for j in range(len(list(cfg.MSG_POST_MLPS))):
        conv1d_bn(mm, j, f"msg_post_{j}", f"msg_post_bn_{j}",
                  params, stats)
    return params, stats


def convert_local_aggregation(tree, scfg):
    """build_local_aggregation_module dispatch
    (pointnet2_stack/pointnet2_modules.py:10-27): StackSAModuleMSG vs
    VectorPoolAggregationModuleMSG (PV-RCNN++)."""
    if scfg.get("NAME", "StackSAModuleMSG") == "VectorPoolAggregationModuleMSG":
        return convert_vector_pool_msg(tree, scfg)
    return convert_masked_sa_msg(tree, [list(m) for m in scfg.MLPS])


def convert_voxel_set_abstraction(tree, pfe_cfg):
    """VoxelSetAbstraction (voxel_set_abstraction.py:123-180):
    SA_rawpoints + SA_layers (ordered over FEATURES_SOURCE minus
    bev/raw_points) + vsa_point_feature_fusion Linear/BN."""
    params, stats = {}, {}
    sources = list(pfe_cfg.FEATURES_SOURCE)
    if "raw_points" in sources:
        p, s = convert_local_aggregation(
            tree.sub("SA_rawpoints"), pfe_cfg.SA_LAYER["raw_points"])
        params["SA_rawpoints"], stats["SA_rawpoints"] = p, s
    k = 0
    for src in sources:
        if src in ("bev", "raw_points"):
            continue
        p, s = convert_local_aggregation(
            tree.sub(f"SA_layers.{k}"), pfe_cfg.SA_LAYER[src])
        params[f"SA_{src}"], stats[f"SA_{src}"] = p, s
        k += 1
    fus = tree.sub("vsa_point_feature_fusion.0")
    params["fusion"] = {"kernel": fus["weight"].T}
    bn = tree.sub("vsa_point_feature_fusion.1")
    params["fusion_bn"] = {"scale": bn["weight"], "bias": bn["bias"]}
    stats["fusion_bn"] = {"mean": bn["running_mean"],
                          "var": bn["running_var"]}
    return params, stats


def convert_point_head_simple(tree, head_cfg):
    """PointHeadSimple (point_head_simple.py): one cls_layers stack from
    point_head_template.make_fc_layers (no dropout)."""
    n = len(list(head_cfg.CLS_FC))
    params, stats, idx = convert_fc_bn_stack(
        tree.sub("cls_layers"), n, lambda k: False, "cls")
    fin = tree.sub("cls_layers").sub(str(idx))
    params["cls_out"] = {"kernel": _dense(fin["weight"]),
                         "bias": fin["bias"]}
    return params, stats


def convert_pvrcnn_roi_head(tree, roi_cfg):
    """PVRCNNHead (pvrcnn_head.py:8-42) -> flax PVRCNNHeadNet:
    roi_grid_pool_layer StackSAModuleMSG + shared_fc_layer (Conv1d,
    Dropout after non-final when DP_RATIO>0) + cls/reg make_fc_layers
    stacks (Dropout slot after k==0) with the final convs split out as
    cls_pred/reg_pred."""
    dp = float(roi_cfg.get("DP_RATIO", 0.0))
    params, stats = {}, {}
    p, s = convert_local_aggregation(
        tree.sub("roi_grid_pool_layer"), roi_cfg.ROI_GRID_POOL)
    params["roi_grid_pool"], stats["roi_grid_pool"] = p, s
    n_sh = len(list(roi_cfg.SHARED_FC))
    p, s, _ = convert_fc_bn_stack(
        tree.sub("shared_fc_layer"), n_sh,
        lambda k: k != n_sh - 1 and dp > 0, "shared")
    params.update(p)
    stats.update(s)
    for torch_name, prefix, pred, fc_key in (
        ("cls_layers", "cls", "cls_pred", "CLS_FC"),
        ("reg_layers", "reg", "reg_pred", "REG_FC"),
    ):
        n = len(list(roi_cfg[fc_key]))
        p, s, idx = convert_fc_bn_stack(
            tree.sub(torch_name), n, lambda k: dp >= 0 and k == 0, prefix)
        params.update(p)
        stats.update(s)
        fin = tree.sub(torch_name).sub(str(idx))
        params[pred] = {"kernel": _dense(fin["weight"]),
                        "bias": fin["bias"]}
    return params, stats


def convert_pvrcnn_checkpoint(state_dict, model_cfg):
    """PV-RCNN / PV-RCNN++ (detectors/pv_rcnn.py, pv_rcnn_plusplus.py):
    the SECOND first stage + the VoxelSetAbstraction PFE +
    PointHeadSimple + PVRCNNHead.  Per-source aggregation dispatches
    StackSAModuleMSG vs VectorPoolAggregationModuleMSG by config NAME,
    so both variants share this entry."""
    out = convert_second_checkpoint(state_dict, model_cfg)
    tree = TorchTree(state_dict)
    p, s = convert_voxel_set_abstraction(tree.sub("pfe"), model_cfg.PFE)
    out["params"]["pfe"], out["batch_stats"]["pfe"] = p, s
    p, s = convert_point_head_simple(tree.sub("point_head"),
                                     model_cfg.POINT_HEAD)
    out["params"]["point_head"] = p
    out["batch_stats"]["point_head"] = s
    p, s = convert_pvrcnn_roi_head(tree.sub("roi_head"),
                                   model_cfg.ROI_HEAD)
    out["params"]["roi_head"] = p
    out["batch_stats"]["roi_head"] = s
    return out


def _deconv3d_kernel(w, cin, cout):
    """spconv SparseInverseConv3d weight -> flax ConvTranspose kernel:
    normalize to (k, k, k, in, out), then mirror the spatial taps
    (flax ConvTranspose runs an input-dilated correlation — torch
    gradient-of-conv semantics with the spatial axes flipped, same rule
    the 2D deconv mapping uses)."""
    w = _conv3d_kernel(w, cin, cout)
    return np.ascontiguousarray(w[::-1, ::-1, ::-1])


def convert_unet_dense(tree, input_channels=4, return_encoded=True):
    """Reference UNetV2 (spconv_unet.py:50-212) onto the DENSE flax
    ``voxel_unet.UNetV2``: VoxelBackBone8x-style encoder (BOTH subm
    blocks per level map: conv{L}.1 -> conv{L}_a, conv{L}.2 ->
    conv{L}_b) + UR decoder (conv_up_t{k}/conv_up_m{k}/inv_conv{k}/
    conv5)."""
    widths = [16, 16, 32, 64, 64]
    params, stats = {}, {}

    def seq(conv_tree, bn_tree, name, cin, cout):
        w = _conv3d_kernel(conv_tree["weight"], cin, cout)
        params[name] = {"Conv_0": {"kernel": w}}
        mean = np.asarray(bn_tree["running_mean"])
        if "bias" in conv_tree:
            mean = mean - np.asarray(conv_tree["bias"])
        params[name]["BatchNorm_0"] = {"scale": bn_tree["weight"],
                                       "bias": bn_tree["bias"]}
        stats[name] = {"BatchNorm_0": {"mean": mean,
                                       "var": bn_tree["running_var"]}}

    seq(tree.sub("conv_input.0"), tree.sub("conv_input.1"), "conv_input",
        input_channels, widths[0])
    seq(tree.sub("conv1.0.0"), tree.sub("conv1.0.1"), "conv1",
        widths[0], widths[1])
    for lvl, cin, cout in ((2, widths[1], widths[2]),
                           (3, widths[2], widths[3]),
                           (4, widths[3], widths[4])):
        seq(tree.sub(f"conv{lvl}.0.0"), tree.sub(f"conv{lvl}.0.1"),
            f"conv{lvl}_down", cin, cout)
        seq(tree.sub(f"conv{lvl}.1.0"), tree.sub(f"conv{lvl}.1.1"),
            f"conv{lvl}_a", cout, cout)
        seq(tree.sub(f"conv{lvl}.2.0"), tree.sub(f"conv{lvl}.2.1"),
            f"conv{lvl}_b", cout, cout)
    if return_encoded:
        seq(tree.sub("conv_out.0"), tree.sub("conv_out.1"), "conv_out",
            widths[4], 128)

    # decoder: ur4..ur1 + inv_conv4..2 + conv5
    ur_widths = {4: (64, 64), 3: (64, 64), 2: (32, 32), 1: (16, 16)}
    inv_pairs = {4: (64, 64), 3: (64, 32), 2: (32, 16)}
    for k in (4, 3, 2, 1):
        c_lat, c_mid = ur_widths[k]
        up, us = {}, {}
        convert_res_block3d(tree.sub(f"conv_up_t{k}"), "conv_up_t", up, us)
        mp, ms = {}, {}
        ct, bt = tree.sub(f"conv_up_m{k}.0"), tree.sub(f"conv_up_m{k}.1")
        w = _conv3d_kernel(ct["weight"], 2 * c_lat, c_mid)
        mean = np.asarray(bt["running_mean"])
        if "bias" in ct:
            mean = mean - np.asarray(ct["bias"])
        up["conv_up_m"] = {
            "Conv_0": {"kernel": w},
            "BatchNorm_0": {"scale": bt["weight"], "bias": bt["bias"]},
        }
        us["conv_up_m"] = {"BatchNorm_0": {"mean": mean,
                                           "var": bt["running_var"]}}
        params[f"ur{k}"], stats[f"ur{k}"] = up, us
        if k in inv_pairs:
            cin, cout = inv_pairs[k]
            ct = tree.sub(f"inv_conv{k}.0")
            bt = tree.sub(f"inv_conv{k}.1")
            mean = np.asarray(bt["running_mean"])
            if "bias" in ct:
                mean = mean - np.asarray(ct["bias"])
            params[f"inv_conv{k}"] = {
                "ConvTranspose_0": {
                    "kernel": _deconv3d_kernel(ct["weight"], cin, cout)},
                "BatchNorm_0": {"scale": bt["weight"], "bias": bt["bias"]},
            }
            stats[f"inv_conv{k}"] = {
                "BatchNorm_0": {"mean": mean, "var": bt["running_var"]}}
    seq(tree.sub("conv5.0.0"), tree.sub("conv5.0.1"), "conv5", 16, 16)
    return params, stats


def convert_sparse_unet(tree, input_channels=4, return_encoded=True):
    """Reference UNetV2 onto the SPARSE flax ``SparseUNetV2``: encoder =
    the convert_sparse_voxel_backbone schema; decoder UR blocks map
    conv_up_t{k} SparseBasicBlocks onto SparseResBlock kernel1/bn1 +
    kernel2/bn2 (conv biases folded into BN means), conv_up_m{k} and
    conv5 onto SubMConvBlocks, inv_conv{k} onto SparseInverseConv
    (DIRECT tap order — the inverse neighbor table replays the forward
    pairs, so no mirror is applied, unlike the dense ConvTranspose
    path)."""
    widths = [16, 16, 32, 64, 64]
    params, stats = convert_sparse_voxel_backbone(
        tree, widths, 128, input_channels=input_channels,
        with_out=return_encoded)

    def fold(bn_tree, conv_tree):
        mean = np.asarray(bn_tree["running_mean"])
        if "bias" in conv_tree:
            mean = mean - np.asarray(conv_tree["bias"])
        return mean

    ur_widths = {4: 64, 3: 64, 2: 32, 1: 16}
    inv_pairs = {4: (64, 64), 3: (64, 32), 2: (32, 16)}
    for k in (4, 3, 2, 1):
        c_lat = ur_widths[k]
        up, us = {}, {}
        # conv_up_t: SparseBasicBlock conv1/bn1/conv2/bn2
        tp, ts = {}, {}
        for i, (cname, bname) in enumerate((("conv1", "bn1"),
                                            ("conv2", "bn2")), start=1):
            ct = tree.sub(f"conv_up_t{k}.{cname}")
            bt = tree.sub(f"conv_up_t{k}.{bname}")
            w = _conv3d_kernel(ct["weight"], c_lat, c_lat)
            tp[f"kernel{i}"] = w.reshape(-1, c_lat, c_lat)
            tp[f"bn{i}"] = {"scale": bt["weight"], "bias": bt["bias"]}
            ts[f"bn{i}"] = {"mean": fold(bt, ct),
                            "var": bt["running_var"]}
        up["conv_up_t"], us["conv_up_t"] = tp, ts
        ct, bt = tree.sub(f"conv_up_m{k}.0"), tree.sub(f"conv_up_m{k}.1")
        w = _conv3d_kernel(ct["weight"], 2 * c_lat, c_lat)
        up["conv_up_m"] = {
            "kernel": w.reshape(-1, 2 * c_lat, c_lat),
            "bn": {"scale": bt["weight"], "bias": bt["bias"]},
        }
        us["conv_up_m"] = {"bn": {"mean": fold(bt, ct),
                                  "var": bt["running_var"]}}
        params[f"ur{k}"], stats[f"ur{k}"] = up, us
        if k in inv_pairs:
            cin, cout = inv_pairs[k]
            ct = tree.sub(f"inv_conv{k}.0")
            bt = tree.sub(f"inv_conv{k}.1")
            w = _conv3d_kernel(ct["weight"], cin, cout)
            params[f"inv_conv{k}"] = {
                "kernel": w.reshape(-1, cin, cout),
                "bn": {"scale": bt["weight"], "bias": bt["bias"]},
            }
            stats[f"inv_conv{k}"] = {"bn": {"mean": fold(bt, ct),
                                            "var": bt["running_var"]}}
    ct, bt = tree.sub("conv5.0.0"), tree.sub("conv5.0.1")
    w = _conv3d_kernel(ct["weight"], 16, 16)
    params["conv5"] = {"kernel": w.reshape(-1, 16, 16),
                       "bn": {"scale": bt["weight"], "bias": bt["bias"]}}
    stats["conv5"] = {"bn": {"mean": fold(bt, ct),
                             "var": bt["running_var"]}}
    return params, stats


def convert_intra_part_head(tree, head_cfg):
    """PointIntraPartOffsetHead (point_intra_part_head.py:10-37):
    cls_layers + part_reg_layers (+ box_layers when a box branch is
    configured), all plain make_fc_layers -> flax cls_/part_/box_ flat
    names."""
    params, stats = {}, {}
    triples = [("cls_layers", "cls", list(head_cfg.CLS_FC)),
               ("part_reg_layers", "part", list(head_cfg.PART_FC))]
    if "box_layers.0.weight" in tree:
        triples.append(("box_layers", "box", list(head_cfg.REG_FC)))
    for torch_name, prefix, fcs in triples:
        p, s, idx = convert_fc_bn_stack(
            tree.sub(torch_name), len(fcs), lambda k: False, prefix)
        params.update(p)
        stats.update(s)
        fin = tree.sub(torch_name).sub(str(idx))
        params[f"{prefix}_out"] = {"kernel": _dense(fin["weight"]),
                                   "bias": fin["bias"]}
    return params, stats


def convert_parta2_roi_head(tree, roi_cfg):
    """PartA2FCHead (partA2_head.py:10-58) -> flax PartA2HeadNet:
    conv_part/conv_rpn two-block SubM stacks onto MaskedConvBlocks,
    shared/cls/reg stacks (same dropout index rules as PVRCNNHead) with
    final convs split out as cls_pred/reg_pred."""
    dp = float(roi_cfg.get("DP_RATIO", 0.0))
    params, stats = {}, {}
    c0 = int(roi_cfg.ROI_AWARE_POOL.NUM_FEATURES) // 2
    for torch_name, flax_base, cins in (
        ("conv_part", "conv_part", (4, 64)),
        ("conv_rpn", "conv_rpn", (None, 64)),
    ):
        for j, suffix in enumerate(("a", "b")):
            ct = tree.sub(f"{torch_name}.{j}.0")
            bt = tree.sub(f"{torch_name}.{j}.1")
            cout = 64 if j == 0 else c0
            cin = cins[j] if cins[j] is not None else None
            w = np.asarray(ct["weight"])
            if cin is None:  # conv_rpn input width comes from the ckpt
                cin = w.shape[-2] if w.shape[-1] == 64 else w.shape[-1]
            w = _conv3d_kernel(w, cin, cout)
            mean = np.asarray(bt["running_mean"])
            if "bias" in ct:
                mean = mean - np.asarray(ct["bias"])
            params[f"{flax_base}_{suffix}"] = {
                "Conv_0": {"kernel": w},
                "BatchNorm_0": {"scale": bt["weight"],
                                "bias": bt["bias"]},
            }
            stats[f"{flax_base}_{suffix}"] = {
                "BatchNorm_0": {"mean": mean, "var": bt["running_var"]}}
    n_sh = len(list(roi_cfg.SHARED_FC))
    p, s, _ = convert_fc_bn_stack(
        tree.sub("shared_fc_layer"), n_sh,
        lambda k: k != n_sh - 1 and dp > 0, "shared")
    params.update(p)
    stats.update(s)
    for torch_name, prefix, pred, fc_key in (
        ("cls_layers", "cls", "cls_pred", "CLS_FC"),
        ("reg_layers", "reg", "reg_pred", "REG_FC"),
    ):
        n = len(list(roi_cfg[fc_key]))
        p, s, idx = convert_fc_bn_stack(
            tree.sub(torch_name), n, lambda k: dp >= 0 and k == 0, prefix)
        params.update(p)
        stats.update(s)
        fin = tree.sub(torch_name).sub(str(idx))
        params[pred] = {"kernel": _dense(fin["weight"]),
                        "bias": fin["bias"]}
    return params, stats


def convert_parta2_checkpoint(state_dict, model_cfg, anchor=True):
    """Part-A2 (PartA2_net.py) / Part-A2-free: UNetV2 backbone (dense or
    sparse flax target by BACKBONE_3D.NAME) + optional BEV RPN
    (anchor variant) + PointIntraPartOffsetHead + PartA2FCHead."""
    tree = TorchTree(state_dict)
    params, stats = {}, {}
    bb_cfg = model_cfg.BACKBONE_3D
    return_encoded = bool(bb_cfg.get("RETURN_ENCODED_TENSOR", True))
    if bb_cfg.get("NAME", "UNetV2") == "SparseUNetV2":
        p, s = convert_sparse_unet(tree.sub("backbone_3d"),
                                   input_channels=4,
                                   return_encoded=return_encoded)
    else:
        p, s = convert_unet_dense(tree.sub("backbone_3d"),
                                  input_channels=4,
                                  return_encoded=return_encoded)
    params["backbone_3d"], stats["backbone_3d"] = p, s
    if anchor:
        p, s = convert_bev_backbone(tree.sub("backbone_2d"),
                                    model_cfg.BACKBONE_2D)
        params["backbone_2d"], stats["backbone_2d"] = p, s
        params["dense_head"] = convert_anchor_head_single(
            tree.sub("dense_head"))
    p, s = convert_intra_part_head(tree.sub("point_head"),
                                   model_cfg.POINT_HEAD)
    params["point_head"], stats["point_head"] = p, s
    p, s = convert_parta2_roi_head(tree.sub("roi_head"),
                                   model_cfg.ROI_HEAD)
    params["roi_head"], stats["roi_head"] = p, s
    return {"params": params, "batch_stats": stats}


def convert_center_head(tree, model_cfg, num_class_each_head):
    """CenterHead (center_head.py:11-101) -> flax CenterHeadNet:
    shared_conv Sequential + heads_list.{i} SeparateHeads, whose fc
    stacks are Sequentials of [Conv2d-BN-ReLU] Sequentials with a bare
    final Conv2d."""
    params, stats = {}, {}
    sc = tree.sub("shared_conv")
    p = {"kernel": _conv2d_kernel(sc.sub("0")["weight"])}
    if "0.bias" in sc:
        p["bias"] = sc.sub("0")["bias"]
    params["shared_conv"] = p
    bp, bs = {}, {}
    _bn(sc.sub("1"), bp, bs)
    params["shared_bn"], stats["shared_bn"] = bp["bn"], bs["bn"]

    head_dict = {k: dict(v) for k, v in
                 dict(model_cfg.SEPARATE_HEAD_CFG.HEAD_DICT).items()}
    for i, n_cls in enumerate(num_class_each_head):
        hd = dict(head_dict)
        hd["hm"] = {"out_channels": n_cls,
                    "num_conv": int(model_cfg.NUM_HM_CONV)}
        ht = tree.sub(f"heads_list.{i}")
        hp, hs = {}, {}
        for name, spec in hd.items():
            nc = int(spec["num_conv"])
            for k in range(nc - 1):
                st = ht.sub(f"{name}.{k}")
                lp = {"kernel": _conv2d_kernel(st.sub("0")["weight"])}
                if "0.bias" in st:
                    lp["bias"] = st.sub("0")["bias"]
                hp[f"{name}_conv{k}"] = lp
                bp, bs = {}, {}
                _bn(st.sub("1"), bp, bs)
                hp[f"{name}_bn{k}"] = bp["bn"]
                hs[f"{name}_bn{k}"] = bs["bn"]
            fin = ht.sub(f"{name}.{nc - 1}")
            hp[f"{name}_out"] = {"kernel": _conv2d_kernel(fin["weight"]),
                                 "bias": fin["bias"]}
        params[f"head_{i}"] = hp
        stats[f"head_{i}"] = hs
    return params, stats


def convert_centerpoint_checkpoint(state_dict, model_cfg, class_names):
    """CenterPoint: MeanVFE (no params) + VoxelResBackBone8x (dense or
    sparse by BACKBONE_3D.NAME) + BaseBEVBackbone + CenterHead."""
    tree = TorchTree(state_dict)
    params, stats = {}, {}
    bb_name = model_cfg.BACKBONE_3D.get("NAME", "VoxelResBackBone8x")
    if bb_name == "SparseVoxelResBackBone8x":
        p, s = convert_sparse_voxel_res_backbone(tree.sub("backbone_3d"))
    else:
        p, s = convert_voxel_res_backbone_dense(tree.sub("backbone_3d"))
    params["backbone_3d"], stats["backbone_3d"] = p, s
    p, s = convert_bev_backbone(tree.sub("backbone_2d"),
                                model_cfg.BACKBONE_2D)
    params["backbone_2d"], stats["backbone_2d"] = p, s
    head_cfg = model_cfg.DENSE_HEAD
    n_each = [len([c for c in group if c in class_names])
              for group in head_cfg.CLASS_NAMES_EACH_HEAD]
    p, s = convert_center_head(tree.sub("dense_head"), head_cfg, n_each)
    params["dense_head"], stats["dense_head"] = p, s
    return {"params": params, "batch_stats": stats}


def convert_pointpillar_checkpoint(state_dict, model_cfg):
    """PointPillar: vfe + backbone_2d + dense_head (AnchorHeadSingle)."""
    tree = TorchTree(state_dict)
    params, stats = {}, {}
    p, s = convert_pillar_vfe(tree.sub("vfe"),
                              list(model_cfg.VFE.NUM_FILTERS))
    params["vfe"], stats["vfe"] = p, s
    p, s = convert_bev_backbone(tree.sub("backbone_2d"),
                                model_cfg.BACKBONE_2D)
    params["backbone_2d"], stats["backbone_2d"] = p, s
    params["dense_head"] = convert_anchor_head_single(tree.sub("dense_head"))
    return {"params": params, "batch_stats": stats}


def convert_second_checkpoint(state_dict, model_cfg):
    """SECOND: backbone_3d (dense analogue, sparse gather-matmul, or
    res variant by BACKBONE_3D.NAME) + backbone_2d + dense_head.
    MeanVFE and HeightCompression have no parameters."""
    tree = TorchTree(state_dict)
    bb_cfg = model_cfg.BACKBONE_3D
    widths = list(bb_cfg.get("NUM_FILTERS", [16, 16, 32, 64, 64]))
    c_out = int(bb_cfg.get("NUM_OUTPUT_FEATURES", 128))
    params, stats = {}, {}
    bb_name = bb_cfg.get("NAME", "VoxelBackBone8x")
    if bb_name == "SparseVoxelBackBone8x":
        p, s = convert_sparse_voxel_backbone(tree.sub("backbone_3d"),
                                             widths, c_out,
                                             input_channels=4)
    elif bb_name == "SparseVoxelResBackBone8x":
        p, s = convert_sparse_voxel_res_backbone(tree.sub("backbone_3d"),
                                                 input_channels=4)
    elif bb_name == "VoxelResBackBone8x":
        p, s = convert_voxel_res_backbone_dense(tree.sub("backbone_3d"),
                                                input_channels=4)
    else:
        p, s = convert_voxel_backbone_dense(tree.sub("backbone_3d"),
                                            widths, c_out,
                                            input_channels=4)
    params["backbone_3d"], stats["backbone_3d"] = p, s
    p, s = convert_bev_backbone(tree.sub("backbone_2d"),
                                model_cfg.BACKBONE_2D)
    params["backbone_2d"], stats["backbone_2d"] = p, s
    params["dense_head"] = convert_anchor_head_single(tree.sub("dense_head"))
    return {"params": params, "batch_stats": stats}


def convert_second_iou_checkpoint(state_dict, model_cfg):
    """SECOND-IoU (second_net_iou.py): the SECOND first stage + the
    SECONDHead IoU-quality RoI head."""
    out = convert_second_checkpoint(state_dict, model_cfg)
    tree = TorchTree(state_dict)
    p, s = convert_second_roi_head(tree.sub("roi_head"),
                                   model_cfg.ROI_HEAD)
    out["params"]["roi_head"] = p
    out["batch_stats"]["roi_head"] = s
    return out


def convert_voxelrcnn_checkpoint(state_dict, model_cfg):
    """Voxel-RCNN (voxel_rcnn.py): the SECOND first stage + the
    VoxelRCNNHead multi-scale grid-pool RoI head."""
    out = convert_second_checkpoint(state_dict, model_cfg)
    tree = TorchTree(state_dict)
    p, s = convert_voxelrcnn_roi_head(tree.sub("roi_head"),
                                      model_cfg.ROI_HEAD)
    out["params"]["roi_head"] = p
    out["batch_stats"]["roi_head"] = s
    return out


def convert_checkpoint_any(state_dict, model_cfg, num_class=3,
                           input_channels=4, class_names=None):
    """Dispatch by MODEL.NAME; falls back to the IASSD converter."""
    name = model_cfg.get("NAME", "IASSD")
    if name == "PointPillar":
        return convert_pointpillar_checkpoint(state_dict, model_cfg)
    if name in ("SECOND", "SECONDNet"):
        return convert_second_checkpoint(state_dict, model_cfg)
    if name == "SECONDNetIoU":
        return convert_second_iou_checkpoint(state_dict, model_cfg)
    if name == "VoxelRCNN":
        return convert_voxelrcnn_checkpoint(state_dict, model_cfg)
    if name == "PartA2Free" or (
        name == "PointRCNN" and "BACKBONE_3D" in model_cfg
        and "UNet" in str(model_cfg.BACKBONE_3D.get("NAME", ""))
    ):
        # the reference overloads MODEL.NAME 'PointRCNN' for PartA2-free
        # (PartA2_free.yaml wires it with a UNetV2 voxel backbone)
        return convert_parta2_checkpoint(state_dict, model_cfg,
                                         anchor=False)
    if name == "PointRCNN":
        return convert_pointrcnn_checkpoint(
            state_dict, model_cfg, input_channels=input_channels)
    if name in ("PVRCNN", "PVRCNNPlusPlus"):
        return convert_pvrcnn_checkpoint(state_dict, model_cfg)
    if name == "PartA2Net":
        return convert_parta2_checkpoint(state_dict, model_cfg, anchor=True)
    if name == "CenterPoint":
        return convert_centerpoint_checkpoint(
            state_dict, model_cfg, class_names or [])
    if name == "CaDDN":
        # The reference CaDDN embeds torchvision's deeplabv3_resnet101
        # trunk (pcdet/models/backbones_3d/vfe/image_vfe_modules/ffn/
        # ddn/ddn_deeplabv3.py); the TPU DDN is a self-contained flax
        # encoder by design (image_vfe.py docstring), so there is no
        # 1:1 weight mapping — CaDDN parity is architectural, not
        # checkpoint-level.
        raise NotImplementedError(
            "CaDDN checkpoints are not convertible: the reference DDN "
            "is a torchvision deeplabv3_resnet101 trunk with a "
            "different architecture from the TPU-native flax DDN")
    return convert_checkpoint(
        state_dict, model_cfg, num_class=num_class,
        input_channels=input_channels,
    )


def convert_checkpoint(state_dict, model_cfg, num_class=3, input_channels=4):
    """state_dict: torch name -> numpy array. Returns flax variables dict."""
    sa_cfg = model_cfg.BACKBONE_3D.SA_CONFIG
    tree = TorchTree(state_dict)
    bb_params, bb_stats = {}, {}

    channel_in = input_channels - 3
    channel_out_list = [channel_in]
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        layer_input = sa_cfg.LAYER_INPUT[k]
        channel_in = channel_out_list[
            layer_input[-1] if isinstance(layer_input, list) else layer_input
        ]
        mod_tree = tree.sub(f"backbone_3d.SA_modules.{k}")
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer":
            mlps = [[channel_in] + list(m) for m in sa_cfg.MLPS[k]]
            channel_out = sum(m[-1] for m in mlps) if mlps else 0
            # the reference only builds aggregation/confidence layers when
            # the SA layer has grouping MLPs (pointnet2_modules.py:1470-1487)
            agg = (
                list(sa_cfg.AGGREGATION_MLPS[k])
                if sa_cfg.AGGREGATION_MLPS[k] and sa_cfg.MLPS[k] else None
            )
            conf = (
                list(sa_cfg.CONFIDENCE_MLPS[k])
                if sa_cfg.CONFIDENCE_MLPS[k] and sa_cfg.MLPS[k] else None
            )
            if agg:
                channel_out = agg[-1]
            if k < 1 or k > 4:
                p, s = convert_sa_withsampling(mod_tree, mlps, agg, conf)
            else:
                p, s = convert_sa_ellipsoid(mod_tree, mlps, agg, conf)
        else:
            p, s = convert_vote_layer(mod_tree, list(sa_cfg.MLPS[k]))
            channel_out = channel_out_list[layer_input]
        bb_params[f"SA_modules_{k}"] = p
        bb_stats[f"SA_modules_{k}"] = s
        channel_out_list.append(channel_out)

    head_cfg = model_cfg.POINT_HEAD
    hp, hs = {}, {}
    p, s, out = convert_fc_head(tree.sub("point_head.cls_center_layers"),
                                list(head_cfg.CLS_FC))
    hp["cls_center_layers"], hs["cls_center_layers"], hp["cls_center_out"] = p, s, out
    p, s, out = convert_fc_head(tree.sub("point_head.box_center_layers"),
                                list(head_cfg.REG_FC))
    hp["box_center_layers"], hs["box_center_layers"], hp["box_center_out"] = p, s, out

    def drop_empty(d):
        return {
            k: drop_empty(v) if isinstance(v, dict) else v
            for k, v in d.items()
            if not (isinstance(v, dict) and not drop_empty(v))
        }

    return {
        "params": drop_empty({"backbone_3d": bb_params, "point_head": hp}),
        "batch_stats": drop_empty({"backbone_3d": bb_stats, "point_head": hs}),
    }


# --- the port's side: refusals, the chain into the weight bridge, the CLI

def check_convertible(model_cfg):
    """Raise ``NotImplementedError`` for a model whose reference checkpoint
    the mapping above cannot carry: the multi-head anchor head (its
    ``rpn_heads.*`` are read by no converter, ``convert_anchor_head_single``
    gives an empty ``dense_head``) and PDA-SSD's ablations (``convert_
    checkpoint`` maps the shipped SA modules and head only).  CaDDN is
    refused by ``convert_checkpoint_any`` itself."""
    name = model_cfg.get("NAME", "IASSD")
    head = (model_cfg.get("DENSE_HEAD") or {}).get("NAME")
    if head == "AnchorHeadMulti":
        raise NotImplementedError(
            f"{name} over AnchorHeadMulti: the converter maps no multi-head anchor head "
            "(its rpn_heads.* would leave dense_head empty)")
    if name != "IASSD":
        return
    sa_cfg = model_cfg.BACKBONE_3D.SA_CONFIG
    refused = []
    if str(sa_cfg.get("PDA_VARIANT", "ellipsoid")) != "ellipsoid":
        refused.append(f"PDA_VARIANT {sa_cfg.PDA_VARIANT} (No_Global)")
    if str(sa_cfg.get("POINTFORMER_IMPL", "pre_norm")) == "encoder_layer":
        refused.append("POINTFORMER_IMPL encoder_layer (EncoderLayer)")
    if sa_cfg.get("PROPOSAL_AWARE_CBAM", False):
        refused.append("PROPOSAL_AWARE_CBAM (Proposal_Aware-CBAM)")
    if model_cfg.POINT_HEAD.get("IOU_FC", None) is not None:
        refused.append("POINT_HEAD.IOU_FC (the IoU head)")
    if refused:
        raise NotImplementedError(
            "IASSD ablation: the converter maps the shipped PDA-SSD's SA modules and head "
            "only, not " + ", ".join(refused))


def reference_variables(state_dict, model_cfg, num_class, class_names=None, input_channels=4):
    """The flax variable tree of a reference ``state_dict`` (name -> numpy
    array): ``check_convertible``, then ``convert_checkpoint_any``.  A key
    the mapping needs and the dict lacks raises ``ValueError`` naming the
    model."""
    check_convertible(model_cfg)
    try:
        return convert_checkpoint_any(state_dict, model_cfg, num_class=num_class,
                                      input_channels=input_channels,
                                      class_names=list(class_names or []))
    except KeyError as e:
        raise ValueError(f"{model_cfg.get('NAME', 'IASSD')}: the reference state_dict "
                         f"lacks {e}") from e


def fill_model(model, variables, model_cfg):
    """``load_jax_variables`` of a converted tree, its errors naming the
    model: every port tensor must be filled, by a leaf of the tree's
    shape."""
    try:
        return load_jax_variables(model, variables)
    except (KeyError, ValueError) as e:
        raise ValueError(f"{model_cfg.get('NAME', 'IASSD')}: the converted reference "
                         f"checkpoint does not fill the port's model: {e}") from e


def load_reference_state_dict(model, state_dict, model_cfg, num_class, class_names=None,
                              input_channels=4):
    """Fill the port's ``model`` from a reference ``state_dict`` of the
    same config (``reference_variables``, then ``fill_model``)."""
    variables = reference_variables(state_dict, model_cfg, num_class, class_names,
                                    input_channels)
    return fill_model(model, variables, model_cfg)


def read_reference_checkpoint(path):
    """``(wrapper, state_dict)`` of a reference ``.pth``, zip or legacy
    format, read with ``weights_only=True``: the wrapper is OpenPCDet's
    dict (``epoch``, ``it``, ``model_state``, ...) or the bare
    ``state_dict``; the state as numpy arrays."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state = ck.get("model_state", ck)
    return ck, {k: v.numpy() for k, v in state.items() if isinstance(v, torch.Tensor)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="reference .pth -> the port's checkpoint")
    parser.add_argument("--torch_ckpt", required=True, help=".pth checkpoint")
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--output", required=True, help="the port's checkpoint to write")
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    ck, sd = read_reference_checkpoint(args.torch_ckpt)
    variables = reference_variables(sd, cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES)
    dataset = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                              training=False, root_path=".")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=dataset, device="cpu")
    fill_model(model, variables, cfg.MODEL)
    save_checkpoint({"epoch": ck.get("epoch", 0), "it": ck.get("it", 0),
                     "model_state": model.state_dict(), "optimizer_state": None,
                     "version": "converted+%s" % ck.get("version", "unknown")}, args.output)
    print("wrote", args.output)
    return args.output


if __name__ == "__main__":
    main()

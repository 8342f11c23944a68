"""IA-SSD / PDA-SSD backbone (channels-last).

Counterpart of ``pdanet_tpu/models/backbones_3d/iassd_backbone.py``: the
SA stack with D-FPS and ctr-aware sampling, the PDA (ellipsoid) module with
its density, position, global and raw branches fused by a K-neighbour
pre-norm transformer, the vote layer, and the stacked-D-FPS identity
shortcut.  Module and attribute names follow the flax names
(``SA_modules_{k}``, ``mlps_{i}``, ``Local_pointformer_{i}`` ...).

Beyond the JAX package's output dict, the backbone returns each layer's
sampling indices (``sampled_idx``) and ball-query indices
(``ball_query_idx``), so a run can be checked index by index.

Training: ``Module.training`` is the JAX package's ``train`` flag.  The
gradient flows everywhere the JAX backbone lets it, through the vote
centres into SA5's relative coordinates included; only the index ops
(sampling and ball query) take detached inputs.  Every max-pool over the
K neighbours is ``Tensor.max(dim).values``, whose gradient goes to the
first maximal slot, as ``pdanet_tpu/ops/maxpool.max_first`` does: the
ball query's padding makes exact ties common.
"""

import torch
from torch import nn

from ...ops.ball_query import ball_query_multi
from ...ops.grouping import gather_points, group_points
from ...ops.sampling import farthest_point_sample
from ...utils.easydict import EasyDict
from ..blocks import (Dense, DensityNet, MLPStack, TrainEvalDtype,
                      TransformerEncoderLayerPreNorm)

_LATER = "ROADMAP queue 1 item 4"


def sample_indices(sample_type, npoint, xyz, features, cls_features):
    """Sampling dispatch (pointnet2_modules.py:1556-1644), D-FPS and
    ctr-aware only.  Returns (B, npoint) int32 indices."""
    B, N, _ = xyz.shape
    if N <= npoint:  # no-downsample passthrough
        return torch.arange(N, dtype=torch.int32, device=xyz.device).expand(B, N)
    if ("cls" in sample_type) or ("ctr" in sample_type):
        score = torch.sigmoid(cls_features.detach().max(dim=-1).values)  # (B, N)
        # stable descending sort: ties keep the lower index first, as
        # jax.lax.top_k does
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices
        return idx[:, :npoint].to(torch.int32)
    if "D-FPS" in sample_type or "DFS" in sample_type:
        return farthest_point_sample(xyz.contiguous(), npoint)
    raise NotImplementedError(f"sample_type={sample_type} is {_LATER}")


def run_sampling(sample_type_list, sample_range_list, npoint_list, xyz,
                 features, cls_features):
    """Multi-segment sampling loop (pointnet2_modules.py:1541-1646)."""
    out = []
    last_end = 0
    for sample_type, sample_range, npoint in zip(
        sample_type_list, sample_range_list, npoint_list
    ):
        if npoint <= 0:
            continue
        if sample_range == -1:
            sl = slice(last_end, None)
        else:
            sl = slice(last_end, sample_range)
            last_end += sample_range
        xyz_tmp = xyz[:, sl, :]
        feat_tmp = features[:, sl, :] if features is not None else None
        cls_tmp = cls_features[:, sl, :] if cls_features is not None else None
        idx = sample_indices(sample_type, npoint, xyz_tmp, feat_tmp, cls_tmp)
        out.append(idx + sl.start if sl.start else idx)
    return torch.cat(out, dim=-1)


def query_group_density_directional(radius, xyz, new_xyz, features, idx):
    """``QueryAndGroup_alone_grouped_density_directional``: per neighbour
    [abs xyz (3) | gaussian density (1) | unit direction (3) | features]."""
    g = group_points(torch.cat([xyz, features], dim=-1), idx)
    grouped_xyz = g[..., 0:3]  # (B, M, K, 3)
    rel = grouped_xyz - new_xyz[:, :, None, :]
    d2 = torch.sum(rel * rel, dim=-1)
    density = torch.exp(-d2 / (2.0 * radius ** 2)) / (2.5 * radius)
    return grouped_xyz, density[..., None], rel / radius, g[..., 3:]


class _SAModule(nn.Module):
    """What both SA modules share: sampling, the multi-radius query, and
    the aggregation and confidence layers after the per-radius branches."""

    def __init__(self, channel_in, npoint_list, sample_range_list,
                 sample_type_list, radii, nsamples, mlps, aggregation_mlp,
                 confidence_mlp, num_class, compute_dtype):
        super().__init__()
        self.npoint_list = tuple(npoint_list)
        self.sample_range_list = tuple(sample_range_list)
        self.sample_type_list = tuple(sample_type_list)
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.has_aggregation = bool(self.radii and aggregation_mlp)
        self.has_confidence = bool(confidence_mlp)
        out = channel_in  # without radii the layer only gathers
        if self.radii:
            out = sum(m[-1] for m in mlps)
        if self.has_aggregation:
            self.aggregation_layer = MLPStack(out, aggregation_mlp,
                                              dtype=compute_dtype)
            out = aggregation_mlp[-1]
        if self.has_confidence:
            self.confidence_mlp = MLPStack(out, confidence_mlp,
                                           dtype=compute_dtype)
            self.confidence_out = Dense(confidence_mlp[-1], num_class)

    def sample(self, xyz, features, cls_features, fps_identity):
        if fps_identity:
            # input is D-FPS selection-ordered: FPS is the identity prefix
            B, N = xyz.shape[:2]
            m = min(int(self.npoint_list[0]), N)
            return torch.arange(m, dtype=torch.int32, device=xyz.device).expand(B, m)
        return run_sampling(self.sample_type_list, self.sample_range_list,
                            self.npoint_list, xyz, features, cls_features)

    def query(self, xyz, new_xyz):
        return ball_query_multi(self.radii, self.nsamples, xyz.contiguous(),
                                new_xyz.contiguous())

    def finish(self, scale_feats, xyz, features, sampled_idx):
        """Aggregate the per-radius features (or gather, without radii)
        and run the confidence layers: (new_features, cls_preds)."""
        if self.radii:
            new_features = torch.cat(scale_feats, dim=-1)
            if self.has_aggregation:
                new_features = self.aggregation_layer(new_features)
            new_features = new_features.to(xyz.dtype)  # leave bf16 compute
        else:
            new_features = gather_points(features, sampled_idx)
        cls_preds = None
        if self.has_confidence:
            cls_preds = self.confidence_out(
                self.confidence_mlp(new_features)).to(xyz.dtype)
        return new_features, cls_preds


class SAModuleWithSampling(_SAModule):
    """IA-SSD SA layer (pointnet2_modules.py:1417-1686): MLP over
    [relative xyz | features] per radius, max-pool over K, aggregation.
    ``mlps``: each [channel_in + 3, ...] (the use_xyz concat)."""

    def __init__(self, channel_in, npoint_list, sample_range_list,
                 sample_type_list, radii, nsamples, mlps, aggregation_mlp,
                 confidence_mlp, num_class, compute_dtype=None):
        super().__init__(channel_in, npoint_list, sample_range_list,
                         sample_type_list, radii, nsamples, mlps,
                         aggregation_mlp, confidence_mlp, num_class,
                         compute_dtype)
        for i in range(len(self.radii)):
            self.add_module(f"mlps_{i}", MLPStack(
                mlps[i][0], mlps[i][1:], dtype=compute_dtype))

    def forward(self, xyz, features, cls_features=None, ctr_xyz=None,
                fps_identity=False):
        sampled_idx = None
        if ctr_xyz is None:
            sampled_idx = self.sample(xyz, features, cls_features, fps_identity)
            new_xyz = (xyz[:, :sampled_idx.shape[1]] if fps_identity
                       else gather_points(xyz, sampled_idx))
        else:
            new_xyz = ctr_xyz
        idx_list = self.query(xyz, new_xyz) if self.radii else None
        scale_feats = []
        if self.radii:
            src = torch.cat([xyz, features], dim=-1)
            for i in range(len(self.radii)):
                g = group_points(src, idx_list[i])
                grouped = torch.cat(
                    [g[..., 0:3] - new_xyz[:, :, None, :], g[..., 3:]], dim=-1)
                h = getattr(self, f"mlps_{i}")(grouped)
                scale_feats.append(h.max(dim=2).values)
        new_features, cls_preds = self.finish(scale_feats, xyz, features,
                                              sampled_idx)
        return new_xyz, new_features, cls_preds, sampled_idx, idx_list


class SAModuleEllipsoid(_SAModule):
    """The PDA SA layer (pointnet2_modules.py:541-954), pre-norm variant.

    Per radius, four branches over the grouped neighbourhood -- density
    scaled features (DensityNet), the RPPE position encoding, a per-centre
    global MLP broadcast over K, and the raw grouped features -- are
    concatenated to 4d channels, fused by a pre-norm transformer over the K
    neighbours, max-pooled and projected by fin_conv.  ``mlps``: each
    [channel_in, ...] (no +3).
    """

    def __init__(self, channel_in, npoint_list, sample_range_list,
                 sample_type_list, radii, nsamples, mlps, aggregation_mlp,
                 confidence_mlp, num_class, compute_dtype=None):
        super().__init__(channel_in, npoint_list, sample_range_list,
                         sample_type_list, radii, nsamples, mlps,
                         aggregation_mlp, confidence_mlp, num_class,
                         compute_dtype)
        for i in range(len(self.radii)):
            d = mlps[i][0]
            self.add_module(f"point_density_{i}", DensityNet())
            self.add_module(f"position_mlp_{i}", MLPStack(
                12, (d // 2, d), dtype=compute_dtype))
            self.add_module(f"global_mlps_{i}", MLPStack(
                3 + channel_in, (d, d), dtype=compute_dtype))
            self.add_module(f"Local_pointformer_{i}", TransformerEncoderLayerPreNorm(
                4 * d, 4, 2 * d, dtype=compute_dtype))
            self.add_module(f"fin_conv_{i}", MLPStack(
                4 * d, (2 * d, mlps[i][-1]), dtype=compute_dtype))

    def forward(self, xyz, features, cls_features=None, ctr_xyz=None,
                fps_identity=False):
        sampled_idx = None
        if ctr_xyz is None:
            sampled_idx = self.sample(xyz, features, cls_features, fps_identity)
            if fps_identity:
                m = sampled_idx.shape[1]
                new_xyz, new_xyz_feature = xyz[:, :m], features[:, :m]
            else:
                new_xyz = gather_points(xyz, sampled_idx)
                new_xyz_feature = gather_points(features, sampled_idx)
        else:
            new_xyz, new_xyz_feature = ctr_xyz, None
        idx_list = self.query(xyz, new_xyz) if self.radii else None
        if self.radii:
            global_input = torch.cat([new_xyz, new_xyz_feature], dim=-1)
        scale_feats = []
        for i, radius in enumerate(self.radii):
            grouped_xyz, density, direction, grouped_feats = (
                query_group_density_directional(
                    radius, xyz, new_xyz, features, idx_list[i]))
            dmax = density.max(dim=2, keepdim=True).values
            scale = getattr(self, f"point_density_{i}")(density / dmax)
            feat_density = grouped_feats * scale
            centers_k = new_xyz[:, :, None, :].expand_as(grouped_xyz)
            rppe = torch.cat([centers_k, grouped_xyz,
                              centers_k - grouped_xyz, direction], dim=-1)
            rppe = getattr(self, f"position_mlp_{i}")(rppe)
            g = getattr(self, f"global_mlps_{i}")(global_input)
            g_k = g[:, :, None, :].expand(rppe.shape[:3] + (g.shape[-1],))
            # mixed bf16/f32 branches concatenate to f32, as in JAX
            fused = torch.cat([rppe, feat_density, grouped_feats, g_k], dim=-1)
            fused = getattr(self, f"Local_pointformer_{i}")(fused)
            pooled = fused.max(dim=2).values
            scale_feats.append(getattr(self, f"fin_conv_{i}")(pooled))
        new_features, cls_preds = self.finish(scale_feats, xyz, features,
                                              sampled_idx)
        return new_xyz, new_features, cls_preds, sampled_idx, idx_list


class VoteLayer(nn.Module):
    """Centre-shift voting (pointnet2_modules.py:1689-1753)."""

    def __init__(self, channel_in, mlp_list, max_translate_range):
        super().__init__()
        self.has_mlp = bool(mlp_list)
        if self.has_mlp:
            self.mlp_modules = MLPStack(channel_in, mlp_list)
        self.ctr_reg = Dense(mlp_list[-1] if mlp_list else channel_in, 3)
        limit = (torch.tensor(max_translate_range, dtype=torch.float32)
                 if max_translate_range is not None else None)
        self.register_buffer("limit", limit, persistent=False)

    def forward(self, xyz, features):
        h = self.mlp_modules(features) if self.has_mlp else features
        ctr_offsets = self.ctr_reg(h)
        if self.limit is not None:
            limited = torch.minimum(torch.maximum(ctr_offsets, -self.limit),
                                    self.limit)
            return xyz + limited, xyz, ctr_offsets
        return xyz + ctr_offsets, xyz, ctr_offsets


def compute_dtype_of(model_cfg):
    """The blocks' dtype policy, read as the JAX backbone reads it
    (``iassd_backbone.py:455-467``): ``TRAIN_COMPUTE_DTYPE: bfloat16``
    gives bfloat16 in training and at eval; ``COMPUTE_DTYPE: bfloat16``
    alone gives bfloat16 at eval and float32 training; neither, float32."""
    bf16 = ("bfloat16", "bf16")
    if str(model_cfg.get("TRAIN_COMPUTE_DTYPE", "")) in bf16:
        return TrainEvalDtype(torch.bfloat16)
    if str(model_cfg.get("COMPUTE_DTYPE", "")) in bf16:
        return torch.bfloat16
    return None


class IASSDBackbone(nn.Module):
    """SA-stack backbone (IASSD_backbone.py:9-240).

    Input: points (B, N, 3 + C), channels [x, y, z, feats...].  Output dict
    as the JAX package's (centers, centers_origin, ctr_offsets,
    centers_features, encoder_xyz, encoder_coords, encoder_features,
    sa_ins_preds) plus ``sampled_idx`` and ``ball_query_idx`` per layer.
    """

    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__()
        mcfg = EasyDict(model_cfg)
        sa_cfg = mcfg.SA_CONFIG
        self.layer_types = list(sa_cfg.LAYER_TYPE)
        self.ctr_idx_list = list(sa_cfg.CTR_INDEX)
        self.layer_inputs = list(sa_cfg.LAYER_INPUT)
        aggregation_mlps = sa_cfg.get("AGGREGATION_MLPS", None)
        confidence_mlps = sa_cfg.get("CONFIDENCE_MLPS", None)
        compute_dtype = compute_dtype_of(mcfg)
        max_translate = sa_cfg.get("MAX_TRANSLATE_RANGE", None)
        if str(sa_cfg.get("PDA_VARIANT", "ellipsoid")) != "ellipsoid" or \
                str(sa_cfg.get("POINTFORMER_IMPL", "pre_norm")) != "pre_norm" or \
                sa_cfg.get("PROPOSAL_AWARE_CBAM", False):
            raise NotImplementedError(f"the SA ablation variants are {_LATER}")

        # stacked-D-FPS identity shortcut: FPS over a selection-ordered
        # point set is the identity prefix (proof in the JAX package,
        # iassd_backbone.py:470-501)
        shortcut = bool(mcfg.get("FPS_IDENTITY_SHORTCUT", True))

        def is_pure_dfps(j):
            return (
                self.layer_types[j] == "SA_Layer"
                and list(sa_cfg.SAMPLE_METHOD_LIST[j]) == ["D-FPS"]
                and list(sa_cfg.SAMPLE_RANGE_LIST[j]) == [-1]
                and int(self.ctr_idx_list[j]) == -1
            )

        self.fps_identity = []
        for k in range(len(sa_cfg.NSAMPLE_LIST)):
            li = self.layer_inputs[k]
            li = li[-1] if isinstance(li, list) else li
            self.fps_identity.append(
                shortcut and is_pure_dfps(k) and li > 0 and is_pure_dfps(li - 1))

        channel_out_list = [input_channels - 3]
        self.n_layers = len(sa_cfg.NSAMPLE_LIST)
        for k in range(self.n_layers):
            li = self.layer_inputs[k]
            channel_in = channel_out_list[li[-1] if isinstance(li, list) else li]
            if self.layer_types[k] == "SA_Layer":
                mlps = [[channel_in] + list(m) for m in sa_cfg.MLPS[k]]
                channel_out = sum(m[-1] for m in mlps)
                agg = None
                if aggregation_mlps and aggregation_mlps[k]:
                    agg = list(aggregation_mlps[k])
                    channel_out = agg[-1]
                conf = None
                if confidence_mlps and confidence_mlps[k]:
                    conf = list(confidence_mlps[k])
                # PDA placement rule (IASSD_backbone.py:62-94): layers 1-4
                # use the PDA module, the others plain WithSampling
                if k < 1 or k > 4:
                    cls = SAModuleWithSampling
                    mlps = [[m[0] + 3] + m[1:] for m in mlps]
                else:
                    cls = SAModuleEllipsoid
                module = cls(
                    channel_in,
                    npoint_list=sa_cfg.NPOINT_LIST[k],
                    sample_range_list=sa_cfg.SAMPLE_RANGE_LIST[k],
                    sample_type_list=sa_cfg.SAMPLE_METHOD_LIST[k],
                    radii=sa_cfg.RADIUS_LIST[k],
                    nsamples=sa_cfg.NSAMPLE_LIST[k],
                    mlps=mlps,
                    aggregation_mlp=agg,
                    confidence_mlp=conf,
                    num_class=num_class,
                    compute_dtype=compute_dtype,
                )
            elif self.layer_types[k] == "Vote_Layer":
                module = VoteLayer(channel_in, list(sa_cfg.MLPS[k]),
                                   max_translate)
                channel_out = channel_out_list[li]
            else:
                raise NotImplementedError(f"LAYER_TYPE {self.layer_types[k]}")
            self.add_module(f"SA_modules_{k}", module)
            channel_out_list.append(channel_out)
        self.num_point_features = channel_out_list[-1]

    def forward(self, points):
        xyz = points[..., 0:3]
        features = points[..., 3:]
        encoder_xyz = [xyz]
        encoder_features = [features]
        encoder_coords = [xyz]
        sa_ins_preds, sampled, ball = [], [], []
        li_cls_pred = None
        centers = centers_origin = ctr_offsets = None
        for i in range(self.n_layers):
            module = getattr(self, f"SA_modules_{i}")
            xyz_input = encoder_xyz[self.layer_inputs[i]]
            feature_input = encoder_features[self.layer_inputs[i]]
            samp = bq = None
            if self.layer_types[i] == "SA_Layer":
                ctr_xyz = (encoder_xyz[self.ctr_idx_list[i]]
                           if self.ctr_idx_list[i] != -1 else None)
                li_xyz, li_features, li_cls_pred, samp, bq = module(
                    xyz_input, feature_input, li_cls_pred, ctr_xyz=ctr_xyz,
                    fps_identity=self.fps_identity[i])
            else:
                li_xyz, xyz_select, ctr_offsets = module(xyz_input, feature_input)
                li_features = feature_input
                centers, centers_origin = li_xyz, xyz_select
                encoder_coords.append(centers_origin)
            encoder_xyz.append(li_xyz)
            encoder_coords.append(li_xyz)
            encoder_features.append(li_features)
            sa_ins_preds.append(li_cls_pred)
            sampled.append(samp)
            ball.append(bq)
        return {
            "centers": centers,
            "centers_origin": centers_origin,
            "ctr_offsets": ctr_offsets,
            "centers_features": encoder_features[-1],
            "encoder_xyz": encoder_xyz,
            "encoder_coords": encoder_coords,
            "encoder_features": encoder_features,
            "sa_ins_preds": sa_ins_preds,
            "sampled_idx": sampled,
            "ball_query_idx": ball,
        }

"""CaDDN's image VFE: counterpart of ``pdanet_tpu/models/backbones_3d/vfe/
image_vfe.py`` (``pcdet/models/backbones_3d/vfe/image_vfe.py`` and its
``image_vfe_modules``: DepthFFN, the DDN, DDNLoss and its balancer,
FrustumToVoxel with its grid generator and sampler).

* The DDN is the JAX package's self-contained encoder (no pretrained
  weights; the reference bootstraps torchvision's deeplabv3_resnet101):
  a 7 x 7 / 2 stem, a 3 x 3 / 2 max-pool, two residual blocks (the
  stride-4 features), a dilated tail and an ASPP-like classifier whose
  depth logits are resized bilinearly to the feature stride.  Every
  convolution pads as flax's ``"SAME"`` does (``blocks.Conv``: the odd unit
  after, so the stem pads an even side (2, 3)); the max-pool pads with
  -inf the same way.  The resize is ``F.interpolate`` (bilinear,
  align_corners False), which takes ``jax.image.resize``'s half-pixel
  centres and edge renormalization where it upsamples.
* The frustum (B, C, D, Hf, Wf) is each pixel's features times its depth
  distribution; each voxel centre (the JAX package's numpy arithmetic,
  rounded to the model's dtype) goes lidar -> camera -> image (u, v) and
  an LID depth bin, is normalized with the align_corners=True formula and
  sampled by ``F.grid_sample`` with align_corners False and zero padding
  (the reference's kept quirk); a non-finite coordinate samples nothing.

Module and parameter names are the flax ones (``ddn.stem.Conv_0``,
``ddn.layer1_a.c1.BatchNorm_0``, ``channel_reduce``, ``channel_reduce_bn``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....utils import transform_utils
from ....utils.easydict import EasyDict
from ...blocks import BatchNorm, Conv, _same_padding

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvBNReLU(nn.Module):
    """Conv ('SAME', no bias) -> BatchNorm (momentum 0.9, eps 1e-5) ->
    ReLU (JAX :36-51)."""

    def __init__(self, in_features, features, kernel=3, stride=1, dilation=1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, stride=stride, bias=False,
                           dilation=dilation)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class ResBlock2D(nn.Module):
    """c1 (ConvBNReLU) -> c2 -> bn2, plus the input (through a 1 x 1
    ``proj`` where the width or the stride changes), ReLU (JAX :54-74)."""

    def __init__(self, in_features, features, stride=1, dilation=1):
        super().__init__()
        self.c1 = ConvBNReLU(in_features, features, 3, stride, dilation)
        self.c2 = Conv(features, features, 3, bias=False, dilation=dilation)
        self.bn2 = BatchNorm(features)
        self.proj = (Conv(in_features, features, 1, stride=stride, bias=False)
                     if in_features != features or stride != 1 else None)

    def forward(self, x):
        h = self.bn2(self.c2(self.c1(x)))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(x + h)


def max_pool_same(x, k=3, s=2):
    """flax ``nn.max_pool`` with 'SAME' padding over a (B, H, W, C) map:
    -inf padding, the odd unit after."""
    x = x.permute(0, 3, 1, 2)
    (t, b), (l, r) = (_same_padding(n, k, s) for n in x.shape[2:])
    x = F.pad(x, (l, r, t, b), value=-torch.inf)
    return F.max_pool2d(x, k, s).permute(0, 2, 3, 1)


class DDNNet(nn.Module):
    """The depth distribution network (JAX :77-123): (B, H, W, 3) images in
    [0, 1] -> ``features`` (B, H/4, W/4, width) and ``logits`` (B, H/4,
    W/4, num_classes) at the same stride."""

    def __init__(self, num_classes, width=256):
        super().__init__()
        w = int(width)
        self.stem = ConvBNReLU(3, w // 4, 7, 2)
        self.layer1_a = ResBlock2D(w // 4, w)
        self.layer1_b = ResBlock2D(w, w)
        self.layer2 = ResBlock2D(w, w, stride=2)
        self.layer3 = ResBlock2D(w, w, dilation=2)
        self.layer4 = ResBlock2D(w, w, dilation=4)
        self.aspp_1x1 = ConvBNReLU(w, w // 2, 1)
        self.aspp_d6 = ConvBNReLU(w, w // 2, 3, dilation=6)
        self.aspp_d12 = ConvBNReLU(w, w // 2, 3, dilation=12)
        self.aspp_pool = ConvBNReLU(w, w // 2, 1)
        self.aspp_proj = ConvBNReLU(4 * (w // 2), w // 2, 1)
        self.cls_out = Conv(w // 2, int(num_classes), 1)

    def forward(self, images):
        dev = images.device
        # the ImageNet constants in the images' dtype, the quotient a
        # product with the folded reciprocal (XLA's)
        mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype)
        inv_std = torch.reciprocal(torch.tensor(IMAGENET_STD, dtype=images.dtype))
        x = (images - mean.to(dev)) * inv_std.to(dev)
        x = max_pool_same(self.stem(x))
        feat = self.layer1_b(self.layer1_a(x))
        x = self.layer4(self.layer3(self.layer2(feat)))
        branches = [self.aspp_1x1(x), self.aspp_d6(x), self.aspp_d12(x)]
        gp = self.aspp_pool(x.mean(dim=(1, 2), keepdim=True))
        branches.append(gp.expand(branches[0].shape))
        logits = self.cls_out(self.aspp_proj(torch.cat(branches, dim=-1)))
        logits = F.interpolate(logits.permute(0, 3, 1, 2), size=feat.shape[1:3],
                               mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        return {"features": feat, "logits": logits}


def create_frustum_features(image_features, depth_logits):
    """The depth-weighted plane sweep (depth_ffn.py:70-93): (B, H, W, C)
    features and (B, H, W, D + 1) logits -> the (B, C, D, H, W) frustum,
    each pixel's features times the softmax of its logits, the last bin
    dropped."""
    probs = torch.softmax(depth_logits, dim=-1)[..., :-1].permute(0, 3, 1, 2)  # (B, D, H, W)
    return probs[:, None] * image_features.permute(0, 3, 1, 2)[:, :, None]


def voxel_centers(grid_size, pc_range):
    """The (Z, Y, X, 3) lidar-frame voxel centres in float64, the JAX
    package's numpy arithmetic (JAX :179-193), which its models round to
    their dtype (float32, or none under x64)."""
    X, Y, Z = (int(g) for g in grid_size)
    pc_range = np.asarray(pc_range, np.float32)
    vs = (pc_range[3:] - pc_range[:3]) / np.array([X, Y, Z], np.float32)
    xs = (np.arange(X) + 0.5) * vs[0] + pc_range[0]
    ys = (np.arange(Y) + 0.5) * vs[1] + pc_range[1]
    zs = (np.arange(Z) + 0.5) * vs[2] + pc_range[2]
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1)


class FrustumToVoxel(nn.Module):
    """Frustum -> voxel grid (frustum_to_voxel.py:1-57 and
    frustum_grid_generator.py:1-148; JAX :174-232).  No parameters."""

    def __init__(self, grid_size, pc_range, disc_cfg):
        super().__init__()
        self.grid_size = tuple(int(g) for g in grid_size)  # (X, Y, Z)
        self.disc_cfg = dict(disc_cfg)
        # float64, rounded to the calibration's dtype at use
        self.register_buffer("centers", torch.from_numpy(voxel_centers(grid_size, pc_range)),
                             persistent=False)

    def sample_grid(self, lidar_to_cam, cam_to_img, image_shape):
        """The (B, Z, Y, X, 3) normalized (u, v, d) coordinates of every
        voxel centre, -2 where not finite."""
        num_bins = int(self.disc_cfg["num_bins"])
        dt = lidar_to_cam.dtype
        centers = self.centers.to(dt)
        homo = torch.cat([centers, torch.ones_like(centers[..., :1])], dim=-1)
        cam = torch.einsum("bij,zyxj->bzyxi", lidar_to_cam, homo)[..., :3]
        B = cam.shape[0]
        img, depth = transform_utils.project_to_image(cam_to_img, cam.reshape(B, -1, 3))
        dbin = transform_utils.bin_depths(depth, self.disc_cfg["mode"],
                                          self.disc_cfg["depth_min"],
                                          self.disc_cfg["depth_max"], num_bins)
        coords = torch.cat([img, dbin[..., None]], dim=-1)
        norm = transform_utils.normalize_coords(coords, (num_bins, *image_shape))
        norm = torch.where(torch.isfinite(norm), norm, -2.0)
        return norm.reshape(cam.shape)

    def forward(self, frustum, lidar_to_cam, cam_to_img, image_shape):
        """frustum (B, C, D, Hf, Wf) at the feature stride; lidar_to_cam (B,
        4, 4); cam_to_img (B, 3, 4) for the (Hf, Wf) ``image_shape`` grid ->
        the (B, C, Z, Y, X) voxel features."""
        grid = self.sample_grid(lidar_to_cam, cam_to_img, image_shape)
        return F.grid_sample(frustum, grid.to(frustum.dtype), mode="bilinear",
                             padding_mode="zeros", align_corners=False)


class ImageVFE(nn.Module):
    """DepthFFN + FrustumToVoxel (image_vfe.py:1-90; JAX :235-282): images
    (B, H, W, 3), the calibration matrices -> ``voxel_features`` (B, Z, Y,
    X, C) (a view of the sampler's (B, C, Z, Y, X) output) and
    ``depth_logits`` (B, Hf, Wf, D + 1)."""

    def __init__(self, model_cfg, grid_size, point_cloud_range, depth_downsample_factor=4):
        super().__init__()
        cfg = EasyDict(model_cfg)
        ffn = EasyDict(cfg.FFN)
        self.disc = dict(ffn.DISCRETIZE)
        width = int((ffn.get("DDN") or {}).get("WIDTH", 256))
        self.ddn = DDNNet(int(self.disc["num_bins"]) + 1, width)
        cr = EasyDict(ffn.CHANNEL_REDUCE)
        self.channel_reduce = Conv(width, int(cr.out_channels), int(cr.kernel_size),
                                   bias=bool(cr.get("bias", False)))
        self.channel_reduce_bn = BatchNorm(int(cr.out_channels))
        self.f2v = FrustumToVoxel(grid_size, point_cloud_range, self.disc)
        self.depth_downsample_factor = int(depth_downsample_factor)

    def forward(self, images, lidar_to_cam, cam_to_img):
        ddn = self.ddn(images)
        feats = torch.relu(self.channel_reduce_bn(self.channel_reduce(ddn["features"])))
        frustum = create_frustum_features(feats, ddn["logits"])
        # the calibration's pixels are the full image's; the frustum is at
        # the feature stride: its projection rows scaled (a power of two)
        s = 1.0 / float(self.depth_downsample_factor)
        scale = torch.tensor([[s], [s], [1.0]], dtype=cam_to_img.dtype, device=images.device)
        voxels = self.f2v(frustum, lidar_to_cam, cam_to_img * scale, feats.shape[1:3])
        return {"voxel_features": voxels.permute(0, 2, 3, 4, 1),
                "depth_logits": ddn["logits"]}


def ddn_loss(depth_logits, depth_maps, gt_boxes2d, disc_cfg, loss_cfg, downsample_factor=4):
    """The focal depth-classification loss with the fg / bg balance
    (ddn_loss.py:49-76, balancer.py:22-50; JAX :285-318): depth_logits (B,
    Hf, Wf, D + 1), depth_maps (B, Hf, Wf) already downsampled, gt_boxes2d
    (B, M, 4) at the image's scale -> ``(loss, {"ddn_loss": loss})``."""
    cfg = EasyDict(loss_cfg)
    args = EasyDict(cfg.ARGS) if "ARGS" in cfg else cfg
    num_bins = int(disc_cfg["num_bins"])
    target = transform_utils.bin_depths(depth_maps, disc_cfg["mode"], disc_cfg["depth_min"],
                                        disc_cfg["depth_max"], num_bins, target=True)
    logp = torch.log_softmax(depth_logits, dim=-1)
    logp_t = torch.gather(logp, -1, target[..., None])[..., 0]
    p_t = torch.exp(logp_t)
    alpha, gamma = float(args.get("alpha", 0.25)), float(args.get("gamma", 2.0))
    focal = alpha * (1.0 - p_t) ** gamma * -logp_t
    fg = transform_utils.compute_fg_mask(gt_boxes2d, tuple(focal.shape), downsample_factor)
    weights = torch.where(fg, float(args.get("fg_weight", 13.0)),
                          float(args.get("bg_weight", 1.0)))
    loss = (focal * weights).sum() / float(focal.numel()) * float(args.get("weight", 3.0))
    return loss, {"ddn_loss": loss}

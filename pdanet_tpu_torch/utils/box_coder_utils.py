"""Box coder: encode (training targets) and decode.

Counterpart of ``pdanet_tpu/utils/box_coder_utils.py:21-110``
(``PointResidual_BinOri_Coder``): xyz/size residuals against per-class
mean sizes plus a binned orientation with an in-bin residual.
"""

import numpy as np
import torch


class PointResidual_BinOri_Coder:
    """xyz/size residual + binned-orientation coder (reference :224-319)."""

    def __init__(self, use_mean_size=True, angle_bin_num=12, mean_size=None,
                 **kwargs):
        self.bin_size = int(kwargs.get("bin_size", angle_bin_num))
        self.code_size = 6 + 2 * self.bin_size
        self.bin_inter = 2 * np.pi / self.bin_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            ms = np.asarray(mean_size, dtype=np.float32)
            if ms.min() <= 0:
                raise ValueError("mean_size entries must be positive")
            self.mean_size = torch.from_numpy(ms)

    def _anchor_sizes(self, classes):
        """(...,) classes in 1..C -> (..., 3) float32 mean sizes (float32
        as in the JAX coder); out-of-range classes clamp to the ends."""
        mean_size = self.mean_size.to(classes.device)
        idx = (classes.long() - 1).clamp(0, mean_size.shape[0] - 1)
        return mean_size[idx]

    def encode(self, gt_boxes, points, gt_classes=None):
        """(..., 7+) gt boxes x (..., 3) points -> (..., 8) codes
        ``[xt, yt, zt, dxt, dyt, dzt, bin_id, bin_res]`` (reference
        ``encode_torch``, :236-278).  Extents clamp to 1e-5 and headings
        to (-pi, pi) by 1e-5, so padded rows stay finite."""
        sizes = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        xyz_g = gt_boxes[..., 0:3]
        rg = torch.clamp(gt_boxes[..., 6], -np.pi + 1e-5, np.pi - 1e-5)
        if self.use_mean_size:
            anchor = self._anchor_sizes(gt_classes)
            diagonal = torch.sqrt(anchor[..., 0] ** 2 + anchor[..., 1] ** 2)
            xt = (xyz_g[..., 0] - points[..., 0]) / diagonal
            yt = (xyz_g[..., 1] - points[..., 1]) / diagonal
            zt = (xyz_g[..., 2] - points[..., 2]) / anchor[..., 2]
            dt = torch.log(sizes / anchor)
        else:
            xt = xyz_g[..., 0] - points[..., 0]
            yt = xyz_g[..., 1] - points[..., 1]
            zt = xyz_g[..., 2] - points[..., 2]
            dt = torch.log(sizes)
        bin_id = torch.floor((rg + np.pi) / self.bin_inter)
        bin_res = ((rg + np.pi) - (bin_id * self.bin_inter + self.bin_inter / 2)) \
            / (self.bin_inter / 2)
        return torch.cat([torch.stack([xt, yt, zt], dim=-1), dt,
                          bin_id[..., None], bin_res[..., None]], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """(..., 30) encodings x (..., 3) points -> (..., 7) boxes
        (reference ``decode_torch``, :280-319)."""
        xt, yt, zt = (box_encodings[..., i] for i in range(3))
        dt = box_encodings[..., 3:6]
        if self.use_mean_size:
            anchor = self._anchor_sizes(pred_classes)
            diagonal = torch.sqrt(anchor[..., 0] ** 2 + anchor[..., 1] ** 2)
            xg = xt * diagonal + points[..., 0]
            yg = yt * diagonal + points[..., 1]
            zg = zt * anchor[..., 2] + points[..., 2]
            dg = torch.exp(dt) * anchor
        else:
            xg = xt + points[..., 0]
            yg = yt + points[..., 1]
            zg = zt + points[..., 2]
            dg = torch.exp(dt)
        bin_logits = box_encodings[..., 6:6 + self.bin_size]
        bin_res_all = box_encodings[..., 6 + self.bin_size:]
        bin_id = torch.argmax(bin_logits, dim=-1)
        bin_res = torch.gather(bin_res_all, -1, bin_id[..., None])[..., 0]
        rg = (bin_id.float() * self.bin_inter - np.pi + self.bin_inter / 2
              + bin_res * (self.bin_inter / 2))
        return torch.cat([torch.stack([xg, yg, zg], dim=-1), dg, rg[..., None]],
                         dim=-1)


def build_box_coder(name, config):
    if name != "PointResidual_BinOri_Coder":
        raise NotImplementedError(
            f"box coder {name} comes with the rest of the zoo (ROADMAP queue 1 item 9)")
    return PointResidual_BinOri_Coder(**config)

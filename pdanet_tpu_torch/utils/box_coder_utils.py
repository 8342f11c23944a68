"""Box coders: encode (training targets) and decode.

Counterparts of ``pdanet_tpu/utils/box_coder_utils.py``:
``PointResidual_BinOri_Coder`` (:21-110, the point head's: xyz/size
residuals against per-class mean sizes plus a binned orientation with an
in-bin residual), ``PointResidualCoder`` (:112-170, Part-A2-free's point
head: the same residuals with the heading's cos and sin) and
``ResidualCoder`` (:172-237, the anchor head's).
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


class PointResidualCoder:
    """The 8-code point residual coder with a cos / sin heading (reference
    :144-221): xy residuals over the class's mean-size BEV diagonal, z over
    its height, log size ratios (``use_mean_size``), or the plain
    residuals and log sizes."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            self.mean_size = torch.from_numpy(np.asarray(mean_size, dtype=np.float32))

    def _anchor_sizes(self, classes):
        """(...,) classes in 1..C -> (..., 3) float32 mean sizes, an
        out-of-range class clamped to the ends."""
        mean_size = self.mean_size.to(classes.device)
        return mean_size[(classes.long() - 1).clamp(0, mean_size.shape[0] - 1)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """(..., 7+) gt boxes x (..., 3) points -> (..., 8) codes
        ``[xt, yt, zt, dxt, dyt, dzt, cos, sin]``; extents clamp to 1e-5."""
        sizes = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        rg = gt_boxes[..., 6]
        if self.use_mean_size:
            anchor = self._anchor_sizes(gt_classes)
            diagonal = torch.sqrt(anchor[..., 0] ** 2 + anchor[..., 1] ** 2)
            xt = (gt_boxes[..., 0] - points[..., 0]) / diagonal
            yt = (gt_boxes[..., 1] - points[..., 1]) / diagonal
            zt = (gt_boxes[..., 2] - points[..., 2]) / anchor[..., 2]
            dt = torch.log(sizes / anchor)
        else:
            xt = gt_boxes[..., 0] - points[..., 0]
            yt = gt_boxes[..., 1] - points[..., 1]
            zt = gt_boxes[..., 2] - points[..., 2]
            dt = torch.log(sizes)
        return torch.cat([torch.stack([xt, yt, zt], dim=-1), dt, torch.cos(rg)[..., None],
                          torch.sin(rg)[..., None]], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """(..., 8) encodings x (..., 3) points -> (..., 7) boxes, the
        heading ``atan2(sin, cos)``."""
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
        rg = torch.atan2(box_encodings[..., 7], box_encodings[..., 6])
        return torch.cat([torch.stack([xg, yg, zg], dim=-1), dg, rg[..., None]], dim=-1)


class ResidualCoder:
    """Anchor-based 7-dim residual coder (reference :5-76): xy residuals
    normalized by the anchor BEV diagonal, log size ratios, the raw angle
    residual (the anchor-head loss applies the sin difference)."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """(..., 7+) gt boxes x (..., 7+) anchors -> (..., code_size)."""
        anchors_d = torch.clamp(anchors[..., 3:6], min=1e-5)
        boxes_d = torch.clamp(boxes[..., 3:6], min=1e-5)
        diagonal = torch.sqrt(anchors_d[..., 0] ** 2 + anchors_d[..., 1] ** 2)
        xt = (boxes[..., 0] - anchors[..., 0]) / diagonal
        yt = (boxes[..., 1] - anchors[..., 1]) / diagonal
        zt = (boxes[..., 2] - anchors[..., 2]) / anchors_d[..., 2]
        dt = torch.log(boxes_d / anchors_d)
        if self.encode_angle_by_sincos:
            tail = [torch.cos(boxes[..., 6]) - torch.cos(anchors[..., 6]),
                    torch.sin(boxes[..., 6]) - torch.sin(anchors[..., 6])]
        else:
            tail = [boxes[..., 6] - anchors[..., 6]]
        extras = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.cat([torch.stack([xt, yt, zt], -1), dt, torch.stack(tail, -1)]
                         + ([torch.stack(extras, -1)] if extras else []), dim=-1)

    def decode(self, encodings, anchors):
        anchors_d = anchors[..., 3:6]
        diagonal = torch.sqrt(anchors_d[..., 0] ** 2 + anchors_d[..., 1] ** 2)
        xg = encodings[..., 0] * diagonal + anchors[..., 0]
        yg = encodings[..., 1] * diagonal + anchors[..., 1]
        zg = encodings[..., 2] * anchors_d[..., 2] + anchors[..., 2]
        dg = torch.exp(encodings[..., 3:6]) * anchors_d
        if self.encode_angle_by_sincos:
            rg = torch.atan2(encodings[..., 7] + torch.sin(anchors[..., 6]),
                             encodings[..., 6] + torch.cos(anchors[..., 6]))
            rest = 8
        else:
            rg = encodings[..., 6] + anchors[..., 6]
            rest = 7
        extras = [encodings[..., rest + i] + anchors[..., 7 + i]
                  for i in range(anchors.shape[-1] - 7)]
        return torch.cat([torch.stack([xg, yg, zg], -1), dg, rg[..., None]]
                         + ([torch.stack(extras, -1)] if extras else []), dim=-1)


BOX_CODERS = {"PointResidual_BinOri_Coder": PointResidual_BinOri_Coder,
              "PointResidualCoder": PointResidualCoder, "ResidualCoder": ResidualCoder}


def build_box_coder(name, config):
    if name not in BOX_CODERS:
        raise KeyError(f"box coder {name}: the JAX package has {', '.join(BOX_CODERS)}")
    return BOX_CODERS[name](**config)

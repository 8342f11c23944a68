"""Box coder, decode only.

Counterpart of ``pdanet_tpu/utils/box_coder_utils.py:21-110``
(``PointResidual_BinOri_Coder``): xyz/size residuals against per-class
mean sizes plus a binned orientation with an in-bin residual.  ``encode``
comes with training (ROADMAP queue 1 item 6).
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

    def decode(self, box_encodings, points, pred_classes=None):
        """(..., 30) encodings x (..., 3) points -> (..., 7) boxes
        (reference ``decode_torch``, :280-319)."""
        xt, yt, zt = (box_encodings[..., i] for i in range(3))
        dt = box_encodings[..., 3:6]
        if self.use_mean_size:
            mean_size = self.mean_size.to(box_encodings.device)
            idx = (pred_classes.long() - 1).clamp(0, mean_size.shape[0] - 1)
            anchor = mean_size[idx]
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

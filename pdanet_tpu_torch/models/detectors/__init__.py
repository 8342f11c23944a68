"""Detector registry (``pdanet_tpu/models/detectors/__init__.py:74-97``).

Only IASSD (PDA-SSD) is ported; the other detectors of the zoo are ROADMAP
queue 1 item 9.
"""

import torch

from .iassd import IASSD, post_processing

__all__ = {"IASSD": IASSD}


def get_post_processor(name):
    """fn(forward_out, model_cfg) -> fixed-shape pred dict."""
    if name != "IASSD":
        raise NotImplementedError(f"{name} is ROADMAP queue 1 item 9")
    return lambda out, mcfg: post_processing(
        out["batch_cls_preds"], out["batch_box_preds"], mcfg.POST_PROCESSING)


def build_network(model_cfg, num_class, input_channels=4, device=None):
    """Build the detector named by ``model_cfg.NAME`` on ``device``: the
    current CUDA device unless the caller names one (``device="cpu"``)."""
    if model_cfg.NAME not in __all__:
        raise NotImplementedError(f"{model_cfg.NAME} is ROADMAP queue 1 item 9")
    device = torch.device("cuda") if device is None else torch.device(device)
    return __all__[model_cfg.NAME](model_cfg, num_class, input_channels).to(device)

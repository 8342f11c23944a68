"""Weight bridge: the JAX package's variables into the port's state_dict.

``load_jax_variables(model, variables)`` takes ``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays (``jax.device_get``
of a flax variable tree; no jax is needed here) and fills the model.  The
port's attribute names are the flax module names, so a flax path
``backbone_3d/SA_modules_1/Local_pointformer_0/self_attn/query/kernel``
becomes the key ``backbone_3d.SA_modules_1.Local_pointformer_0.self_attn.
query.weight``:

=================================  =====================================
flax                               port
=================================  =====================================
Dense ``kernel`` (in, out)         ``weight`` (out, in)
attention q/k/v ``kernel`` (D, H,  ``weight``: reshaped to (D, H*hd),
hd), ``bias`` (H, hd)              transposed; ``bias`` (H*hd,)
attention ``out`` ``kernel`` (H,   ``weight``: reshaped to (H*hd, D),
hd, D)                             transposed
BatchNorm / LayerNorm ``scale``    ``weight``
BatchNorm ``mean`` / ``var``       ``running_mean`` / ``running_var``
=================================  =====================================

Every flax leaf must land on a port tensor and every port parameter and
persistent buffer must be filled; anything left over on either side raises.
"""

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for name, value in tree.items():
        path = prefix + (str(name),)
        if hasattr(value, "items"):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value, dtype=np.float32)


def _convert_param(path, arr):
    *mods, leaf = path
    if leaf == "scale":
        return mods, "weight", arr
    if leaf == "bias":
        return mods, "bias", arr.reshape(-1)
    if leaf != "kernel":
        raise KeyError(f"unknown flax parameter {'/'.join(path)}")
    if arr.ndim == 3 and mods[-1] == "out":  # (H, hd, D)
        arr = arr.reshape(-1, arr.shape[-1])
    elif arr.ndim == 3:  # query/key/value (D, H, hd)
        arr = arr.reshape(arr.shape[0], -1)
    elif arr.ndim != 2:
        raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    return mods, "weight", arr.T


def load_jax_variables(model, variables):
    """Fill ``model`` from a flax variable tree of numpy arrays."""
    state = model.state_dict()
    filled = {}

    def put(mods, name, arr, path):
        key = ".".join(list(mods) + [name])
        if key not in state:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port tensor {key}")
        if key in filled:
            raise KeyError(f"port tensor {key} filled twice")
        if tuple(state[key].shape) != arr.shape:
            raise ValueError(
                f"{key}: port shape {tuple(state[key].shape)} != flax {arr.shape}")
        filled[key] = torch.tensor(arr)

    for path, arr in _leaves(variables.get("params", {})):
        put(*_convert_param(path, arr), path)
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mods, leaf = path
        if leaf not in _STAT_NAMES:
            raise KeyError(f"unknown flax batch statistic {'/'.join(path)}")
        put(mods, _STAT_NAMES[leaf], arr, path)
    missing = sorted(set(state) - set(filled))
    if missing:
        raise KeyError(f"port tensors not filled by the flax tree: {missing}")
    model.load_state_dict(filled, strict=True)
    return model

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
Conv ``kernel`` (kh, kw, in, out)  ``weight`` (out, in, kh, kw)
3-D Conv ``kernel`` (kz, ky, kx,   ``weight`` (out, in, kz, ky, kx): the
in, out)                           dense ladders, the UNetV2's convs, the
                                   Part-A2 RoI head's masked convs
ConvTranspose ``kernel`` (kh, kw,  ``weight`` (in, out, kh, kw), flipped
in, out)                           in both spatial axes (flax applies it
                                   unflipped, ``conv_transpose2d``
                                   flipped)
3-D ConvTranspose ``kernel`` (kz,  ``weight`` (in, out, kz, ky, kx),
ky, kx, in, out)                   flipped in the three spatial axes (the
                                   UNetV2's ``inv_conv`` upsampling)
sparse conv ``kernel``, ``kernel1``  the same name, layout (K, C_in, C_out)
/ ``kernel2``, ``conv2_down_kernel``  kept: the port's sparse convs take
... ``conv_out_kernel``, the        flax's layout (``sparse_backbone.py``,
sparse inverse conv's ``kernel``   ``sparse_unet.py``)
VectorPool                         the same name, layout (V, C_in, C_out)
``separate_local_aggregation``     kept: the per-cell einsum takes flax's
(V, C_in, C_out)                   layout (``pfe/vector_pool.py``)
BatchNorm / LayerNorm ``scale``    ``weight``
BatchNorm ``mean`` / ``var``       ``running_mean`` / ``running_var``
=================================  =====================================

Every flax leaf must land on a port tensor and every port parameter and
persistent buffer must be filled; anything left over on either side raises.
The arrays keep their float dtype (a float64 tree fills a model made
``.double()`` without rounding through float32).

``load_jax_checkpoint(path)`` reads a checkpoint file the JAX package
wrote (``pdanet_tpu/train/train_utils.py:147-214``) without jax and returns
its ``{"params", "batch_stats"}`` for ``load_jax_variables``.

``load_jax_optimizer_state(optimizer, model, mu, nu, count)`` carries the
Adam moments of an optax state, given as numpy trees shaped like
``params``, and its update count into the port's ``AdamOneCycle``, by the
same key mapping and reshapes, so a JAX run can resume in the port.
"""

import io
import pickle
import zlib

import numpy as np
import torch

from ..models.blocks import ConvTranspose, ConvTranspose3d

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
JAX_CKPT_MARKER = "__pdanet_ckpt_format__"
# what a checkpoint's model state is made of: containers and numpy arrays
_SAFE_GLOBALS = {
    ("builtins", name) for name in ("dict", "list", "tuple", "set", "frozenset", "int",
                                    "float", "complex", "str", "bytes", "bytearray", "bool")
} | {("collections", "OrderedDict")} | {
    (mod, name) for mod in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                            "numpy.core.numeric", "numpy._core.numeric")
    for name in ("ndarray", "dtype", "_reconstruct", "scalar", "_frombuffer")
}


class _Inert:
    """Stands in for a class the unpickler will not import (optax's state
    classes, which the optimizer state pickles): takes any constructor
    arguments and state and does nothing with them."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    """Imports builtins containers and numpy arrays only; every other class
    becomes :class:`_Inert`, so unpickling runs no code of the file's
    choosing."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        return type(name, (_Inert,), {"__module__": "pdanet_tpu_torch.inert." + module})


def _unpickle(data, path):
    try:
        return _CheckpointUnpickler(io.BytesIO(data)).load()
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError, AttributeError) as e:
        raise ValueError(f"{path} is not a checkpoint of the JAX package: {e}") from e


def load_jax_checkpoint(path):
    """``{"params", "batch_stats"}`` (nested dicts of numpy arrays) of the
    JAX package's checkpoint file ``path``: its format-2 wrapper
    (``__pdanet_ckpt_format__``, a CRC-32, the pickled payload) or a
    format-1 bare pickled dict.  Raises ``ValueError`` if the file is not
    such a checkpoint or its checksum does not match."""
    with open(path, "rb") as f:
        obj = _unpickle(f.read(), path)
    if isinstance(obj, dict) and JAX_CKPT_MARKER in obj:
        payload = obj.get("payload")
        if not isinstance(payload, bytes) or zlib.crc32(payload) != obj.get("crc32"):
            raise ValueError(f"checksum mismatch in {path}")
        obj = _unpickle(payload, path)
    state = obj.get("model_state") if isinstance(obj, dict) else None
    if not isinstance(state, dict) or not isinstance(state.get("params"), dict):
        raise ValueError(f"{path} holds no model state of the JAX package")
    return {"params": state["params"], "batch_stats": state.get("batch_stats", {})}



def _leaves(tree, prefix=()):
    for name, value in tree.items():
        path = prefix + (str(name),)
        if hasattr(value, "items"):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _layouts(model):
    """What the conversion needs to know of ``model``: the dotted names of
    its transposed convolutions, and of its parameters named after their
    flax leaf (the sparse conv kernels), which keep flax's layout."""
    transposed = {name for name, mod in model.named_modules()
                  if isinstance(mod, (ConvTranspose, ConvTranspose3d))}
    kept = {name for name, _ in model.named_parameters()
            if not name.endswith((".weight", ".bias"))}
    return transposed, kept


def _convert_param(path, arr, layouts):
    transposed, kept = layouts
    *mods, leaf = path
    if leaf == "scale":
        return mods, "weight", arr
    if leaf == "bias":
        return mods, "bias", arr.reshape(-1)
    if ".".join(path) in kept:
        return mods, leaf, arr
    if leaf != "kernel":
        raise KeyError(f"unknown flax parameter {'/'.join(path)}")
    if arr.ndim == 4 and ".".join(mods) in transposed:  # (kh, kw, in, out)
        return mods, "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1).copy()
    if arr.ndim == 4:
        return mods, "weight", arr.transpose(3, 2, 0, 1).copy()
    if arr.ndim == 5 and ".".join(mods) in transposed:  # (kz, ky, kx, in, out)
        return mods, "weight", arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2).copy()
    if arr.ndim == 5:  # 3-D Conv (kz, ky, kx, in, out)
        return mods, "weight", arr.transpose(4, 3, 0, 1, 2).copy()
    if arr.ndim == 3 and mods[-1] == "out":  # (H, hd, D)
        arr = arr.reshape(-1, arr.shape[-1])
    elif arr.ndim == 3:  # query/key/value (D, H, hd)
        arr = arr.reshape(arr.shape[0], -1)
    elif arr.ndim != 2:
        raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    return mods, "weight", arr.T


def _port_param(path, arr, layouts):
    mods, name, arr = _convert_param(path, arr, layouts)
    return ".".join(list(mods) + [name]), arr


def load_jax_variables(model, variables):
    """Fill ``model`` from a flax variable tree of numpy arrays."""
    state = model.state_dict()
    layouts = _layouts(model)
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
        put(*_convert_param(path, arr, layouts), path)
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


def load_jax_optimizer_state(optimizer, model, mu, nu, count):
    """Fill ``optimizer``'s per-parameter moments from optax Adam's ``mu``
    and ``nu`` (numpy trees shaped like the flax params) and set its
    update count to ``count``.  Every parameter of ``model`` must get both
    moments; a leaf with no port parameter raises."""
    params = dict(model.named_parameters())
    layouts = _layouts(model)
    moments = {}
    for which, tree in (("mu", mu), ("nu", nu)):
        for path, arr in _leaves(tree):
            key, arr = _port_param(path, arr, layouts)
            if key not in params:
                raise KeyError(f"optax leaf {'/'.join(path)} has no port parameter {key}")
            p = params[key]
            if tuple(p.shape) != arr.shape:
                raise ValueError(f"{key}: port shape {tuple(p.shape)} != optax {arr.shape}")
            moments.setdefault(key, {})[which] = torch.tensor(
                arr, dtype=p.dtype, device=p.device)
    missing = sorted(k for k in params if len(moments.get(k, ())) != 2)
    if missing:
        raise KeyError(f"port parameters without both Adam moments: {missing}")
    for key, state in moments.items():
        optimizer.state[params[key]] = state
    for group in optimizer.param_groups:
        group["count"] = int(count)
    return optimizer

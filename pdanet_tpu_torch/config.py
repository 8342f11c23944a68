"""YAML config loading with ``_BASE_CONFIG_`` inheritance and CLI overrides.

A copy of ``pdanet_tpu/config.py`` (itself the reference loader,
``pcdet/config.py:7-68``) without its module-level ``cfg``:

* ``cfg_from_yaml_file`` reads a YAML into an EasyDict, recursively merging
  any ``_BASE_CONFIG_`` file first;
* ``cfg_from_list`` applies the CLIs' dotted-path ``--set A.B.C value``
  overrides with literal-eval type coercion;
* ``log_config_to_file`` writes the config to a logger.
"""

import ast
from pathlib import Path

import yaml

from .utils.easydict import EasyDict


def log_config_to_file(cfg_node, pre="cfg", logger=None):
    for key, val in cfg_node.items():
        if isinstance(val, EasyDict):
            logger.info("----------- %s -----------" % key)
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
            continue
        logger.info("%s.%s: %s" % (pre, key, val))


def _resolve_base_config(base_path, cfg_dir):
    """Resolve a ``_BASE_CONFIG_`` reference.

    The reference resolves it against the CWD (the CLIs run from tools/,
    pcdet/config.py:52); additionally try relative to the including file
    and its ancestors so configs load from any working directory.
    """
    candidates = [Path(base_path)]
    if cfg_dir is not None:
        d = Path(cfg_dir)
        for up in [d, d.parent, d.parent.parent, d.parent.parent.parent]:
            candidates.append(up / base_path)
    for cand in candidates:
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"_BASE_CONFIG_ {base_path!r} not found (tried {[str(c) for c in candidates]})"
    )


def merge_new_config(config, new_config, cfg_dir=None):
    if "_BASE_CONFIG_" in new_config:
        base = _resolve_base_config(new_config["_BASE_CONFIG_"], cfg_dir)
        with open(base, "r") as f:
            yaml_config = yaml.safe_load(f)
        config.update(EasyDict(yaml_config))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config:
            config[key] = EasyDict()
        merge_new_config(config[key], val, cfg_dir=cfg_dir)

    return config


def cfg_from_yaml_file(cfg_file, config=None):
    """Load ``cfg_file`` into ``config`` (a new EasyDict if None)."""
    config = EasyDict() if config is None else config
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    return merge_new_config(
        config=config, new_config=new_config,
        cfg_dir=Path(cfg_file).resolve().parent,
    )


def cfg_from_list(cfg_list, config):
    """Set config keys via list, e.g. ``--set MODEL.NAME IASSD``."""
    if len(cfg_list) % 2:
        raise ValueError(f"--set takes key value pairs, got {cfg_list}")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        *parents, subkey = k.split(".")
        d = config
        for name in parents:
            if name not in d:
                raise KeyError("NotFoundKey: %s" % name)
            d = d[name]
        if subkey not in d:
            raise KeyError("NotFoundKey: %s" % subkey)
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if isinstance(value, dict):
            # partial dict override, matching reference key-wise merge
            for key1 in value:
                d[subkey][key1] = value[key1]
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], EasyDict):
            key_val_list = v.split(",")
            for src in key_val_list:
                cur_key, cur_val = src.split(":")
                val_type = type(d[subkey][cur_key])
                d[subkey][cur_key] = val_type(cur_val)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            val_list = v.split(",")
            for i, x in enumerate(val_list):
                val_list[i] = type(d[subkey][0])(x)
            d[subkey] = val_list
        else:
            d[subkey] = value
    return config

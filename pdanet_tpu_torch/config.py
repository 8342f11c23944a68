"""YAML config loading with ``_BASE_CONFIG_`` inheritance.

A copy of ``pdanet_tpu/config.py`` (itself the reference loader,
``pcdet/config.py:51-68``) without its CLI overrides: ``cfg_from_yaml_file``
reads a YAML into an EasyDict, recursively merging any ``_BASE_CONFIG_``
file first.
"""

from pathlib import Path

import yaml

from .utils.easydict import EasyDict


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

"""Host-side common utilities.

A copy of ``pdanet_tpu/utils/common_utils.py``: its numpy part
(``limit_period``, ``rotate_points_along_z_np``, ``drop_info_with_name``,
``keep_arrays_by_name``, ``create_logger``, ``set_random_seed``), its
multi-process evaluation merge (``interleave_parts``,
``merge_results_dist``) and, in place of ``init_dist_jax``,
``init_dist``, which joins a ``torch.distributed`` process group from a
launcher's environment (the reference's ``init_dist_pytorch`` /
``init_dist_slurm``).
"""

import contextlib
import logging
import os
import pickle
import random
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)
    (common_utils.py:73-80)."""
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z_np(points, angle):
    """Rotate (B, N, 3 + C) points about z by (B,) radians."""
    cosa = np.cos(angle)
    sina = np.sin(angle)
    zeros = np.zeros_like(angle)
    ones = np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    xyz = np.matmul(points[:, :, 0:3], rot)
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)


def drop_info_with_name(info, name):
    """Filter annotation rows whose name == ``name`` (common_utils.py:59-66)."""
    ret = {}
    keep = [i for i, x in enumerate(info["name"]) if x != name]
    for key in info.keys():
        if key == "gt_boxes_lidar" or isinstance(info[key], np.ndarray):
            ret[key] = info[key][keep] if len(info[key]) == len(info["name"]) else info[key]
        else:
            ret[key] = info[key]
    return ret


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Rank-0 console+file logger (common_utils.py:85-99)."""
    logger = logging.getLogger(__name__ + str(random.random()))
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def first_host(nodelist):
    """The first host of a Slurm node list (``node[01-04],gpu7`` ->
    ``node01``), what ``scontrol show hostname <list> | head -n1`` prints."""
    m = re.match(r"([^,\[]+)(?:\[([^,\]-]+))?", nodelist)
    if m is None:
        raise RuntimeError(f"cannot read the Slurm node list {nodelist!r}")
    return m.group(1) + (m.group(2) or "")


def _launch_env(launcher, tcp_port):
    """(rank, world, local rank, address, port) of this process."""
    env = os.environ
    if launcher == "pytorch":
        # A forgotten RANK must be a loud error, not a silent rank-0
        # default: every process claiming rank 0 hangs the rendezvous.
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in env]
        if missing:
            raise RuntimeError(
                f"--launcher pytorch needs {' and '.join(missing)} in the environment; "
                f"start each process with torchrun (pdanet_tpu_torch/tools/scripts/"
                f"dist_train.sh), which exports RANK, WORLD_SIZE, LOCAL_RANK, "
                f"MASTER_ADDR and MASTER_PORT")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT", str(tcp_port))
        if ":" in addr:  # MASTER_ADDR may carry its own port
            addr, port = addr.rsplit(":", 1)
    elif launcher == "slurm":
        missing = [k for k in ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
                               "SLURM_NODELIST") if k not in env]
        if missing:
            raise RuntimeError(f"--launcher slurm needs {', '.join(missing)} in the "
                               f"environment: run each process under srun")
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local_rank = int(env["SLURM_LOCALID"])
        addr, port = first_host(env["SLURM_NODELIST"]), env.get("MASTER_PORT", str(tcp_port))
    else:
        raise ValueError(f"unknown launcher {launcher!r}: pytorch or slurm")
    if not 0 <= rank < world:
        raise RuntimeError(f"rank {rank} out of range for world size {world}")
    return rank, world, local_rank, addr, int(port)


def init_dist(launcher, tcp_port=18888, backend=None):
    """Join the process group of a multi-process launch
    (``init_dist_jax``, reference common_utils.py:134-176) and return
    ``(rank, world)``.

    ``pytorch`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
    / ``MASTER_ADDR`` (which may carry ``:port``) / ``MASTER_PORT`` and
    raises when ``RANK`` is missing; ``slurm`` reads ``SLURM_PROCID`` /
    ``SLURM_NTASKS`` / ``SLURM_LOCALID`` and the first host of
    ``SLURM_NODELIST``, the port from ``MASTER_PORT`` or ``tcp_port``.
    ``backend`` defaults to ``nccl`` where CUDA is available, else
    ``gloo``.  Under NCCL the process takes GPU ``LOCAL_RANK`` as its
    current device, and the group is bound to it (``device_id``), so that
    its barriers know their device."""
    rank, world, local_rank, addr, port = _launch_env(launcher, tcp_port)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                            rank=rank, **kwargs)
    return rank, world


@contextlib.contextmanager
def launched(launcher, tcp_port, device):
    """A CLI's process under ``launcher``: yields ``(rank, world,
    device)``.  ``none`` yields ``(0, 1, device)``; otherwise the process
    joins the group (:func:`init_dist`, NCCL for a CUDA ``device``, Gloo
    for the CPU), a CUDA device becomes the process's own GPU, and the
    group is left on exit."""
    if launcher == "none":
        yield 0, 1, device
        return
    rank, world = init_dist(launcher, tcp_port,
                            backend="nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        yield rank, world, device
    finally:
        dist.destroy_process_group()


def interleave_parts(part_list, size):
    """Restore dataset order from stride-sharded per-rank result lists
    (rank r holds samples r, r+world, r+2*world, ...) -- the inverse of
    SimpleLoader's pad+stride shard and of the reference's eval
    DistributedSampler (datasets/__init__.py:24-44).  Trailing pad
    duplicates are dropped by the ``size`` cut."""
    ordered = []
    for res in zip(*part_list):
        ordered.extend(list(res))
    return ordered[:size]


def merge_results_dist(result_part, size, tmpdir, rank=None, world=None, barrier=None):
    """Multi-process eval merge via pickle files on a shared file system
    (common_utils.py:201-222).  Returns the merged list on rank 0 and None
    on the others.  ``rank`` / ``world`` / ``barrier`` default to the
    process group's and exist so that tests can simulate a merge."""
    if rank is None or world is None:
        rank, world = dist.get_rank(), dist.get_world_size()
    if barrier is None:
        barrier = dist.barrier

    os.makedirs(tmpdir, exist_ok=True)
    with open(os.path.join(tmpdir, f"result_part_{rank}.pkl"), "wb") as f:
        pickle.dump(result_part, f)
    if world > 1:
        barrier()
    if rank != 0:
        return None
    part_list = []
    for i in range(world):
        with open(os.path.join(tmpdir, f"result_part_{i}.pkl"), "rb") as f:
            part_list.append(pickle.load(f))
    ordered = interleave_parts(part_list, size)
    shutil.rmtree(tmpdir)
    return ordered

"""Test CLI: ``python -m pdanet_tpu_torch.tools.test --cfg_file <yaml>
--ckpt <file>``, or ``--eval_all`` to watch a checkpoint directory.

Counterpart of the JAX package's ``tools/test.py`` (reference
``tools/test.py:24-208``): ``eval_one_epoch`` with the dataset's official
evaluation over the test split, its results under
``output/<exp_group>/<tag>/<extra_tag>/eval/``.  ``--ckpt`` takes the
port's checkpoint or the JAX package's ``.pkl`` (a pickle carrying the
``__pdanet_ckpt_format__`` marker, read without jax).  ``--eval_all``
evaluates every ``checkpoint_epoch_<n>.pth`` of ``--ckpt_dir`` not yet
listed in ``eval_list_<split>.txt``, polling every 30 s until none is new
for ``--max_waiting_mins``.  The test split's point sampling is seeded
(``np.random.seed(1024)``, reference test.py:47).

It runs on CUDA unless ``--device cpu``.  ``--launcher pytorch``
(torchrun: ``pdanet_tpu_torch/tools/scripts/dist_test.sh``) or
``slurm`` evaluates on several processes, one per GPU: each takes its
shard of the frames, the predictions are merged into dataset order and
rank 0 alone evaluates and writes the results; under ``--eval_all`` rank
0 alone picks the next checkpoint and broadcasts its choice.
"""

import argparse
import collections
import datetime
import glob
import json
import os
import re
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..config import cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..eval import eval_one_epoch
from ..models import build_network
from ..ops import cuda_lib
from ..train import load_model_state
from ..utils import common_utils

POLL_SECONDS = 30


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="arg parser")
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames a process (a GPU) takes a batch")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="the port's checkpoint or the JAX package's .pkl")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="multi-process evaluation: 'pytorch' under torchrun, 'slurm' "
                             "under srun, one process per GPU")
    parser.add_argument("--tcp_port", type=int, default=18888,
                        help="rendezvous port where the launcher's environment names none")
    parser.add_argument("--local_rank", type=int, default=0,
                        help="accepted for reference-script compatibility (torchrun's "
                             "LOCAL_RANK is read)")
    parser.add_argument("--eval_tag", type=str, default="default")
    parser.add_argument("--eval_all", action="store_true", default=False)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--save_to_file", action="store_true", default=False)
    parser.add_argument("--infer_time", action="store_true", default=False)
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on (cuda unless told)")
    args = parser.parse_args(argv)

    cfg = cfg_from_yaml_file(args.cfg_file)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(args.cfg_file.split("/")[1:-1])
    np.random.seed(1024)  # the test split's point sampling (reference test.py:47)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def eval_single_ckpt(cfg, args, model, test_loader, eval_output_dir, logger, epoch_id,
                     ckpt_path, device):
    load_model_state(model, ckpt_path)
    return eval_one_epoch(cfg, model, test_loader, epoch_id, logger,
                          result_dir=eval_output_dir, save_to_file=args.save_to_file,
                          infer_time=args.infer_time, device=device,
                          dist_test=parallel.is_dist())


def get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args):
    ckpt_list = sorted(glob.glob(os.path.join(ckpt_dir, "*checkpoint_epoch_*.pth")))
    evaluated = [float(x.strip()) for x in open(ckpt_record_file, "r").readlines()]
    for cur_ckpt in ckpt_list:
        num_list = re.findall(r"checkpoint_epoch_(.*)\.pth", cur_ckpt)
        if not num_list:
            continue
        epoch_id = num_list[-1]
        if float(epoch_id) not in evaluated and int(float(epoch_id)) >= args.start_epoch:
            return epoch_id, cur_ckpt
    return -1, None


def next_ckpt(ckpt_dir, ckpt_record_file, args):
    """:func:`get_no_evaluated_ckpt` of rank 0, broadcast to every rank: a
    barrier alone cannot make the trainer's checkpoint writes and the
    record file equally visible on a shared file system, and ranks that
    glob on their own may take different branches, one entering the
    merge's barrier while another polls again, and hang (JAX
    ``tools/test.py:151-178``)."""
    if not parallel.is_dist():
        return get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args)
    choice = [get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args)
              if parallel.rank() == 0 else None]
    dist.broadcast_object_list(choice, src=0)
    return choice[0]


def main(argv=None):
    """Evaluate one checkpoint (returns its result dict, ``{}`` on ranks
    other than 0) or watch a checkpoint directory (``--eval_all``; returns
    None)."""
    args, cfg = parse_config(argv)
    with common_utils.launched(args.launcher, args.tcp_port,
                               torch.device(args.device)) as (rank, world, device):
        return _test(args, cfg, device, rank, world)


def _test(args, cfg, device, rank, world):
    output_dir = Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    eval_output_dir = output_dir / "eval"
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU

    if not args.eval_all:
        num_list = re.findall(r"\d+", args.ckpt) if args.ckpt is not None else []
        epoch_id = num_list[-1] if num_list else "no_number"
        eval_output_dir = (eval_output_dir / ("epoch_%s" % epoch_id)
                           / cfg.DATA_CONFIG.DATA_SPLIT["test"])
    else:
        eval_output_dir = eval_output_dir / "eval_all_default"
    if args.eval_tag is not None:
        eval_output_dir = eval_output_dir / args.eval_tag
    eval_output_dir.mkdir(parents=True, exist_ok=True)
    log_file = eval_output_dir / (
        "log_eval_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = common_utils.create_logger(log_file if rank == 0 else None, rank=rank)
    launches_before = collections.Counter(cuda_lib.launches)
    try:
        logger.info("**********************Start logging**********************")
        logger.info(f"device {device}, world {world}, batch size {batch_size} a process")
        if parallel.is_dist():
            logger.info(f"process group: backend {dist.get_backend()}, world {world}")
        test_set, test_loader, _ = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
            training=False, logger=logger, workers=args.workers, rank=rank, world=world)
        model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=test_set,
                              device=device)
        if not args.eval_all:
            result = eval_single_ckpt(cfg, args, model, test_loader, eval_output_dir, logger,
                                      epoch_id, args.ckpt, device)
            logger.info("kernel launches of this process: %s" % json.dumps(dict(
                cuda_lib.launches - launches_before)))
            return result

        # the watcher (reference test.py:90-136)
        ckpt_dir = args.ckpt_dir if args.ckpt_dir is not None else output_dir / "ckpt"
        ckpt_record_file = eval_output_dir / (
            "eval_list_%s.txt" % cfg.DATA_CONFIG.DATA_SPLIT["test"])
        if rank == 0:
            with open(ckpt_record_file, "a"):
                pass
        total_time = 0
        first_eval = True
        while True:
            cur_epoch_id, cur_ckpt = next_ckpt(str(ckpt_dir), ckpt_record_file, args)
            if cur_epoch_id == -1 or int(float(cur_epoch_id)) < args.start_epoch:
                if total_time > args.max_waiting_mins * 60 and not first_eval:
                    break
                time.sleep(POLL_SECONDS)
                total_time += POLL_SECONDS
                continue
            total_time = 0
            first_eval = False
            cur_result_dir = (eval_output_dir.parent / ("epoch_%s" % cur_epoch_id)
                              / cfg.DATA_CONFIG.DATA_SPLIT["test"])
            eval_single_ckpt(cfg, args, model, test_loader, cur_result_dir, logger,
                             cur_epoch_id, cur_ckpt, device)
            if rank == 0:
                with open(ckpt_record_file, "a") as f:
                    print("%s" % cur_epoch_id, file=f)
            logger.info("Epoch %s has been evaluated" % cur_epoch_id)
        logger.info("kernel launches of this process: %s" % json.dumps(dict(
            cuda_lib.launches - launches_before)))
        return None
    finally:
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)


if __name__ == "__main__":
    main()

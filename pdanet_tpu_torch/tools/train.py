"""Train CLI: ``python -m pdanet_tpu_torch.tools.train --cfg_file <yaml>``.

Counterpart of the JAX package's ``tools/train.py`` (reference
``tools/train.py:24-213``), with the same flags and the same output layout
under the working directory, ``output/<exp_group>/<tag>/<extra_tag>/``:
``ckpt/checkpoint_epoch_<n>.pth`` (the port's CRC-checked format, the
oldest removed beyond ``--max_ckpt_save_num``), ``log_train_*.txt``,
``tensorboard/metrics.jsonl`` and, after training, the evaluation of the
last ``--num_epochs_to_eval`` checkpoints under ``eval/eval_with_train``.
Without ``--ckpt`` it resumes from the newest readable checkpoint in
``ckpt/``.  ``--pretrained_model`` takes the port's checkpoint or the JAX
package's ``.pkl``.  ``--profile`` writes a ``torch.profiler`` trace of
train steps 3-5 under ``profile/``.

It runs on CUDA unless ``--device cpu``.  ``--launcher pytorch`` (one
process per GPU under torchrun:
``pdanet_tpu_torch/tools/scripts/dist_train.sh``) or
``slurm`` trains data-parallel: each process joins the process group
(NCCL on CUDA, Gloo on the CPU), drives GPU ``LOCAL_RANK`` and loads its
shard of every global batch of world x ``--batch_size`` frames; BatchNorm
and the loss's normalizers see the global batch, the gradients are
summed over the processes, rank 0 alone logs and writes checkpoints, and
the post-train evaluation runs on every process with its results merged.
"""

import argparse
import collections
import datetime
import glob
import json
import os
import re
from pathlib import Path

import torch
import torch.distributed as dist

from .. import parallel
from ..config import cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets import build_dataloader
from ..eval import eval_one_epoch
from ..models import build_network
from ..ops import cuda_lib
from ..train import (
    build_optimizer_and_schedule,
    load_checkpoint,
    load_model_state,
    load_newest_checkpoint,
    restore_from_checkpoint,
    train_model,
)
from ..utils import common_utils
from ..utils.metrics import MetricsLogger


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="arg parser")
    parser.add_argument("--cfg_file", type=str, default=None, help="specify the config for training")
    parser.add_argument("--batch_size", type=int, default=None, required=False,
                        help="frames a process (a GPU) takes each step; the global batch is "
                             "world x batch_size (the yaml's BATCH_SIZE_PER_GPU by default)")
    parser.add_argument("--epochs", type=int, default=None, required=False, help="number of epochs to train for")
    parser.add_argument("--workers", type=int, default=4, help="number of loader threads")
    parser.add_argument("--extra_tag", type=str, default="default", help="extra tag for this experiment")
    parser.add_argument("--ckpt", type=str, default=None, help="checkpoint to start from")
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="weights to start from: the port's checkpoint or the JAX package's .pkl")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="data-parallel training: 'pytorch' under torchrun, 'slurm' "
                             "under srun, one process per GPU")
    parser.add_argument("--tcp_port", type=int, default=18888,
                        help="rendezvous port where the launcher's environment names none")
    parser.add_argument("--local_rank", type=int, default=0,
                        help="accepted for reference-script compatibility (torchrun's "
                             "LOCAL_RANK is read)")
    parser.add_argument("--sync_bn", action="store_true", default=False,
                        help="accepted for reference-script compatibility: under a launcher "
                             "BatchNorm always normalizes over the global batch (world x "
                             "--batch_size frames), as the JAX package does")
    parser.add_argument("--fix_random_seed", action="store_true", default=False)
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=8)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="set extra config keys if needed")
    parser.add_argument("--num_epochs_to_eval", type=int, default=5)
    parser.add_argument("--max_waiting_mins", type=int, default=0,
                        help="accepted for reference-script compatibility "
                             "(post-train eval reads finished checkpoints)")
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--save_to_file", action="store_true", default=False)
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true", default=False)
    parser.add_argument("--profile", action="store_true", default=False,
                        help="write a torch.profiler trace of train steps 3-5")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda unless told)")

    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(args.cfg_file.split("/")[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    """Train, then evaluate the last checkpoints; returns the output
    directory."""
    args, cfg = parse_config(argv)
    with common_utils.launched(args.launcher, args.tcp_port,
                               torch.device(args.device)) as (rank, world, device):
        return _train(args, cfg, device, rank, world)


def _train(args, cfg, device, rank, world):
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    if args.fix_random_seed:  # each rank its own augmentation stream (reference train.py)
        common_utils.set_random_seed(666 + rank)

    output_dir = Path("output") / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / (
        "log_train_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = common_utils.create_logger(log_file if rank == 0 else None, rank=rank)
    tb_log = None
    launches_before = collections.Counter(cuda_lib.launches)
    try:
        logger.info("**********************Start logging**********************")
        log_config_to_file(cfg, logger=logger)
        logger.info(f"device {device}, world {world}, batch size {batch_size} a process, "
                    f"global batch {batch_size * world}")
        if parallel.is_dist():
            logger.info(f"process group: backend {dist.get_backend()}, world {world}")
        train_set, train_loader, _ = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
            training=True, logger=logger, workers=args.workers,
            merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
            total_epochs=epochs, rank=rank, world=world)
        if len(train_loader) == 0:
            raise RuntimeError(f"dataset ({len(train_set)} frames) smaller than the global "
                               f"batch ({batch_size * world}); reduce --batch_size")
        # the initial weights are seeded, as the JAX package's PRNGKey(0)
        torch.manual_seed(0)
        model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=train_set,
                              device=device)
        optimizer, schedule = build_optimizer_and_schedule(
            model, cfg.OPTIMIZATION, len(train_loader), epochs)

        start_epoch = it = 0
        if args.ckpt is not None:
            start_epoch, it = restore_from_checkpoint(load_checkpoint(args.ckpt), model,
                                                      optimizer)
            logger.info(f"resumed from {args.ckpt} at epoch {start_epoch}")
        else:  # auto-resume from the newest checkpoint (reference train.py:140-150)
            ckpts = sorted(glob.glob(str(ckpt_dir / "checkpoint_epoch_*.pth")),
                           key=os.path.getmtime)
            ck, ck_path = load_newest_checkpoint(ckpts, logger=logger)
            if ck is not None:
                start_epoch, it = restore_from_checkpoint(ck, model, optimizer)
                logger.info(f"auto-resumed from {ck_path} at epoch {start_epoch}")
        if args.pretrained_model is not None:
            load_model_state(model, args.pretrained_model)
            logger.info(f"loaded pretrained model {args.pretrained_model}")

        tb_log = MetricsLogger(output_dir / "tensorboard") if rank == 0 else None
        profiler = None
        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(
                activities=activities,
                schedule=torch.profiler.schedule(wait=1, warmup=1, active=3, repeat=1),
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    str(output_dir / "profile")))
            profiler.start()
        logger.info("**********************Start training**********************")
        try:
            train_model(model, optimizer, schedule, train_loader, start_epoch, epochs,
                        ckpt_dir, device, accumulated_iter=it,
                        ckpt_save_interval=args.ckpt_save_interval,
                        max_ckpt_save_num=args.max_ckpt_save_num, logger=logger,
                        tb_log=tb_log, step_hook=profiler.step if profiler else None)
        finally:
            if profiler is not None:
                profiler.stop()
        logger.info("**********************End training**********************")

        # post-train evaluation of the last checkpoints (reference train.py:191-208)
        if args.num_epochs_to_eval > 0:
            logger.info("**********************Start evaluation**********************")
            # rank 0 wrote the last checkpoint: every rank sees it before the glob
            parallel.barrier()
            _, test_loader, _ = build_dataloader(
                dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                batch_size=batch_size, training=False, logger=logger, workers=args.workers,
                rank=rank, world=world)
            eval_output_dir = output_dir / "eval" / "eval_with_train"
            start_eval_epoch = max(epochs - args.num_epochs_to_eval, args.start_epoch, 0)
            for ck_path in sorted(glob.glob(str(ckpt_dir / "checkpoint_epoch_*.pth"))):
                m = re.findall(r"checkpoint_epoch_(\d+)\.pth", ck_path)
                if not m or int(m[-1]) <= start_eval_epoch:
                    continue
                load_model_state(model, ck_path)
                eval_one_epoch(
                    cfg, model, test_loader, m[-1], logger,
                    result_dir=eval_output_dir / ("epoch_%s" % m[-1])
                    / cfg.DATA_CONFIG.DATA_SPLIT["test"],
                    save_to_file=args.save_to_file, device=device,
                    dist_test=parallel.is_dist())
                logger.info("Epoch %s has been evaluated" % m[-1])
            logger.info("**********************End evaluation**********************")
        logger.info("kernel launches of this process: %s" % json.dumps(dict(
            cuda_lib.launches - launches_before)))
    finally:
        if tb_log is not None:
            tb_log.close()
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)
    return output_dir


if __name__ == "__main__":
    main()

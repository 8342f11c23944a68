"""Training runtime: the train step, the epoch loop and checkpoints.

Counterpart of ``pdanet_tpu/train/train_utils.py``: ``make_train_step``
(:66-106) is one iteration -- forward in training mode, loss, backward,
the optimizer's clip and update, and the BatchNorm running statistics,
which the forward updates in place; ``train_one_epoch`` runs it over one
epoch of the loader, on one device, and ``train_model`` (:250-322) is the
epoch loop with its checkpoints,
every ``ckpt_save_interval`` epochs, the oldest removed beyond
``max_ckpt_save_num``.  Checkpoints keep the reference's schema
``{epoch, it, model_state, optimizer_state, version}``, written to a
temporary file and published with ``os.replace``, with a CRC-32 over the
payload checked on load (:161-213); ``load_newest_checkpoint`` falls back
past a corrupt newest file (:216).

In a process group (``parallel``) each process trains on its shard of the
global batch, as the JAX package's data mesh does: the loss is each
rank's share of the global loss (the head's normalizers are global), the
gradients are summed over the ranks before the optimizer's clip sees
them, and rank 0 alone writes checkpoints.
"""

import glob
import io
import os
import pickle
import time
import zipfile
import zlib

import numpy as np
import torch

from .. import parallel
from ..utils.jax_weights import load_jax_checkpoint, load_jax_variables

CKPT_FORMAT_VERSION = 2


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable, truncated, or fails its checksum."""


POINT_KEYS = ("points", "gt_boxes")
VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")


def select_device_batch(batch, device, model=None):
    """The keys the detector consumes, as tensors on ``device`` (JAX
    ``train_utils.py:27-39``): the model's ``DEVICE_BATCH_KEYS`` where it
    declares them, else the voxel triplet when the batch has voxels and the
    points when not, with the gt boxes where the batch has them."""
    keys = getattr(model, "DEVICE_BATCH_KEYS", None)
    if keys is None:
        keys = VOXEL_KEYS if "voxels" in batch else POINT_KEYS
    return {k: torch.as_tensor(batch[k]).to(device) for k in keys if k in batch}


TRAIN_SEED = 0x5EED  # the JAX package's step key (train_utils.py:73)


def frame_generator(seed, step, frame):
    """The CPU ``torch.Generator`` of one frame of one step, seeded from
    (seed, step, the frame's index in the global batch)."""
    state = np.random.SeedSequence([int(seed), int(step), int(frame)]).generate_state(2)
    return torch.Generator().manual_seed((int(state[0]) << 31) ^ int(state[1]))


def make_train_step(model, optimizer, schedule):
    """``train_step(batch, draws=None) -> (loss, tb)``: one training
    iteration on a device batch (:func:`select_device_batch`: ``{"points":
    (B, N, 3 + C), "gt_boxes": (B, M, 8)}`` for a point detector, the voxel
    triplet and ``gt_boxes`` for a voxel one).

    A detector that draws random numbers in training (a two-stage RoI
    sampler, dropout; it has ``train_draws``) takes them as a value: the
    caller's ``draws``, or those of :func:`frame_generator` for each frame,
    seeded from ``TRAIN_SEED``, the update count and the frame's index in
    the global batch (``rank * B + i``), so that ranks of a process group
    draw what one process draws on the same global batch, and the card and
    the CPU draw the same bits (the generators are the CPU's).  Other
    detectors are unaffected.

    Update *t* takes the learning rate ``schedule.lr(t)`` and, for Adam,
    b1 ``schedule.mom(t)``, t the optimizer's update count.  The returned
    loss and tb scalars are detached tensors on the device; nothing waits
    for the device.  In a process group the gradients are summed over the
    ranks between the backward and the update, and the loss and tb scalars
    returned are those of the global batch (the ranks' shares summed).
    """

    def train_step(batch, draws=None):
        model.train()
        t = optimizer.count
        for group in optimizer.param_groups:
            group["lr"] = schedule.lr(t)
            if "b1" in group:
                group["b1"] = schedule.mom(t)
        optimizer.zero_grad(set_to_none=True)
        if hasattr(model, "train_draws"):
            if draws is None:
                B = batch["gt_boxes"].shape[0]
                draws = model.train_draws(
                    [frame_generator(TRAIN_SEED, t, parallel.rank() * B + i)
                     for i in range(B)],
                    batch["gt_boxes"].device)
            out = model.forward_batch(batch, draws=draws)
        else:
            out = model.forward_batch(batch)
        loss, tb = model.loss_batch(out, batch)
        loss.backward()
        parallel.reduce_gradients(model.parameters())
        optimizer.step()
        if parallel.is_dist():
            return _global_scalars(loss, tb)
        return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in tb.items()}

    return train_step


def _global_scalars(loss, tb):
    """The loss and tb scalars of the global batch: each rank's shares
    summed, in one float64 all-reduce, each returned in its own dtype."""
    vals = [loss, *tb.values()]
    total = parallel.all_reduce_detached(torch.stack(
        [torch.as_tensor(v, device=loss.device).detach().to(torch.float64) for v in vals]))
    dtypes = [torch.as_tensor(v).dtype for v in vals]
    return total[0].to(dtypes[0]), {k: total[i + 1].to(dtypes[i + 1])
                                    for i, k in enumerate(tb)}


def train_one_epoch(train_step, loader, device, accumulated_iter=0, logger=None,
                    log_every=50, tb_log=None, step_hook=None, model=None):
    """Run ``train_step`` over every batch of ``loader``.  Returns the
    global iteration count after the epoch.  The loss is read back to the
    host on logging iterations, and on every iteration when ``tb_log`` (a
    ``utils.metrics.MetricsLogger``) records the loss and tb scalars, the
    host seconds the loop waited for the batch (``meta_data/data_time``)
    and the iteration's seconds, the wait included
    (``meta_data/batch_time``).  ``step_hook`` is called after every
    iteration."""
    end = time.time()
    for batch in loader:
        data_time = time.time() - end
        loss, tb = train_step(select_device_batch(batch, device, model))
        accumulated_iter += 1
        log_iter = accumulated_iter % log_every == 0
        if tb_log is not None:
            tb_log.add_scalar("train/loss", float(loss), accumulated_iter)
            for k, v in tb.items():
                tb_log.add_scalar(f"train/{k}", float(v), accumulated_iter)
            tb_log.add_scalar("meta_data/data_time", data_time, accumulated_iter)
            tb_log.add_scalar("meta_data/batch_time", time.time() - end, accumulated_iter)
        if logger is not None and log_iter:
            logger.info("iter %d loss %.4f data %.3fs iter %.3fs"
                        % (accumulated_iter, float(loss), data_time, time.time() - end))
        if step_hook is not None:
            step_hook()
        end = time.time()
    return accumulated_iter


def train_model(model, optimizer, schedule, train_loader, start_epoch, total_epochs,
                ckpt_save_dir, device, accumulated_iter=0, ckpt_save_interval=1,
                max_ckpt_save_num=8, logger=None, tb_log=None, step_hook=None):
    """The epoch loop (``pdanet_tpu/train/train_utils.py:250-322``): epochs
    ``start_epoch`` to ``total_epochs``, the loader reseeded each epoch, a
    checkpoint ``checkpoint_epoch_<n>.pth`` in ``ckpt_save_dir`` every
    ``ckpt_save_interval`` epochs, the oldest by modification time removed
    so that at most ``max_ckpt_save_num`` remain.  Returns the global
    iteration count.  In a process group the parameters and buffers are
    broadcast from rank 0 before the first step, and rank 0 alone writes
    and removes checkpoints while the others wait (JAX :304-305)."""
    train_step = make_train_step(model, optimizer, schedule)
    parallel.broadcast_module(model)
    for cur_epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(cur_epoch)
        accumulated_iter = train_one_epoch(train_step, train_loader, device, accumulated_iter,
                                           logger=logger, tb_log=tb_log, step_hook=step_hook,
                                           model=model)
        trained_epoch = cur_epoch + 1
        if trained_epoch % ckpt_save_interval == 0:
            if parallel.rank() == 0:
                ckpt_list = sorted(glob.glob(str(ckpt_save_dir / "checkpoint_epoch_*.pth")),
                                   key=os.path.getmtime)
                for old in ckpt_list[:max(len(ckpt_list) - max_ckpt_save_num + 1, 0)]:
                    os.remove(old)
                ckpt_name = ckpt_save_dir / ("checkpoint_epoch_%d.pth" % trained_epoch)
                save_checkpoint(checkpoint_state(model, optimizer, trained_epoch,
                                                 accumulated_iter), ckpt_name)
                if logger is not None:
                    logger.info("checkpoint saved: %s" % ckpt_name)
            parallel.barrier()
    return accumulated_iter


def checkpoint_state(model, optimizer, epoch, it):
    return {
        "epoch": epoch,
        "it": it,
        "model_state": model.state_dict(),
        "optimizer_state": optimizer.state_dict(),
        "version": "pdanet_tpu_torch+r1",
    }


def save_checkpoint(ckpt, filename):
    """Write ``ckpt`` to ``filename`` atomically: a temporary file, fsync,
    then ``os.replace``; the payload carries a CRC-32."""
    buf = io.BytesIO()
    torch.save(ckpt, buf)
    payload = buf.getvalue()
    wrapper = {"format": CKPT_FORMAT_VERSION, "crc32": zlib.crc32(payload),
               "payload": payload}
    tmp = f"{filename}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(wrapper, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return filename


def load_checkpoint(filename, map_location="cpu"):
    """Read a checkpoint written by :func:`save_checkpoint`; raises
    :class:`CheckpointError` if the file is unreadable or its checksum
    does not match."""
    try:
        wrapper = torch.load(filename, map_location="cpu", weights_only=True)
        payload, crc = wrapper["payload"], wrapper["crc32"]
    except (OSError, EOFError, RuntimeError, KeyError, TypeError, ValueError,
            pickle.UnpicklingError) as e:
        raise CheckpointError(f"unreadable checkpoint {filename}: {e}") from e
    if zlib.crc32(payload) != crc:
        raise CheckpointError(f"checksum mismatch in {filename}")
    return torch.load(io.BytesIO(payload), map_location=map_location, weights_only=True)


def load_newest_checkpoint(ckpt_files, logger=None):
    """Load the newest readable checkpoint of ``ckpt_files`` (oldest to
    newest).  A corrupt newest file (cut mid-write, truncated, bit-rot)
    logs a warning and the one before it is tried.  Returns
    ``(ckpt, path)``, or ``(None, None)``."""
    for path in reversed(list(ckpt_files)):
        try:
            return load_checkpoint(path), path
        except CheckpointError as e:
            if logger is not None:
                logger.warning("skipping corrupt checkpoint %s (%s); falling back", path, e)
    return None, None


def load_model_state(model, path):
    """Fill ``model``'s parameters and statistics from the checkpoint file
    ``path``: one of the port's (``torch.save`` writes a zip archive) or
    one of the JAX package's (a pickle, read without jax)."""
    if zipfile.is_zipfile(path):
        model.load_state_dict(load_checkpoint(path)["model_state"])
    else:
        load_jax_variables(model, load_jax_checkpoint(path))
    return model


def restore_from_checkpoint(ckpt, model, optimizer=None):
    """Load a checkpoint's model and optimizer state; returns (epoch, it)."""
    model.load_state_dict(ckpt["model_state"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer_state"])
    return ckpt["epoch"], ckpt["it"]

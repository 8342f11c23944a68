"""Training runtime: the train step, the epoch loop and checkpoints.

Counterpart of ``pdanet_tpu/train/train_utils.py`` without its data
mesh: ``make_train_step`` (:66-106) is one iteration -- forward in
training mode, loss, backward, the optimizer's clip and update, and the
BatchNorm running statistics, which the forward updates in place;
``train_one_epoch`` is the loop of ``train_model`` (:250-322) over one
epoch, on one device.  Checkpoints keep the reference's schema
``{epoch, it, model_state, optimizer_state, version}``, written to a
temporary file and published with ``os.replace``, with a CRC-32 over the
payload checked on load (:161-213).
"""

import io
import os
import pickle
import time
import zlib

import torch

CKPT_FORMAT_VERSION = 2


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable, truncated, or fails its checksum."""


def select_device_batch(batch, device):
    """The keys a point detector consumes, as tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in ("points", "gt_boxes")
            if k in batch}


def make_train_step(model, optimizer, schedule):
    """``train_step(batch) -> (loss, tb)``: one training iteration on a
    device batch ``{"points": (B, N, 3 + C), "gt_boxes": (B, M, 8)}``.

    Update *t* takes the learning rate ``schedule.lr(t)`` and Adam's b1
    ``schedule.mom(t)``, t the optimizer's update count.  The returned
    loss and tb scalars are detached tensors on the device; nothing waits
    for the device.
    """

    def train_step(batch):
        model.train()
        t = optimizer.count
        for group in optimizer.param_groups:
            group["lr"] = schedule.lr(t)
            group["b1"] = schedule.mom(t)
        optimizer.zero_grad(set_to_none=True)
        out = model.forward_batch(batch)
        loss, tb = model.loss_batch(out, batch)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: torch.as_tensor(v).detach() for k, v in tb.items()}

    return train_step


def train_one_epoch(train_step, loader, device, accumulated_iter=0, logger=None,
                    log_every=50):
    """Run ``train_step`` over every batch of ``loader``.  Returns the
    global iteration count after the epoch.  The loss is read back to the
    host only on logging iterations."""
    end = time.time()
    for batch in loader:
        data_time = time.time() - end
        loss, _ = train_step(select_device_batch(batch, device))
        accumulated_iter += 1
        if logger is not None and accumulated_iter % log_every == 0:
            logger.info("iter %d loss %.4f data %.3fs iter %.3fs"
                        % (accumulated_iter, float(loss), data_time, time.time() - end))
        end = time.time()
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


def restore_from_checkpoint(ckpt, model, optimizer=None):
    """Load a checkpoint's model and optimizer state; returns (epoch, it)."""
    model.load_state_dict(ckpt["model_state"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer_state"])
    return ckpt["epoch"], ckpt["it"]

"""One train step of pdanet_tpu_torch in one process of a Gloo group, for
``tests/test_torch_train.py`` and ``tests/test_torch_dist.py``:

    python torch_dist_step.py SPEC RANK WORLD PORT

SPEC is a pickle the test writes: the model config and the keyword
arguments of ``build_network`` (``build``, a voxel detector's geometry),
its weights (``variables``, the JAX package's as numpy, or ``state``, a
port state dict), the optimizer config and schedule length, the dtype,
and per rank its device batch (``batch``: numpy arrays, floats cast to
the dtype) and, for IASSD, the sampling and ball-query indices of its
frames in call order (``samp``, ``ball``), fed to the backbone.  The
process joins the group at
``tcp://127.0.0.1:PORT``, runs ``train.make_train_step`` once and writes
its loss and tb scalars (the global batch's), its gradients (summed over
the ranks) and its state dict after the update to ``SPEC.rank<RANK>.pt``.
It imports torch and the port only.
"""

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d import iassd_backbone
from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables


def main(spec_path, rank, world, port):
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    mine = spec["ranks"][rank]
    dtype = spec["dtype"]
    model = build_network(spec["cfg"], spec["num_class"], device="cpu",
                          **spec.get("build", {})).to(dtype)
    if "state" in spec:
        model.load_state_dict(spec["state"])
    else:
        load_jax_variables(model, spec["variables"])
    optimizer, schedule = build_optimizer_and_schedule(model, spec["optim_cfg"],
                                                       *spec["schedule"])
    samp, ball = list(mine.get("samp", ())), list(mine.get("ball", ()))
    iassd_backbone.run_sampling = lambda *a: torch.tensor(samp.pop(0)).long()
    iassd_backbone.ball_query_multi = lambda r, n, xyz, c: tuple(
        torch.tensor(i).long() for i in ball.pop(0))
    batch = {k: torch.tensor(v, dtype=dtype if np.issubdtype(v.dtype, np.floating) else None)
             for k, v in mine["batch"].items()}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        loss, tb = make_train_step(model, optimizer, schedule)(batch)
    finally:
        dist.destroy_process_group()
    if samp or ball:
        raise RuntimeError(f"{len(samp)} sampling and {len(ball)} ball-query indices unused")
    torch.save({"loss": loss, "tb": tb,
                "grads": {n: p.grad for n, p in model.named_parameters()},
                "state": model.state_dict()}, f"{spec_path}.rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

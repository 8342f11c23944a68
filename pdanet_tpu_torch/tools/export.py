"""Export CLI: ``python -m pdanet_tpu_torch.tools.export --cfg_file <yaml>
(--ckpt <file> | --random_init)``.

Counterpart of the JAX package's ``tools/export.py``: the predict path
(forward + rotated-NMS post-processing) traced by ``torch.export`` into one
``.pt2`` program with the weights inside it, and a JSON sidecar
(``serving.save_serving``).  ``--ckpt`` takes the port's checkpoint or the
JAX package's ``.pkl`` (read without jax); ``--random_init`` exports seeded
random weights for a shape-only program.  ``--verify`` reloads the program
and holds it against the live closure (``serving.make_predict_fn``) at
rtol / atol 1e-5; ``--load`` runs a saved program on a synthetic batch
instead of exporting.  The program is traced on ``--device`` (CUDA unless
told) and runs there only.

Usage:
    python -m pdanet_tpu_torch.tools.export \\
        --cfg_file tools/cfgs/kitti_models/PDA-SSD.yaml \\
        --ckpt output/.../checkpoint_epoch_80.pth --batch_size 1 --verify
    python -m pdanet_tpu_torch.tools.export \\
        --cfg_file tools/cfgs/kitti_models/PDA-SSD.yaml --load PDA-SSD_b1.pt2
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import serving
from ..config import cfg_from_list, cfg_from_yaml_file
from ..datasets.dataset import DatasetTemplate
from ..models import build_network
from ..models.blocks import init_random_weights
from ..train import load_model_state


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="serving export")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="the port's checkpoint or the JAX package's .pkl; omit with "
                             "--random_init for a shape-only export")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default <cfg_stem>_b<B>.pt2)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the program is traced for and runs on")
    parser.add_argument("--load", type=str, default=None,
                        help="instead of exporting, load this program and smoke-run it on a "
                             "synthetic batch")
    parser.add_argument("--verify", action="store_true",
                        help="after exporting, reload the program and check that it "
                             "reproduces the live model's outputs")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER, help="config overrides")
    return parser.parse_args(argv)


def _numpy(pred):
    return {k: v.cpu().numpy() for k, v in pred.items()}


def main(argv=None):
    """Export (returns the program's path) or, with ``--load``, smoke-run a
    saved program (returns its pred dict)."""
    args = parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    device = torch.device(args.device)

    if args.load is not None:
        predict, exported = serving.load_serving(args.load)
        # the program's own inputs (its sidecar), for the synthetic batch
        spec = serving.sidecar_input_spec(json.loads(Path(f"{args.load}.json").read_text()))
        batch = serving.example_device_batch(cfg, spec, device)
        print(f"loaded {args.load}")
        print(f"  in : {exported.call_spec.in_spec}")
        pred = predict(batch)
        print(f"smoke run OK: pred_boxes {tuple(pred['pred_boxes'].shape)}, "
              f"counts per frame {pred['pred_counts'].tolist()}")
        return pred

    # the test split's pipeline, for the point features and a voxel
    # detector's grid (JAX tools/export.py:82-88)
    template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                               training=False, root_path=".")
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=template,
                          device=device)
    if args.ckpt is not None:
        load_model_state(model, args.ckpt)
        print(f"loaded checkpoint {args.ckpt}")
    elif args.random_init:
        init_random_weights(model, seed=0)
        print("WARNING: exporting RANDOM weights (--random_init)")
    else:
        raise SystemExit("provide --ckpt, or --random_init for a shape-only export")
    batch = serving.example_device_batch(
        cfg, serving.serving_input_spec(cfg, args.batch_size, model), device)

    exported = serving.export_serving(model, cfg.MODEL, batch)
    out = args.out or f"{Path(args.cfg_file).stem}_b{args.batch_size}.pt2"
    nbytes = serving.save_serving(exported, out,
                                  serving.serving_meta(cfg, args.cfg_file, batch, exported))
    print(f"exported {cfg.MODEL.NAME} -> {out} ({nbytes / 1e6:.1f} MB, device {device})")

    if args.verify:
        predict, _ = serving.load_serving(out)
        got = _numpy(predict(batch))
        live = _numpy(serving.make_predict_fn(model, cfg.MODEL)(batch))
        for k in live:
            np.testing.assert_allclose(got[k], live[k], rtol=1e-5, atol=1e-5, err_msg=k)
        print("verify OK: the program reproduces the live model's outputs")
    return out


if __name__ == "__main__":
    main()

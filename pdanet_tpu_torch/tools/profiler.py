"""Per-op time profiler of a config's forward, request or train step.

    python -m pdanet_tpu_torch.tools.profiler --cfg_file <yaml> \\
        [--batch_size 1] [--mode forward|e2e|train] [--repeats 3] [--top 20] \\
        [--device cuda]

Counterpart of the JAX package's ``tools/profiler.py``: the yaml's model
(a point detector that ``build_network`` builds without a dataset, IASSD or
PointRCNN, as the JAX package's ``bench.build_model``; a voxel detector
raises), seeded random weights, a LiDAR-like cloud of seed 7 at the yaml's
test ``sample_points`` (16384 without one), and for ``train`` a batch of
one car a frame.  ``forward`` times the detector's forward, ``e2e`` the
serving closure (forward and post-processing), ``train`` one step of the
yaml's optimizer.  One warm-up call, then ``--repeats`` calls under
``torch.profiler``: the device time per call (the sum of the kernels'
times) and the busy time (the union of their intervals), the split by
family (each of the port's kernels a family of its own, from its device
function's name) and the ``--top`` kernels.

It runs on CUDA unless ``--device cpu``, which traces the CPU's operators
instead (each operator's self time, a port op's children counted in its
family): a check of the tool on a machine without a card, no device number.

``device_split``, ``short_name`` and ``lidar_like_cloud`` are also what
``chip_smoke.py`` reads.
"""

import argparse
import collections
import os

import numpy as np

# the device functions of csrc/, as the profiler names them, and the op of each
PORT_KERNELS = {"fps_kernel": "fps", "fps_features_kernel": "fps_features",
                "ball_query_kernel": "ball_query", "attn_kernel": "neighbor_attention",
                "attn_fwd_mma": "neighbor_attention", "attn_bwd_kernel": "neighbor_attention_bwd",
                "attn_bwd_mma": "neighbor_attention_bwd", "iou_self_kernel": "rotated_iou",
                "nms_mask_kernel": "nms", "nms_walk_kernel": "nms"}
# every other kernel or operator by the first of these its lower-case name holds
FAMILIES = (("matmul/conv", ("gemm", "cutlass", "xmma", "cublas", "conv", "cudnn", "fft", "mm")),
            ("sort/top-k", ("sort", "topk")),
            ("reduce/norm", ("reduce", "softmax", "norm", "sum", "max", "mean")),
            ("copy/index", ("copy", "cat", "transpose", "index", "gather", "scatter", "memcpy",
                            "memset", "fill", "to_copy", "clone")),
            ("elementwise", ("elementwise",)))
SAMPLE_POINTS = 16384  # without a sample_points processor in the yaml
TRAIN_GT = (10.0, 1.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1.0)  # one car a frame (x y z l w h ry cls)


def lidar_like_cloud(seed, B, N, x_range=(0.0, 70.4), y_range=(-40.0, 40.0),
                     with_centers=False):
    """LiDAR-like frames (B, N, 4): a ground plane with 1/r density
    falloff, car-sized clusters and sparse mid-air returns, x-sorted like
    the pipeline's ``sort_points`` step (a numpy copy of bench.py's).
    ``with_centers`` also returns the (12, 3) cluster centres."""
    rs = np.random.RandomState(seed)
    n_ground = int(N * 0.72)
    n_obj = int(N * 0.2)
    n_air = N - n_ground - n_obj
    r = x_range[1] * np.sqrt(rs.rand(n_ground)) ** 1.4
    th = rs.uniform(-0.8, 0.8, n_ground)
    ground = np.stack([np.clip(r * np.cos(th), *x_range),
                       np.clip(r * np.sin(th), *y_range),
                       rs.normal(-1.7, 0.05, n_ground)], -1)
    n_clusters = 12
    centers = np.stack([rs.uniform(5, 60, n_clusters),
                        rs.uniform(-20, 20, n_clusters),
                        rs.uniform(-1.2, -0.4, n_clusters)], -1)
    member = rs.randint(0, n_clusters, n_obj)
    obj = centers[member] + rs.randn(n_obj, 3) * np.array([2.0, 0.9, 0.7]) * 0.5
    air = np.stack([rs.uniform(*x_range, n_air), rs.uniform(*y_range, n_air),
                    rs.uniform(-1.0, 2.5, n_air)], -1)
    pts = np.concatenate([ground, obj, air], 0).astype(np.float32)
    cloud = np.concatenate([pts, rs.rand(N, 1).astype(np.float32)], -1)
    out = np.stack([cloud] * B)
    out[:, :, :3] += rs.randn(B, N, 3).astype(np.float32) * 0.05
    for b in range(B):
        out[b] = out[b][np.argsort(out[b, :, 0], kind="stable")]
    return (out, centers) if with_centers else out


def short_name(name):
    """A profiler kernel name without its arguments and namespaces, and
    with only the first of long template arguments."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    head, _, tmpl = base.strip().partition("<")
    head = head.split("::")[-1]
    tmpl = tmpl.rstrip(">")
    if len(tmpl) > 12:
        tmpl = tmpl.split(",")[0].split("::")[-1]
    return (f"{head}<{tmpl}>" if tmpl else head)[:60]


def family(name):
    """The family of a device kernel (its short name) or a CPU operator:
    a port kernel's or op's own name, else the first of ``FAMILIES`` that
    matches, else ``other``."""
    from ..ops import cuda_lib

    base = name.split("<")[0]
    if base in PORT_KERNELS:
        return PORT_KERNELS[base]
    if name.startswith(f"{cuda_lib.NAMESPACE}::"):
        return name.split("::", 1)[1]
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_events(fn, active=1, cuda=True):
    """The profiler events of the last ``active`` of ``active + 1`` runs of
    ``fn`` (the first warms the tracer up, which can drop the first kernel
    of a cold start), each run ending in a synchronise on CUDA: the
    device's activity with ``cuda``, else the CPU's operators.  None when
    the profiler cannot trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    try:
        with profile(activities=[activity],
                     schedule=schedule(wait=0, warmup=1, active=active, repeat=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            for _ in range(active + 1):
                fn()
                if cuda:
                    torch.cuda.synchronize()
                prof.step()
    except RuntimeError:
        return None
    return events


def _device_spans(events):
    import torch

    spans = [e for e in events or () if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(spans, key=lambda e: e.time_range.start)


def _busy_ms(spans):
    busy, end = 0.0, float("-inf")
    for e in spans:
        start = max(e.time_range.start, end)
        end = max(end, e.time_range.end)
        busy += max(0.0, end - start) / 1e3
    return busy


def device_split(fn, top=5, full=False):
    """The second of two runs of ``fn`` under torch.profiler (the first
    warms the tracer up, which can drop the first kernel of a cold start):
    its device activity (kernels and memsets) as (count, busy milliseconds
    -- the union of their intervals --, the ``top`` names by summed
    milliseconds, and the port's own kernels with their milliseconds and
    launches); None when the profiler cannot trace the card.  With ``full``
    the names are the kernels' own (their first 160 characters)."""
    spans = _device_spans(profile_events(fn))
    if not spans:
        return None
    by_name, own = collections.Counter(), {}
    for e in spans:
        ms = e.time_range.elapsed_us() / 1e3
        name = short_name(e.name)
        by_name[e.name[:160] if full else name] += ms
        if name.split("<")[0] in PORT_KERNELS:
            t, n = own.get(name, (0.0, 0))
            own[name] = (t + ms, n + 1)
    return len(spans), _busy_ms(spans), by_name.most_common(top), own


def _cpu_split(events):
    """{operator: self ms} and {family: self ms} of CPU events, an
    operator nested in a port op counted in the op's family."""
    from ..ops import cuda_lib

    by_name, by_family = collections.Counter(), collections.Counter()
    for e in events:
        if e.name.startswith("ProfilerStep"):  # the schedule's own span
            continue
        ms = e.self_cpu_time_total / 1e3
        by_name[e.name] += ms
        owner, parent = e.name, e.cpu_parent
        while parent is not None:
            if parent.name.startswith(f"{cuda_lib.NAMESPACE}::"):
                owner = parent.name
            parent = parent.cpu_parent
        by_family[family(owner)] += ms
    return by_name, by_family


def build_model(cfg_file, device):
    """The yaml's config and its detector on ``device`` with seeded random
    weights: a point detector, built without a dataset (4 input
    channels)."""
    from ..config import cfg_from_yaml_file
    from ..models import build_network
    from ..models.blocks import init_random_weights
    from ..models.detectors import VOXEL_DETECTORS, resolve_detector_name

    cfg = cfg_from_yaml_file(cfg_file)
    name = resolve_detector_name(cfg.MODEL)
    if name in VOXEL_DETECTORS:
        raise ValueError(f"{cfg_file}: {name} takes its grid from a dataset; the profiler "
                         "builds the point detectors (IASSD, PointRCNN) only")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), input_channels=4, device=device)
    return cfg, init_random_weights(model, seed=0)


def sample_points(cfg):
    for proc in cfg.DATA_CONFIG.get("DATA_PROCESSOR", []):
        if proc["NAME"] == "sample_points":
            n = proc["NUM_POINTS"]
            return int(n["test"] if isinstance(n, dict) else n)
    return SAMPLE_POINTS


def make_call(cfg, model, mode, batch_size, device):
    """One call of ``mode`` on the seed-7 cloud, its result read back."""
    import torch

    pts = torch.from_numpy(lidar_like_cloud(7, batch_size, sample_points(cfg))).to(device)
    if mode == "forward":
        model.eval()

        def call():
            with torch.inference_mode():
                return model.forward_batch({"points": pts})["batch_box_preds"].sum().item()
    elif mode == "e2e":
        from ..serving import make_predict_fn

        predict = make_predict_fn(model, cfg.MODEL)

        def call():
            return predict({"points": pts})["pred_scores"].sum().item()
    else:
        from ..train import build_optimizer_and_schedule, make_train_step

        gt = torch.zeros(batch_size, 40, 8, device=device)
        gt[:, 0] = torch.tensor(TRAIN_GT)
        optimizer, schedule = build_optimizer_and_schedule(model, cfg.OPTIMIZATION, 100, 80)
        step = make_train_step(model, optimizer, schedule)

        def call():
            return step({"points": pts, "gt_boxes": gt})[0].item()
    return call


def profile_config(cfg_file, mode="forward", batch_size=1, repeats=3, top=20, device="cuda"):
    """Profile ``repeats`` calls of ``mode`` (after one warm-up) and print
    the report.  Returns ``{"per_call_ms", "busy_ms", "families": {family:
    ms a call}, "top": [(name, ms a call)], "device": ...}``; on the CPU
    ``busy_ms`` is None and the times are the operators' CPU time."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profiler times the card (--device cpu traces "
                           "the CPU's operators)")
    cfg, model = build_model(cfg_file, device)
    call = make_call(cfg, model, mode, batch_size, device)
    call()  # warm-up: the kernels' build, the allocator, library set-up
    events = profile_events(call, active=repeats, cuda=cuda)
    if cuda:
        spans = _device_spans(events)
        if not spans:
            raise RuntimeError("the profiler saw no device activity")
        by_name, by_family = collections.Counter(), collections.Counter()
        for e in spans:
            name = short_name(e.name)
            ms = e.time_range.elapsed_us() / 1e3
            by_name[name] += ms
            by_family[family(name)] += ms
        busy, what = _busy_ms(spans) / repeats, f"{torch.cuda.get_device_name(device)} time"
    else:
        by_name, by_family = _cpu_split(events)
        busy, what = None, "CPU time (operators' self time, not a device number)"
    total = sum(by_name.values()) / repeats
    head = (f"\n{mode} b{batch_size} {os.path.basename(cfg_file)}: {total:.3f} ms {what} "
            "per call")
    if busy is not None:
        head += f", busy {busy:.3f} ms, {len(spans) // repeats} kernels and memsets a call"
    print(head)
    print("-- by family:")
    for fam, ms in by_family.most_common():
        print(f"  {ms / repeats:9.3f} ms  {100 * ms / repeats / max(total, 1e-12):5.1f}%  {fam}")
    print(f"-- top {top} ops:")
    for name, ms in by_name.most_common(top):
        print(f"  {ms / repeats:9.3f} ms  {name[:100]}")
    return {"per_call_ms": total, "busy_ms": busy, "device": str(device),
            "families": {f: ms / repeats for f, ms in by_family.items()},
            "top": [(n, ms / repeats) for n, ms in by_name.most_common(top)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-op time of a config's forward, request or "
                                 "train step under torch.profiler")
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--mode", choices=("forward", "e2e", "train"), default="forward")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) unless cpu, which traces the CPU's operators")
    args = ap.parse_args(argv)
    return profile_config(args.cfg_file, args.mode, args.batch_size, args.repeats, args.top,
                          args.device)


if __name__ == "__main__":
    main()

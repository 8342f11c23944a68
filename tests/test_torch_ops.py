"""pdanet_tpu_torch ops against the JAX package, on the CPU.

Each op of the port that holds a CUDA kernel is checked here through its
plain PyTorch version (the CPU path of its dispatch) against the JAX
function on the same numpy inputs: FPS, the multi-radius ball query
(also against the Pallas kernel in interpret mode), the rotated self-IoU
(and the premise of its kernel's circle skip), the greedy NMS walk, and
the box decode.  Index outputs must be equal;
IoU holds the Pallas IoU test's tolerance (rtol 2e-4, atol 2e-5), the box
decode atol 1e-5.  The kernels themselves are held against the same plain
versions on the card by chip_smoke.py.  Each of the six kernel wrappers
enters the device of its tensors around its launch (fake tensors on
``cuda:1``, the kernel library stubbed), and the IoU and NMS wrappers
count their launches by K as well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import ball_query_work, boundary_cloud, skip_pair_boxes
from pdanet_tpu.ops import ball_query as jbq
from pdanet_tpu.ops import nms as jnms
from pdanet_tpu.ops import rotated_iou as jiou
from pdanet_tpu.ops import sampling as jsampling
from pdanet_tpu.ops.grouping import gather_points as j_gather
from pdanet_tpu.ops.grouping import group_points as j_group
from pdanet_tpu_torch.ops import cuda_lib
from pdanet_tpu_torch.ops.ball_query import ball_query, ball_query_multi, ball_query_multi_cuda
from pdanet_tpu_torch.ops.grouping import gather_points, group_points
from pdanet_tpu_torch.ops.nms import (
    NMS_MAX_K,
    greedy_nms_mask_batched,
    greedy_nms_mask_batched_cuda,
)
from pdanet_tpu_torch.ops.rotated_iou import (
    MAX_FRAMES,
    SKIP_SLACK,
    boxes_iou_bev,
    boxes_iou_bev_batched_self,
    boxes_iou_bev_batched_self_cuda,
)
from pdanet_tpu_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_cuda,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once, and torch's default of a thread
    per core in each of them oversubscribes the cores many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cloud(seed, B, N, spread=(6.0, 6.0, 3.0)):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, N, 3) * np.asarray(spread)).astype(np.float32)


def _boxes(B, K, seed, spread=12.0):
    rs = np.random.RandomState(seed)
    b = np.zeros((B, K, 7), np.float32)
    b[..., 0:2] = rs.uniform(-spread, spread, (B, K, 2))
    b[..., 2] = rs.uniform(-1.5, 0.5, (B, K))
    b[..., 3:5] = rs.uniform(0.5, 4.5, (B, K, 2))
    b[..., 5] = rs.uniform(1.0, 2.0, (B, K))
    b[..., 6] = rs.uniform(-np.pi, np.pi, (B, K))
    return b


@pytest.mark.parametrize("B,N,npoint,dups", [
    (2, 300, 64, False),
    (1, 1100, 200, False),
    (1, 96, 64, True),   # duplicated points: lowest-index ties decide
])
def test_fps_matches_xla(B, N, npoint, dups):
    xyz = _cloud(N, B, N)
    if dups:
        xyz[:, 48:] = xyz[:, :48]
    want = np.asarray(jsampling._farthest_point_sample_xla(jnp.asarray(xyz), npoint))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,N,npoint,layout", [
    (1, 777, 100, "plain"),   # N not a multiple of 128
    (2, 1000, 257, "plain"),
    (1, 300, 300, "plain"),   # npoint = N
    (2, 130, 130, "spread"),  # npoint = N with every point twice
    (1, 640, 200, "spread"),  # duplicates over the whole index range
    (1, 512, 512, "spread"),
])
def test_fps_edge_cases_match_xla(B, N, npoint, layout):
    xyz = _cloud(N + 1, B, N)
    if layout == "spread":
        half = N // 2
        xyz[:, half:2 * half] = xyz[:, :half]
        xyz = np.ascontiguousarray(xyz[:, np.random.RandomState(N).permutation(N)])
    want = np.asarray(jsampling._farthest_point_sample_xla(jnp.asarray(xyz), npoint))
    got = farthest_point_sample(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)


def _lidar_like(seed, N, x_range=(0.0, 12.0), y_range=(-6.0, 6.0)):
    """An x-sorted LiDAR-like frame (1, N, 3) on a small area: a ground
    plane denser near the sensor, car-sized clusters and sparse returns in
    the air, as the pipeline's sort_points step leaves SA0's support."""
    rs = np.random.RandomState(seed)
    n_ground, n_obj = int(N * 0.7), int(N * 0.2)
    n_air = N - n_ground - n_obj
    r = x_range[1] * np.sqrt(rs.rand(n_ground)) ** 1.4
    th = rs.uniform(-0.8, 0.8, n_ground)
    ground = np.stack([np.clip(r * np.cos(th), *x_range), np.clip(r * np.sin(th), *y_range),
                       rs.normal(-1.7, 0.05, n_ground)], -1)
    centers = np.stack([rs.uniform(2, 10, 4), rs.uniform(-4, 4, 4),
                        rs.uniform(-1.2, -0.4, 4)], -1)
    obj = centers[rs.randint(0, 4, n_obj)] + rs.randn(n_obj, 3) * np.array([1.0, 0.45, 0.35])
    air = np.stack([rs.uniform(*x_range, n_air), rs.uniform(*y_range, n_air),
                    rs.uniform(-1.0, 2.5, n_air)], -1)
    pts = np.concatenate([ground, obj, air]).astype(np.float32)
    return np.ascontiguousarray(pts[np.argsort(pts[:, 0], kind="stable")][None])


def _assert_ball_query_matches_jax(radii, ks, xyz, centres):
    want = jbq.ball_query_multi(radii, ks, jnp.asarray(xyz), jnp.asarray(centres))
    got = ball_query_multi(radii, ks, torch.from_numpy(xyz), torch.from_numpy(centres))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("N,M", [(2048, 512), (3000, 700)])
def test_ball_query_sa0_lidar_like_matches_jax(N, M):
    """SA0: D-FPS centres over an x-sorted LiDAR-like cloud, radii 0.2 /
    0.8 m, K 16 / 32."""
    xyz = _lidar_like(N, N)
    picks = farthest_point_sample(torch.from_numpy(xyz), M).numpy().astype(np.int64)
    centres = np.ascontiguousarray(np.take_along_axis(xyz, picks[..., None], 1))
    got = _assert_ball_query_matches_jax((0.2, 0.8), (16, 32), xyz, centres)
    filled = (got[1] != got[1][..., :1]).any(-1)
    assert 0 < int(filled.sum()) < M  # some balls hold several points, some one


@pytest.mark.parametrize("radii,ks", [
    ((0.2, 0.8), (16, 32)),
    ((1.6, 4.8), (16, 32)),
    ((4.8, 8.4, 12.8), (16, 32, 64)),
])
def test_ball_query_radius_boundary_matches_jax(radii, ks):
    """Points at float32(r), at d2 == float32(r * r) where a float32 d gives
    it, and up to 3 ulps either side: the test is d2 < r2, strict."""
    xyz, centres = boundary_cloud(radii)
    _assert_ball_query_matches_jax(radii, ks, xyz, centres)


@pytest.mark.parametrize("N,M,radii", [(2048, 256, (0.2, 0.8)), (1000, 100, (1.6, 4.8))])
def test_ball_query_work_counts_every_tile_with_a_hit(N, M, radii):
    """The work behind the ball query's bound in chip_smoke.py: with K = N
    no ball fills, so a first-K scan visits all N points per centre, and
    the tiles the box test keeps hold every hit; on an x-sorted cloud they
    are fewer than all."""
    xyz = torch.from_numpy(_lidar_like(N + 7, N))
    centres = xyz[:, torch.from_numpy(np.random.RandomState(M).permutation(N)[:M])]
    scan, in_reach = ball_query_work(radii, (N, N), xyz, centres)
    d2 = ((centres[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    hit = d2 < float(np.float32(max(radii) ** 2))
    n_tiles = -(-N // 128)
    pad = torch.nn.functional.pad(hit, (0, n_tiles * 128 - N)).view(1, M, n_tiles, 128)
    sizes = torch.full((n_tiles,), 128)
    sizes[-1] = N - 128 * (n_tiles - 1)
    with_hit = int((pad.any(-1) * sizes).sum())
    assert scan == M * N
    assert with_hit <= in_reach < scan


@pytest.mark.parametrize("radii,ks,spread", [
    ((4.8, 8.4, 12.8), (16, 32, 64), 8.0),  # ONCE SA5
    ((0.5, 1.0, 2.0), (64, 8, 32), 1.5),
])
def test_ball_query_three_radii_matches_jax(radii, ks, spread):
    rs = np.random.RandomState(len(ks) + int(spread))
    xyz = (rs.randn(2, 500, 3) * spread).astype(np.float32)
    centres = np.ascontiguousarray(xyz[:, ::5] + rs.randn(2, 100, 3).astype(np.float32))
    _assert_ball_query_matches_jax(radii, ks, xyz, centres)


@pytest.mark.parametrize("B,N,M,radii,ks,spread", [
    (2, 512, 128, (0.5, 1.5), (8, 16), 2.0),
    (1, 700, 100, (0.8,), (16,), 2.0),
    (2, 600, 64, (0.2, 0.8), (16, 32), 1.0),  # SA0-like radii and K
    (1, 400, 50, (0.05,), (4,), 40.0),       # mostly empty balls: index 0
])
def test_ball_query_matches_jax(B, N, M, radii, ks, spread):
    rs = np.random.RandomState(B * N + M)
    xyz = (rs.randn(B, N, 3) * spread).astype(np.float32)
    centres = np.concatenate(
        [xyz[:, : M // 2], (rs.randn(B, M - M // 2, 3) * spread).astype(np.float32)],
        axis=1)
    want = jbq.ball_query_multi(radii, ks, jnp.asarray(xyz), jnp.asarray(centres))
    got = ball_query_multi(radii, ks, torch.from_numpy(xyz), torch.from_numpy(centres))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    single = ball_query(radii[0], ks[0], torch.from_numpy(xyz), torch.from_numpy(centres))
    np.testing.assert_array_equal(single.numpy(), np.asarray(want[0]))


def test_ball_query_matches_pallas_interpret():
    from pdanet_tpu.ops.pallas.ball_query import ball_query_multi_pallas

    rng = np.random.RandomState(1024)
    xyz = rng.randn(2, 512, 3).astype(np.float32) * 2.0
    centres = xyz[:, :128]
    want = ball_query_multi_pallas((0.5, 1.5), (8, 16), jnp.asarray(xyz),
                                   jnp.asarray(centres), interpret=True)
    got = ball_query_multi((0.5, 1.5), (8, 16), torch.from_numpy(xyz),
                           torch.from_numpy(centres))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ball_query_ignores_cloud_order():
    """Permuting the support permutes the hits but keeps their set when
    every ball holds fewer than K points."""
    xyz = _cloud(5, 1, 300)
    perm = np.random.RandomState(6).permutation(300)
    centres = torch.from_numpy(xyz[:, :20])
    a = ball_query(0.4, 64, torch.from_numpy(xyz), centres)[0].numpy()
    b = ball_query(0.4, 64, torch.from_numpy(xyz[:, perm]), centres)[0].numpy()
    for ra, rb in zip(a, b):
        assert set(ra.tolist()) == set(perm[rb].tolist())


@pytest.mark.parametrize("B,K,seed,spread", [
    (2, 64, 0, 12.0),
    (1, 96, 3, 3.0),  # tight cluster: most pairs overlap
])
def test_iou_self_matches_jax(B, K, seed, spread):
    boxes = _boxes(B, K, seed, spread)
    want = np.asarray(jiou.boxes_iou_bev_batched_self(jnp.asarray(boxes)))
    got = boxes_iou_bev_batched_self(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for b in range(B):
        np.testing.assert_allclose(np.diagonal(got[b]), 1.0, rtol=1e-5)
    assert got.max() <= 1.0 + 1e-6


def test_iou_pairs_match_jax():
    a, b = _boxes(1, 40, 11, 5.0)[0], _boxes(1, 30, 12, 5.0)[0]
    want = np.asarray(jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seed,thresh,K,valid_kind", [
    pytest.param(7, 0.01, 96, "random", id="7-0.01"),
    pytest.param(8, 0.3, 96, "random", id="8-0.3"),
    # K around the 64-candidate blocks of the kernel's walk
    *(pytest.param(9, 0.1, K, kind, id=f"K{K}-{kind}")
      for K in (1, 65, 130) for kind in ("all", "none")),
])
def test_nms_keep_matches_xla(seed, thresh, K, valid_kind):
    B = 2
    boxes = _boxes(B, K, seed, spread=5.0 * np.sqrt(K / 96))
    iou = np.array(jiou.boxes_iou_bev_batched_self(jnp.asarray(boxes)))
    valid = {"random": np.random.RandomState(seed).rand(B, K) > 0.2,
             "all": np.ones((B, K), bool), "none": np.zeros((B, K), bool)}[valid_kind]
    want = np.stack([
        np.asarray(jnms._greedy_nms_mask_xla(jnp.asarray(iou[b]),
                                             jnp.asarray(valid[b]), thresh))
        for b in range(B)])
    got = greedy_nms_mask_batched(torch.from_numpy(iou), torch.from_numpy(valid), thresh)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_skips(a, b):
    """The IoU kernel's circle skip (csrc/rotated_iou.cu) on pairs (P, 7) x
    (P, 7), in its own float32 operations: centres farther apart than
    r_a + r_b + SKIP_SLACK."""
    f = np.float32

    def radius(x):
        return f(0.5) * np.sqrt(x[:, 3] * x[:, 3] + x[:, 4] * x[:, 4])

    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    lim = (radius(a) + radius(b)) + f(SKIP_SLACK)
    return dx * dx + dy * dy > lim * lim


def test_iou_circle_skip_is_exact():
    """The premise of the IoU kernel's circle skip: the plain IoU and the
    JAX package's are exactly 0 for every pair the skip writes 0 for.  A
    seeded sweep of pairs just beyond the skip distance, half of them
    corner to corner (where the 1e-2 containment margin reaches
    furthest), with zero-size and sliver boxes; and, to show that the
    sweep reaches the margin, pairs closer than it do overlap."""
    pairs = skip_pair_boxes(5, 4000, (SKIP_SLACK, SKIP_SLACK + 1e-3))
    a, b = pairs[:, 0], pairs[:, 1]
    skip = _kernel_skips(a, b)
    assert skip.mean() > 0.99
    got = boxes_iou_bev(torch.from_numpy(a)[:, None], torch.from_numpy(b)[:, None])[:, 0, 0]
    jax_iou = jax.jit(jax.vmap(lambda x, y: jiou.boxes_iou_bev(x[None], y[None])[0, 0]))
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b)))
    assert (got.numpy()[skip] == 0).all()
    assert (want[skip] == 0).all()

    near = skip_pair_boxes(6, 4000, (0.0, 0.01))
    assert not _kernel_skips(near[:, 0], near[:, 1]).any()
    got = boxes_iou_bev(torch.from_numpy(near[:, 0])[:, None],
                        torch.from_numpy(near[:, 1])[:, None])[:, 0, 0]
    assert (got > 0).sum() > 100


def test_skip_slack_is_the_kernels():
    """SKIP_SLACK, which the premise test sweeps, is the kernel's constant."""
    import re
    from pathlib import Path

    src = (Path(cuda_lib.CSRC) / "rotated_iou.cu").read_text()
    found = re.findall(r"constexpr float kSkipSlack = ([0-9.e+-]+)f;", src)
    assert found and float(np.float32(found[0])) == float(np.float32(SKIP_SLACK))


def test_kernels_refuse_shapes_beyond_their_launch():
    """A K the NMS walk's registers cannot hold, and more frames than the
    IoU grid takes, raise before any launch."""
    iou = torch.zeros(1, 1, 1).expand(1, NMS_MAX_K + 1, NMS_MAX_K + 1)
    cuda_lib.launches.clear()
    with pytest.raises(ValueError, match=str(NMS_MAX_K)):
        greedy_nms_mask_batched_cuda(iou, torch.ones(1, NMS_MAX_K + 1, dtype=torch.bool), 0.1)
    with pytest.raises(ValueError, match=str(MAX_FRAMES)):
        boxes_iou_bev_batched_self_cuda(torch.zeros(1, 1, 7).expand(MAX_FRAMES + 1, 1, 7))
    assert sum(cuda_lib.launches.values()) == 0


def test_box_decode_matches_jax():
    from pdanet_tpu.utils.box_coder_utils import PointResidual_BinOri_Coder as JCoder
    from pdanet_tpu_torch.utils.box_coder_utils import PointResidual_BinOri_Coder

    kw = dict(angle_bin_num=12, use_mean_size=True,
              mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]])
    rs = np.random.RandomState(3)
    enc = rs.randn(2, 50, 30).astype(np.float32)
    pts = rs.randn(2, 50, 3).astype(np.float32) * 10
    cls = rs.randint(1, 4, (2, 50))
    want = np.asarray(JCoder(**kw).decode(jnp.asarray(enc), jnp.asarray(pts),
                                          jnp.asarray(cls)))
    got = PointResidual_BinOri_Coder(**kw).decode(
        torch.from_numpy(enc), torch.from_numpy(pts), torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_gather_and_group_match_jax():
    rs = np.random.RandomState(9)
    feats = rs.randn(2, 40, 5).astype(np.float32)
    idx = rs.randint(0, 40, (2, 12, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
        np.asarray(j_group(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        gather_points(torch.from_numpy(feats), torch.from_numpy(idx[..., 0])).numpy(),
        np.asarray(j_gather(jnp.asarray(feats), jnp.asarray(idx[..., 0]))))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build()


def test_cpu_tensors_take_the_plain_versions():
    """CPU dispatch never touches the kernel library or its counters, and a
    kernel wrapper refuses a CPU tensor instead of falling back."""
    cuda_lib.launches.clear()
    xyz = torch.from_numpy(_cloud(1, 1, 64))
    farthest_point_sample(xyz, 8)
    boxes = torch.from_numpy(_boxes(1, 8, 2))
    iou = boxes_iou_bev_batched_self(boxes)
    greedy_nms_mask_batched(iou, torch.ones(1, 8, dtype=torch.bool), 0.1)
    assert sum(cuda_lib.launches.values()) == 0
    with pytest.raises(ValueError):
        farthest_point_sample_cuda(xyz, 8)
    with pytest.raises(ValueError):
        boxes_iou_bev_batched_self_cuda(boxes)
    with pytest.raises(ValueError):
        greedy_nms_mask_batched_cuda(iou, torch.ones(1, 8, dtype=torch.bool), 0.1)


def test_ball_query_kernel_refuses_cpu_tensors():
    """The ball-query kernel wrapper raises on a CPU tensor instead of
    falling back to the plain version."""
    xyz = torch.from_numpy(_cloud(3, 1, 64))
    cuda_lib.launches.clear()
    with pytest.raises(ValueError):
        ball_query_multi_cuda((0.5,), (8,), xyz, xyz[:, :8].contiguous())
    assert sum(cuda_lib.launches.values()) == 0


@pytest.mark.parametrize("name", ["fps", "ball_query", "neighbor_attention",
                                  "neighbor_attention_bwd", "rotated_iou", "nms"])
def test_kernel_wrappers_enter_the_device_of_their_tensors(name, monkeypatch):
    """Each kernel wrapper launches with the device of its tensors current,
    so that a process driving ``cuda:1`` launches there.  Without a card:
    fake tensors on ``cuda:1`` (``FakeTensorMode``), the kernel library
    stubbed to record the current device at each call, and
    ``torch.cuda.device`` recording the device it enters."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from pdanet_tpu_torch.ops.attention import (
        neighbor_attention_flat_bwd_cuda,
        neighbor_attention_flat_cuda,
    )

    entered, current, calls = [], [None], []

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        outer, current[0] = current[0], torch.device(d)
        try:
            yield
        finally:
            current[0] = outer

    class StubLib:
        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, current[0])) or 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(cuda_lib, "lib", StubLib)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: None)
    monkeypatch.setattr(cuda_lib, "ptr", lambda t: None)
    # a CPU-only build refuses Tensor.contiguous on a fake CUDA tensor; a
    # contiguous clone is what it returns
    monkeypatch.setattr(torch.Tensor, "contiguous", lambda t: t if t.is_contiguous() else
                        t.clone(memory_format=torch.contiguous_format))
    dev = torch.device("cuda", 1)
    cuda_lib.launches.clear()
    with FakeTensorMode():
        xyz = torch.empty(2, 64, 3, device=dev)
        q = torch.empty(32, 2 * 16, device=dev)
        boxes = torch.empty(2, 8, 7, device=dev)
        wrappers = {
            "fps": lambda: farthest_point_sample_cuda(xyz, 8),
            "ball_query": lambda: ball_query_multi_cuda((0.5, 1.0), (8, 16), xyz,
                                                    torch.empty(2, 8, 3, device=dev)),
            "neighbor_attention": lambda: neighbor_attention_flat_cuda(q, q, q, 8, 2, 16),
            "neighbor_attention_bwd": lambda: neighbor_attention_flat_bwd_cuda(
                q, q, q, q, 8, 2, 16),
            "rotated_iou": lambda: boxes_iou_bev_batched_self_cuda(boxes),
            "nms": lambda: greedy_nms_mask_batched_cuda(
                torch.empty(2, 8, 8, device=dev), torch.empty(2, 8, dtype=torch.bool,
                                                              device=dev), 0.1),
        }
        wrappers[name]()
    assert entered == [dev], entered
    assert calls and all(d == dev for _, d in calls), calls
    assert dict(cuda_lib.launches) == {name: 1}
    cuda_lib.launches.clear()


@pytest.fixture
def stub_kernels(monkeypatch):
    """The wrappers run without a card: the kernel library, the device
    guard, the stream and the pointers stubbed, for fake tensors on
    ``cuda:0``."""
    import contextlib

    class StubLib:
        def __getattr__(self, symbol):
            return lambda *args: 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cuda_lib, "lib", StubLib)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda dev: None)
    monkeypatch.setattr(cuda_lib, "ptr", lambda t: None)
    monkeypatch.setattr(torch.Tensor, "contiguous", lambda t: t if t.is_contiguous() else
                        t.clone(memory_format=torch.contiguous_format))
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["rotated_iou", "nms"])
def test_iou_and_nms_count_launches_by_k(name, stub_kernels):
    """The rotated self-IoU and the NMS walk count each launch once in
    ``launches`` and once more in ``launches_by_k`` under ``<name>_k<K>``, K
    the candidates a frame of the call.  Without a card: fake tensors on
    ``cuda:0``, the kernel library stubbed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = stub_kernels
    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()
    with FakeTensorMode():
        for K in (8, 100, 100):
            if name == "rotated_iou":
                boxes_iou_bev_batched_self_cuda(torch.empty(2, K, 7, device=dev))
            else:
                greedy_nms_mask_batched_cuda(
                    torch.empty(2, K, K, device=dev),
                    torch.empty(2, K, dtype=torch.bool, device=dev), 0.1)
    assert dict(cuda_lib.launches) == {name: 3}
    assert dict(cuda_lib.launches_by_k) == {f"{name}_k8": 1, f"{name}_k100": 2}
    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()


def test_fps_counts_launches_by_points(stub_kernels):
    """FPS counts each launch once in ``launches`` and once more in
    ``launches_by_k`` under ``fps_n<N>``, N the points a frame of the call
    (PointRCNN's cloud and its RoIs' clouds).  Without a card: fake tensors
    on ``cuda:0``, the kernel library stubbed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = stub_kernels
    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()
    with FakeTensorMode():
        for B, N in ((1, 512), (64, 512), (1, 16384)):
            farthest_point_sample_cuda(torch.empty(B, N, 3, device=dev), 8)
    assert dict(cuda_lib.launches) == {"fps": 3}
    assert dict(cuda_lib.launches_by_k) == {"fps_n512": 2, "fps_n16384": 1}
    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()


def test_ball_query_counts_launches_by_site(stub_kernels):
    """The ball query counts each launch once in ``launches`` and, where its
    caller names a site, once more in ``launches_by_site`` under
    ``ball_query_<site>``; the CPU's plain version counts nothing.  Without
    a card: fake tensors on ``cuda:0``, the kernel library stubbed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = stub_kernels
    cuda_lib.launches.clear()
    cuda_lib.launches_by_site.clear()
    with FakeTensorMode():
        for site in ("x_conv1", "", "roi_grid_pool", "x_conv1"):
            ball_query_multi_cuda((0.4, 0.8), (16, 16), torch.empty(1, 64, 3, device=dev),
                                  torch.empty(1, 8, 3, device=dev), site=site)
    xyz = torch.rand(1, 64, 3)
    ball_query_multi((0.4,), (16,), xyz, xyz[:, :8], "x_conv2")  # the plain version
    assert dict(cuda_lib.launches) == {"ball_query": 4}
    assert dict(cuda_lib.launches_by_site) == {"ball_query_x_conv1": 2,
                                               "ball_query_roi_grid_pool": 1}
    cuda_lib.launches.clear()
    cuda_lib.launches_by_site.clear()

"""RoI pooling of points: counterparts of ``pdanet_tpu/ops/roi_pool.py``
(the reference's CUDA ``roiaware_pool3d``,
``roiaware_pool3d_kernel.cu:39-311``, and ``roipoint_pool3d``,
``roipoint_pool3d_kernel.cu:1-164``).

Each RoI's points are rotated into its frame and tested for being inside
it (``|z - cz| <= dz / 2`` with no margin, ``|local xy| < d / 2 + 1e-5``,
``check_pt_in_box3d``).

* ``roiaware_pool3d`` (:34-107) gives each in-box point a cell of the
  RoI's (out_x, out_y, out_z) grid (truncation toward zero, then a clip),
  and the features are pooled into the (R * cells) rows: the max by one
  ``scatter_reduce`` (a last row taking the points outside), the mean by
  sorted-segment float64 running sums (``segment_mean``, no atomics, so
  that a run gives the same bits each time; the dynamic VFEs' means too).  As in the JAX package, and
  unlike the CUDA reference, every in-box point is pooled: no cell stops
  at ``MAX_POINTS_PER_VOXEL``.  An empty max cell is 0; a mean divides by
  max(count, 1).  ``scatter_reduce``'s ``amax`` splits a tie's gradient
  evenly among the tied points, as JAX's scatter-max does; ties are common
  (the UNet's ReLU'd features).  The (R, P, C) broadcast of the features
  is the op's memory: 100 RoIs of a 40000-voxel frame at 16 channels,
  ~256 MB float32.
* ``roipoint_pool3d`` (:109-139) takes each RoI's first K in-box points
  in scan order (the ball query's first-hit ranks: a cumsum and a
  scatter), repeated cyclically when fewer (slot k takes hit k % count),
  and all zeros with the empty flag where none is inside.

The JAX package computes both in XLA, not in a Pallas kernel, and so does
the port: plain PyTorch on every device.
"""

import math

import torch

_MARGIN = 1e-5


def _local_coords(points, rois):
    """(B, P, 3) points x (B, R, 7) RoIs -> each point's (B, R, P) local x,
    y, z: frame b's points in the frame of each of its RoIs."""
    shift = points[:, None, :, :] - rois[:, :, None, 0:3]
    c = torch.cos(-rois[..., 6])[..., None]
    s = torch.sin(-rois[..., 6])[..., None]
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    return lx, ly, shift[..., 2]


def _in_box(lx, ly, lz, rois):
    dx, dy, dz = rois[..., 3:4], rois[..., 4:5], rois[..., 5:6]
    return ((lz.abs() <= dz / 2.0) & (lx.abs() < dx / 2.0 + _MARGIN)
            & (ly.abs() < dy / 2.0 + _MARGIN))


def roi_point_cells(rois, points, out_size, point_valid=None):
    """rois (B, R, 7), points (B, P, 3), out_size (out_x, out_y, out_z),
    point_valid optional (B, P) bool -> (B, R, P) int64: each frame's
    point's flat cell ``r * cells + (x * out_y + y) * out_z + z`` in each of
    its RoIs, ``B * R * cells`` where outside."""
    ox, oy, oz = (int(s) for s in out_size)
    B, R = rois.shape[:2]
    lx, ly, lz = _local_coords(points, rois)
    inside = _in_box(lx, ly, lz, rois)
    if point_valid is not None:
        inside = inside & point_valid[:, None, :]
    dx, dy, dz = rois[..., 3:4], rois[..., 4:5], rois[..., 5:6]
    # a cast truncates toward zero, as JAX's astype(int32)
    xi = ((lx + dx / 2) / (dx / ox)).to(torch.int32).clamp(0, ox - 1)
    yi = ((ly + dy / 2) / (dy / oy)).to(torch.int32).clamp(0, oy - 1)
    zi = ((lz + dz / 2) / (dz / oz)).to(torch.int32).clamp(0, oz - 1)
    n_vox = ox * oy * oz
    roi = torch.arange(B * R, device=rois.device).view(B, R, 1)
    flat = roi * n_vox + (xi * (oy * oz) + yi * oz + zi).long()
    return torch.where(inside, flat, B * R * n_vox)


def segment_mean(flat, feats, n_cells):
    """The mean of each frame's (B, N, C) ``feats`` over the rows of each
    cell ``0 .. n_cells - 1`` (``flat`` (B, N); ``n_cells`` the drop slot)
    -> (B, n_cells + 1, C), 0 where a cell holds no row, without atomics,
    so that a run gives the same bits each time (a saved program equals
    the eager closure): each frame's rows sorted by cell (stable), their
    float64 running sums (channels first: CUDA's scan along an outer axis
    of a narrow (N, C) tensor is serial, ~1 s), each row's cell sum the
    difference at its segment's ends, written to its cell by the
    segment's first row alone (so that the gradient reaches each row
    once; the others write to a spare slot past the drop slot).  Every
    shape is static."""
    B, N, C = feats.shape
    order = torch.sort(flat, dim=1, stable=True).indices
    keys = torch.gather(flat, 1, order)
    rows = torch.gather(feats, 1, order[..., None].expand(B, N, C)).to(torch.float64)
    sums = torch.cumsum(torch.cat([rows.new_zeros((B, C, 1)), rows.transpose(1, 2)], dim=2),
                        dim=2)
    start = torch.searchsorted(keys, keys)
    end = torch.searchsorted(keys, keys, right=True)
    gather = lambda at: torch.gather(sums, 2, at[:, None, :].expand(B, C, N))  # noqa: E731
    count = (end - start).to(torch.float64)[:, None, :]
    mean = ((gather(end) - gather(start)) / count).transpose(1, 2).to(feats.dtype)
    first = start == torch.arange(N, device=flat.device)
    batch = torch.arange(B, device=flat.device)[:, None].expand(B, N)
    canvas = feats.new_zeros((B, n_cells + 2, C))
    return canvas.index_put((batch, torch.where(first, keys, n_cells + 1)), mean)[:, :-1]


def roiaware_pool3d(rois, points, point_features, out_size, pool_method="max",
                    point_valid=None):
    """rois (B, R, 7) [cx cy cz dx dy dz ry], points (B, P, 3),
    point_features (B, P, C), out_size (out_x, out_y, out_z), point_valid
    optional (B, P) bool -> pooled (B, R, out_x, out_y, out_z, C), each
    frame's RoIs over its own points (the JAX function ``vmap``-ed over
    the frames), ``pool_method`` "max" or "avg"."""
    B, R = rois.shape[:2]
    C = point_features.shape[-1]
    rows = B * R * math.prod(int(s) for s in out_size)
    flat = roi_point_cells(rois, points, out_size, point_valid).reshape(-1, 1).expand(-1, C)
    feats = point_features[:, None].expand(B, R, -1, -1).reshape(-1, C)
    if pool_method == "max":
        pooled = point_features.new_full((rows + 1, C), -torch.inf)
        pooled = pooled.scatter_reduce(0, flat, feats, "amax", include_self=True)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    elif pool_method == "avg":
        pooled = segment_mean(flat[None, :, 0], feats[None], rows)[0]
    else:
        raise NotImplementedError(pool_method)
    return pooled[:rows].reshape(B, R, *(int(s) for s in out_size), C)


def roipoint_pool3d(rois, points, point_features, num_sampled_points=512):
    """rois (B, R, 7), points (B, P, 3), point_features (B, P, C) ->
    pooled (B, R, K, 3 + C) ``[xyz | features]`` of each RoI's first K =
    ``num_sampled_points`` in-box points of its frame in scan order,
    cycled when fewer, zeros where none is inside; and the (B, R) bool
    empty flags.  Differentiable in the points and features."""
    K = int(num_sampled_points)
    B, R = rois.shape[:2]
    P = points.shape[1]
    inside = _in_box(*_local_coords(points, rois), rois)  # (B, R, P)
    rank = torch.cumsum(inside, dim=-1)  # 1-based rank of each hit
    slot = torch.where(inside & (rank <= K), rank - 1, K)  # slot K: discard
    first = torch.zeros((B, R, K + 1), dtype=torch.int64, device=rois.device)
    first.scatter_(2, slot, torch.arange(P, device=rois.device).expand(B, R, P))
    count = rank[..., -1:]  # (B, R, 1)
    k = torch.arange(K, device=rois.device)
    pos = torch.gather(first, 2, torch.where(k < count, k, k % count.clamp(min=1)))
    src = torch.cat([points, point_features], dim=-1)  # (B, P, 3 + C)
    # rows of the flattened frames: the gradient is an index_add into (B * P,
    # 3 + C), not into an (R, P) broadcast
    rows = (pos + (torch.arange(B, device=rois.device) * P).view(B, 1, 1)).reshape(-1)
    pooled = src.reshape(B * P, -1).index_select(0, rows).reshape(B, R, K, -1)
    empty = count[..., 0] == 0
    return torch.where(empty[..., None, None], 0.0, pooled), empty

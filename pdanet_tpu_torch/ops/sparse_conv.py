"""Gather-matmul sparse 3-D convolution: counterpart of
``pdanet_tpu/ops/sparse_conv.py`` (spconv's submanifold and strided sparse
convs, ``pcdet/models/backbones_3d/spconv_backbone.py``).

Every shape is static, as in the JAX package, so ``torch.export`` traces
the whole path (no ``unique`` or ``nonzero``):

* Active sites are (B, V, 3) zyx coordinate lists, -1 padded.  A
  neighbour is found by binary search: the flat scan keys of a level are
  sorted once (stable), and each of the 27 taps of every query resolves
  with one ``searchsorted`` (left) over them.  With a duplicated cell the
  first of the equal keys in the stable order wins, as in JAX.  The
  inverse conv's table (``build_inverse_neighbor_table``, the sparse
  UNet's decoder) looks its taps up the same way.
* The convolution is one flat row gather of the (B * V, C_in) table and
  one (B * Q, 27 * C_in) x (27 * C_in, C_out) product.  An absent tap reads
  a zero row past the table, one such row a query, which takes the
  gradient nobody reads: the gather's backward is an atomic
  ``index_add``, and one zero row for every absent tap would serialize
  millions of atomic adds on it.
* A strided conv's output sites (``downsample_coords``) are spconv's
  exact active sets (``dilate=True``) or the centre-tap sites only
  (``dilate=False``), sorted, deduplicated by neighbour difference and
  compacted into ``out_budget`` slots, keeping the first in scan order.

None of this is a Pallas kernel in the JAX package: the gather is plain
indexing here and the product ``torch.matmul``, in the promoted dtype of
the features and the kernel (float64 stays float64).  Index tensors are
int32 where the JAX package's are.
"""

import torch

INVALID = 2 ** 30  # the flat key of an absent or out-of-grid site
_BIG = 1 << 22  # z stride of the dedup key on a virtual (2048 x 2048 x 256) grid


def stage_grids(grid_size):
    """The reference backbone's 4-level stage-grid chain (JAX :41-60):
    ``sparse_shape`` carries an empty top z plane (+1); conv2 and conv3
    downsample with pad 1; conv4 pads z by 0 (``z4 = (z3 - 1) // 2``),
    with a pad-1 fallback for tiny test grids (z3 < 3).

    Returns ``(grids, conv4_pad)``: ``grids`` the (nx, ny, nz) of strides
    1, 2, 4 and 8, ``conv4_pad`` (0, 1, 1) zyx, or None for the fallback."""
    nx, ny, nz = (int(g) for g in grid_size)
    g0 = (nx, ny, nz + 1)
    g1 = tuple((d + 1) // 2 for d in g0)
    g2 = tuple((d + 1) // 2 for d in g1)
    z4_ref = g2[2] >= 3
    z4 = (g2[2] - 1) // 2 if z4_ref else (g2[2] + 1) // 2
    g3 = ((g2[0] + 1) // 2, (g2[1] + 1) // 2, max(z4, 1))
    return [g0, g1, g2, g3], ((0, 1, 1) if z4_ref else None)


def _flat_key(coords, grid_size):
    """(..., 3) zyx int32 -> (flat scan key, in the grid); a negative or
    out-of-grid site gets ``INVALID``."""
    nx, ny, nz = (int(g) for g in grid_size)
    z, y, x = coords.unbind(-1)
    valid = (coords >= 0).all(dim=-1) & (z < nz) & (y < ny) & (x < nx)
    key = z * (ny * nx) + y * nx + x
    return torch.where(valid, key, INVALID), valid


def _kernel_offsets(kernel, padding, device):
    """(K, 3) zyx int32 tap offsets in scan order, shifted by
    ``k // 2 - pad`` on an axis whose padding is below ``k // 2``."""
    shift = [0, 0, 0] if padding is None else [
        int(k) // 2 - int(p) for k, p in zip(kernel, padding)]
    kz, ky, kx = (int(k) for k in kernel)
    offs = [(dz - kz // 2 + shift[0], dy - ky // 2 + shift[1], dx - kx // 2 + shift[2])
            for dz in range(kz) for dy in range(ky) for dx in range(kx)]
    return torch.tensor(offs, dtype=torch.int32, device=device)


def _lookup(coords, grid_size, nbr):
    """The support slot at each of the (B, Q, K, 3) zyx sites ``nbr``: the
    flat scan keys of ``coords`` (B, V, 3) sorted once (stable), one
    ``searchsorted`` (left) for every site.  Returns ``(slots, ok)``: the
    (B, Q, K) slot (undefined where absent), and where the site lies in
    the grid and holds an active one."""
    B, V, _ = coords.shape
    keys, _ = _flat_key(coords, grid_size)
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    nbr_keys, nbr_ok = _flat_key(nbr, grid_size)
    flat = nbr_keys.reshape(B, -1)
    pos = torch.searchsorted(sorted_keys, flat).clamp(0, V - 1)
    found = (torch.gather(sorted_keys, 1, pos) == flat).reshape(nbr_keys.shape)
    slots = torch.gather(order, 1, pos).reshape(nbr_keys.shape)
    return slots, found & nbr_ok & (nbr_keys != INVALID)


def build_neighbor_table(coords, grid_size, kernel=(3, 3, 3), query_coords=None,
                         stride=(1, 1, 1), padding=None):
    """Per-query neighbour slots (JAX :90-138).

    coords: (B, V, 3) zyx int32 support sites (-1 padded) on a grid of
    ``grid_size`` (nx, ny, nz).  query_coords: optional (B, Q, 3) sites on
    the output lattice, whose taps sit at ``query * stride + offset``
    (a strided conv); by default the support itself at stride 1
    (submanifold).  padding: per-axis zyx conv padding, default k // 2.
    Returns (B, Q, K) int32 slots into the support axis, -1 where absent."""
    offs = _kernel_offsets(kernel, padding, coords.device)
    if query_coords is None:
        query_coords = coords
    q_valid = (query_coords >= 0).all(dim=-1)
    st = torch.tensor([int(s) for s in stride], dtype=torch.int32, device=coords.device)
    nbr = (query_coords * st)[:, :, None, :] + offs  # (B, Q, K, 3)
    slots, ok = _lookup(coords, grid_size, nbr)
    return torch.where(ok & q_valid[:, :, None], slots, -1).to(torch.int32)


def build_inverse_neighbor_table(coords, grid_size, query_coords, kernel=(3, 3, 3),
                                 stride=(2, 2, 2), padding=None):
    """The transposed (inverse) conv's table, spconv's SparseInverseConv3d
    (JAX :174-226): for each fine-lattice query site q (the active set the
    strided conv being inverted consumed), the coarse support slot d whose
    forward taps covered it, ``d * stride + offset == q``, where the
    division ``(q - offset) / stride`` is exact.

    coords: (B, V, 3) zyx coarse support sites (-1 padded) on the coarse
    ``grid_size``; query_coords: (B, Q, 3) fine sites (-1 padded); padding:
    the forward conv's (default k // 2), whose shifted taps are replayed
    (conv4's z padding 0).  The remainder and quotient are floor ones, as
    JAX's ``%`` and ``//``: a negative ``q - offset`` is off the lattice
    or out of the grid, never a site.  Returns (B, Q, K) int32 slots into
    the coarse support axis, -1 where absent."""
    offs = _kernel_offsets(kernel, padding, coords.device)
    q_valid = (query_coords >= 0).all(dim=-1)
    st = torch.tensor([int(s) for s in stride], dtype=torch.int32, device=coords.device)
    t = query_coords[:, :, None, :] - offs  # (B, Q, K, 3)
    exact = (torch.remainder(t, st) == 0).all(dim=-1)
    slots, ok = _lookup(coords, grid_size, torch.div(t, st, rounding_mode="floor"))
    return torch.where(ok & exact & q_valid[:, :, None], slots, -1).to(torch.int32)


def gather_matmul_conv(features, nbr_idx, weight):
    """The sparse conv (JAX :141-171): features (B, V, C_in) (padding rows
    zero), nbr_idx (B, Q, K) slots (-1 absent), weight (K, C_in, C_out)
    -> (B, Q, C_out) in the promoted dtype of features and weight.

    A slot is clipped to [0, V - 1] (a stray one must not read another
    frame's rows) and an absent tap of query q reads zero row q of the
    (B * Q, C_in) zeros appended past the flat table, which is the JAX
    package's ``where(nbr >= 0, g, 0)``."""
    B, V, C = features.shape
    _, Q, K = nbr_idx.shape
    dt = torch.promote_types(features.dtype, weight.dtype)
    table = torch.cat([features.reshape(B * V, C).to(dt),
                       features.new_zeros((B * Q, C), dtype=dt)])
    dev = nbr_idx.device
    base = (torch.arange(B, device=dev) * V)[:, None, None]
    zero = B * V + torch.arange(B * Q, device=dev).reshape(B, Q, 1)
    rows = torch.where(nbr_idx >= 0, nbr_idx.long().clamp(0, V - 1) + base, zero)
    g = torch.index_select(table, 0, rows.reshape(-1)).reshape(B, Q, K * C)
    return torch.matmul(g, weight.to(dt).reshape(K * C, -1))


def downsample_coords(coords, out_budget, stride=(2, 2, 2), out_grid=None, dilate=False,
                      kernel=(3, 3, 3), padding=None):
    """A strided conv's output active set (JAX :229-323): (B, out_budget, 3)
    zyx int32, -1 padded, the first ``out_budget`` distinct sites in scan
    order.

    ``dilate=False``: the centre-tap site ``coords // stride`` of each
    input, clamped into ``out_grid`` (zyx) when given.  ``dilate=True``
    (spconv's SparseConv3d): every output site whose tap window
    ``[o * s - p, o * s - p + k - 1]`` holds an active input, per axis
    ``(i + p) // s`` or the site below it, within ``out_grid``."""
    B, V, _ = coords.shape
    dev = coords.device
    valid = (coords >= 0).all(dim=-1)
    st = torch.tensor([int(s) for s in stride], dtype=torch.int32, device=dev)
    if dilate:
        if padding is None:
            padding = tuple(int(k) // 2 for k in kernel)
        p = torch.tensor([int(x) for x in padding], dtype=torch.int32, device=dev)
        kk = torch.tensor([int(x) for x in kernel], dtype=torch.int32, device=dev)
        hi = torch.div(coords + p, st, rounding_mode="floor")  # (B, V, 3)
        # the 8 choices of hi or hi - 1 per axis
        below = torch.tensor([[1 - ((c >> a) & 1) for a in range(3)] for c in range(8)],
                             dtype=torch.int32, device=dev)
        cand = hi[:, :, None, :] - below  # (B, V, 8, 3)
        start = cand * st - p
        inside = coords[:, :, None, :]
        ok = ((start <= inside) & (inside <= start + kk - 1) & (cand >= 0)).all(dim=-1)
        if out_grid is not None:
            og = torch.tensor([int(g) for g in out_grid], dtype=torch.int32, device=dev)
            ok &= (cand < og).all(dim=-1)
        ok &= valid[:, :, None]
        half = torch.where(ok[..., None], cand, -1).reshape(B, V * 8, 3)
        valid = ok.reshape(B, V * 8)
    else:
        half = torch.div(coords, st, rounding_mode="floor")
        if out_grid is not None:
            og = torch.tensor([int(g) for g in out_grid], dtype=torch.int32, device=dev)
            half = torch.minimum(half, og - 1)
        half = torch.where(valid[..., None], half, -1)
    key = torch.where(valid, half[..., 0] * _BIG + half[..., 1] * 2048 + half[..., 2], INVALID)
    skey = torch.sort(key, dim=-1).values
    first = torch.cat([torch.ones_like(skey[:, :1], dtype=torch.bool),
                       skey[:, 1:] != skey[:, :-1]], dim=-1) & (skey != INVALID)
    rank = torch.cumsum(first, dim=-1) - 1
    # the kept keys land on their rank; the rest on one slot past the budget
    dst = torch.where(first & (rank < out_budget), rank, out_budget)
    ukeys = torch.full((B, out_budget + 1), INVALID, dtype=skey.dtype, device=dev)
    ukeys = ukeys.scatter(1, dst, skey)[:, :out_budget]
    ok = ukeys != INVALID
    rem = ukeys % _BIG
    z = torch.where(ok, ukeys // _BIG, -1)
    y = torch.where(ok, rem // 2048, -1)
    x = torch.where(ok, rem % 2048, -1)
    return torch.stack([z, y, x], dim=-1).to(torch.int32)

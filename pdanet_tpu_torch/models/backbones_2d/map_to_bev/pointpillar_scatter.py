"""Pillar scatter: counterpart of ``pdanet_tpu/models/backbones_2d/
map_to_bev/pointpillar_scatter.py``: each pillar's feature vector goes to
its (y, x) cell of a channels-last (B, ny, nx, C) BEV map."""

import torch


def pointpillar_scatter(pillar_features, voxel_coords, grid_size):
    """pillar_features (B, V, C); voxel_coords (B, V, 3) zyx, -1 for a
    padded slot.  Returns the map (B, ny, nx, C), zero where no pillar is.

    One ``index_put`` over the flattened map, at static shapes: a padded
    slot writes a zero row into one extra row past the map, which is cut
    off, so it neither lands on the map nor takes a gradient (the JAX
    package's scatter with ``mode="drop"``)."""
    B, V, C = pillar_features.shape
    nx, ny, nz = (int(g) for g in grid_size)
    if nz != 1:
        raise ValueError(f"pointpillar_scatter: a pillar grid has nz 1, got {nz}")
    valid = voxel_coords[..., 0] >= 0
    cells = B * ny * nx
    batch = torch.arange(B, device=voxel_coords.device)[:, None]
    flat = (batch * ny + voxel_coords[..., 1].long()) * nx + voxel_coords[..., 2].long()
    flat = torch.where(valid, flat, cells)
    feats = torch.where(valid[..., None], pillar_features, 0.0)
    canvas = pillar_features.new_zeros((cells + 1, C))
    canvas = canvas.index_put((flat.reshape(-1),), feats.reshape(-1, C))
    return canvas[:cells].view(B, ny, nx, C)

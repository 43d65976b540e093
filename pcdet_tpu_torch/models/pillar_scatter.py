"""Scatter pillar features to a dense BEV canvas.

Twin of `pcdet_tpu.models.pillar_scatter`.  One index_put over the whole
batch into a flat (B * ny * nx + 1, C) buffer whose last row takes the
padding voxels (JAX's mode='drop'); the canvas is the buffer without that
row, so it is contiguous NHWC and `.permute(0, 3, 1, 2)` of it is a
channels-last NCHW view with no copy.
"""
import torch


def pillar_scatter(features, coords, voxel_mask, ny, nx):
    """
    :param features: (B, V, C)
    :param coords: (B, V, 3) int32 ZYX (-1 for padding)
    :param voxel_mask: (B, V) bool
    :return: (B, ny, nx, C) canvas (NHWC)
    """
    b, v, c = features.shape
    cells = ny * nx
    base = torch.arange(b, device=features.device)[:, None] * cells
    flat = base + coords[..., 1].long() * nx + coords[..., 2].long()
    flat = torch.where(voxel_mask, flat, b * cells)               # drop row
    canvas = torch.zeros((b * cells + 1, c), dtype=features.dtype,
                         device=features.device)
    canvas[flat.reshape(-1)] = features.reshape(b * v, c)
    return canvas[:b * cells].view(b, ny, nx, c)

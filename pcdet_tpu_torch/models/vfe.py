"""Voxel feature extractors (eval) on tensors.

Twins of `pcdet_tpu.models.vfe.MeanVFE`, `PFNLayer` and `PillarFeatureNet`,
with the reference's parameter names (`pfn_layers.{i}.linear`, `.norm`).
Inputs are the voxelizer's fixed-shape batch:
  voxels      (B, V, P, C)  P = max points per voxel, zero padded
  num_points  (B, V) int32
  coords      (B, V, 3) int32 ZYX (-1 rows = padding voxels)
  voxel_mask  (B, V) bool
"""
import torch
import torch.nn as nn

from .layers import BatchNorm, TorchLinear


class MeanVFE(nn.Module):
    """Mean of the points of each voxel; zero on padding voxels."""

    def forward(self, voxels, num_points, coords, voxel_mask):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mean = voxels.sum(dim=2) / denom
        return mean * voxel_mask[..., None].to(voxels.dtype)     # (B, V, C)


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU -> max over points."""

    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=True):
        super().__init__()
        self.last_layer = last_layer
        self.use_norm = use_norm
        units = out_channels if last_layer else out_channels // 2
        self.linear = TorchLinear(in_channels, units, bias=not use_norm)
        if use_norm:
            self.norm = BatchNorm(units)

    def forward(self, x):
        x = self.linear(x)                                    # (B, V, P, U)
        if self.last_layer:
            # Eval BN is a per-channel monotone affine and ReLU is monotone,
            # so the max over points commutes onto the point-reduced tensor:
            #   max_p relu(bn(h_p)) == relu(max(bn(max_p h), bn(min_p h)))
            # (the winning branch is bn of the selected extremum: the same
            # float ops as the stock path, on 1/P of the bytes).
            hmax = torch.amax(x, dim=2)
            if not self.use_norm:
                return torch.relu(hmax)
            hmin = torch.amin(x, dim=2)
            return torch.relu(torch.maximum(self.norm(hmax), self.norm(hmin)))
        if self.use_norm:
            x = self.norm(x)
        x = torch.relu(x)
        x_max = torch.amax(x, dim=2, keepdim=True)
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarFeatureNet(nn.Module):
    """PillarFeatureNetOld2: decorate points with cluster and center offsets,
    mask padding, run the PFN layers."""

    def __init__(self, num_input_features=4, num_filters=(64,), use_norm=True,
                 with_distance=False, voxel_size=(0.16, 0.16, 4.0),
                 pc_range=(0, -39.68, -3, 69.12, 39.68, 1)):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        c_in = num_input_features + 6 + (1 if with_distance else 0)
        layers = []
        for i, nf in enumerate(num_filters):
            last = i == len(num_filters) - 1
            layers.append(PFNLayer(c_in, nf, use_norm, last_layer=last))
            c_in = nf
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, voxels, num_points, coords, voxel_mask):
        dtype = voxels.dtype
        vx, vy, vz = self.voxel_size
        x_off = vx / 2 + self.pc_range[0]
        y_off = vy / 2 + self.pc_range[1]
        z_off = vz / 2 + self.pc_range[2]

        nv = torch.clamp(num_points, min=1).to(dtype)[..., None, None]
        points_mean = voxels[..., :3].sum(dim=2, keepdim=True) / nv
        f_cluster = voxels[..., :3] - points_mean

        cz = coords[..., 0:1].to(dtype) * vz + z_off
        cy = coords[..., 1:2].to(dtype) * vy + y_off
        cx = coords[..., 2:3].to(dtype) * vx + x_off
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy,
                                voxels[..., 2] - cz], dim=-1)

        feats = [voxels, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                           keepdim=True))
        features = torch.cat(feats, dim=-1)

        # zero out padded point slots and padding voxels
        p = voxels.shape[2]
        slot_ids = torch.arange(p, dtype=torch.int32, device=voxels.device)
        pt_mask = (slot_ids[None, None, :] < num_points[..., None]) \
            & voxel_mask[..., None]
        features = features * pt_mask[..., None].to(dtype)

        for layer in self.pfn_layers:
            features = layer(features)
        return features * voxel_mask[..., None].to(dtype)      # (B, V, C_out)

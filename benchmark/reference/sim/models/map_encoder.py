"""Per-polyline map encoder (port of ``ctrl_sim_tpu/models/map_encoder.py``;
reference modules/map_encoder.py:7-54): an MLP over (x, y, valid) road
points pooled by single-query attention with a learned seed, fused with a
road-type embedding — one token per polyline, plus a validity mask."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.models.layers import LayerNorm, MLPLayer, MultiHeadAttention

Tensor = torch.Tensor


class MapEncoder(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        mc = cfg.model
        H = mc.hidden_dim
        self.map_attr = mc.map_attr
        self.compute_dtype = dtype
        self.road_pts_encoder = MLPLayer(mc.map_attr, H, H, dtype, device)
        self.map_seeds = nn.Parameter(torch.zeros(1, 1, H, device=device))
        self.road_pts_attn_layer = MultiHeadAttention(H, mc.num_heads, dtype, dropout=mc.dropout, device=device)
        self.norm1 = LayerNorm(H, dtype, device)
        self.map_feats = MLPLayer(H, H, H, dtype, device)
        self.norm2 = LayerNorm(H, dtype, device)
        self.road_type_encoder = MLPLayer(mc.num_road_types, H, H, dtype, device)
        self.road_road_type_encoder = MLPLayer(2 * H, H, H, dtype, device)

    def forward(self, road_points: Tensor, road_types: Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> tuple[Tensor, Tensor]:
        """road_points [B, P, L, 3], road_types [B, P, 8] ->
        (polyline tokens [B, P, H], valid mask [B, P]); dropout on the
        pooling attention's weights unless ``deterministic``."""
        B, P, L, _ = road_points.shape
        dt = self.compute_dtype
        # a polyline is valid iff any point is; fully empty rows get point 0
        # unmasked so the pooling softmax stays finite (map_encoder.py:28-32)
        point_valid = road_points[..., -1] > 0.0
        segment_valid = point_valid.any(dim=-1)
        point_valid = point_valid.clone()
        point_valid[..., 0] |= ~segment_valid

        pts = self.road_pts_encoder(road_points[..., : self.map_attr].to(dt))
        H = pts.shape[-1]
        pts = pts.reshape(B * P, L, H)
        seed = self.map_seeds.to(dt).expand(B * P, 1, H)
        pooled = self.road_pts_attn_layer(
            seed, pts, pts, key_padding_mask=point_valid.reshape(B * P, L),
            deterministic=deterministic, generator=generator,
        )
        pooled = self.norm1(pooled)
        pooled = self.norm2(pooled + self.map_feats(pooled))
        type_feat = self.road_type_encoder(road_types.to(dt)).reshape(B * P, 1, H)
        fused = self.road_road_type_encoder(torch.cat([pooled, type_feat], dim=-1))
        return fused.reshape(B, P, H), segment_valid

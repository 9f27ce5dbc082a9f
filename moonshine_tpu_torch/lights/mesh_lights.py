"""Emissive-mesh (area light) sampling (port of
moonshine_tpu/lights/mesh_lights.py; parity: light.hlsl:105-158)."""

from __future__ import annotations

import torch

from ..core import alias_table
from ..core.mappings import square_to_triangle
from ..core.mathutil import cross, dot, safe_normalize


def area_to_solid_angle(pos1, pos2, dir1, dir2):
    """r^2 / cos factor from area to solid-angle pdf (light.hlsl:105-110).
    dir1: shading -> light, dir2: light normal."""
    diff = pos1 - pos2
    r2 = dot(diff, diff, keepdims=False)
    light_cos = dot(-dir1, dir2, keepdims=False)
    return torch.where(light_cos > 0.0,
                       r2 / torch.clamp_min(light_cos, 1e-20),
                       torch.zeros_like(r2))


def sample_mesh_lights(scene, position_ws, rand2):
    """One emissive-triangle sample per lane.

    Returns (dir_ws [N,3], light_pos [N,3], light_normal [N,3],
    tri_id [N] i64, bary [N,2], pdf [N], light_row [N,25]); pdf is 0 when
    the scene has no emitters (light.hlsl:134-136)."""
    em = scene.emitters
    count = max(em.count, 1)
    slot, rx = alias_table.sample(em.select, em.alias, count, rand2[..., 0])
    light_row = em.rows[torch.clamp(slot, 0, em.rows.shape[0] - 1)]
    tri_id = light_row[:, 22].to(torch.int64)

    bary = square_to_triangle(torch.stack([rx, rand2[..., 1]], dim=-1))
    corners = light_row[:, 0:9].reshape(-1, 3, 3)
    b0 = (1.0 - bary[..., 0] - bary[..., 1])[..., None]
    b1 = bary[..., 0][..., None]
    b2 = bary[..., 1][..., None]
    light_pos = b0 * corners[:, 0] + b1 * corners[:, 1] + b2 * corners[:, 2]

    gn = safe_normalize(cross(corners[:, 0] - corners[:, 2],
                              corners[:, 1] - corners[:, 2]))
    dir_ws = safe_normalize(light_pos - position_ws)
    pdf = area_to_solid_angle(light_pos, position_ws, dir_ws, gn) / max(
        em.weight_sum, 1e-20)
    if em.count == 0:
        pdf = torch.zeros_like(pdf)
    return dir_ws, light_pos, gn, tri_id, bary, pdf, light_row

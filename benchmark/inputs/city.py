"""A seeded synthetic city on the run's device: the arithmetic of the
port's ``utils/synth.py`` (terrain, building blocks, a water band,
stereo-like noise worse at walls, hillshaded ortho views), drawn from a
``torch.Generator`` on the device so that a 4096² scene takes a fraction
of a second rather than the host's 8 s. The same seed gives the same
scene on the same device type; it is not the host generator's scene."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GSD = 0.25
NODATA = -9999.0


def _wall_band(building: torch.Tensor) -> torch.Tensor:
    """Pixels within two 4-connected steps of a building and outside it:
    scipy's ``binary_dilation(iterations=2) ^ mask``, as one 5x5 diamond."""
    r = torch.arange(-2, 3, device=building.device)
    diamond = ((r[:, None].abs() + r[None, :].abs()) <= 2).float()[None, None]
    near = F.conv2d(building.float()[None, None], diamond, padding=2)[0, 0] > 0.5
    return near & ~building


def hillshade(dsm: torch.Tensor, azimuth_deg: float) -> torch.Tensor:
    """Pseudo ortho view: Lambertian hillshade of the surface."""
    gy, gx = torch.gradient(dsm, spacing=GSD)
    azimuth = math.radians(azimuth_deg)
    altitude = math.radians(45.0)
    slope = torch.atan(torch.hypot(gx, gy))
    aspect = torch.atan2(-gx, gy)
    shade = (math.sin(altitude) * torch.cos(slope)
             + math.cos(altitude) * torch.sin(slope) * torch.cos(azimuth - aspect))
    return 80.0 + 120.0 * shade.clamp(0, 1)


def synth_city(rows: int, cols: int, seed: int, device) -> dict:
    """``gt``, ``dsm`` (float32 heights in m), ``building`` and ``water``
    (bool masks) and ``orthos`` (2, rows, cols) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(rows, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(cols, device=device, dtype=torch.float32)[None, :]
    terrain = (420.0 + 6.0 * torch.sin(yy / 60.0) + 5.0 * torch.cos(xx / 45.0)
               + 2.0 * torch.sin((xx + yy) / 90.0))
    gt = terrain.clone()
    building = torch.zeros((rows, cols), dtype=torch.bool, device=device)
    n = rows * cols // 4000
    draws = torch.rand((n, 5), generator=g, device=device, dtype=torch.float64)
    height = 6.0 + 19.0 * draws[:, 0]
    by = (draws[:, 1] * (rows - 24)).long()
    bx = (draws[:, 2] * (cols - 24)).long()
    bh = 8 + (draws[:, 3] * 16).long()
    bw = 8 + (draws[:, 4] * 16).long()
    # Each block's level: the mean terrain under it (a summed-area table),
    # plus its height; later blocks paint over earlier ones.
    sat = F.pad(terrain.double().cumsum(0).cumsum(1), (1, 0, 1, 0))
    y1, x1 = by + bh, bx + bw
    level = ((sat[y1, x1] - sat[by, x1] - sat[y1, bx] + sat[by, bx])
             / (bh * bw) + height).float()
    for i, (a, b, c, d) in enumerate(torch.stack([by, y1, bx, x1], 1).tolist()):
        gt[a:b, c:d] = level[i]
        building[a:b, c:d] = True
    water = torch.zeros_like(building)
    water[rows // 2 - 6:rows // 2 + 6] = True
    gt[water] = terrain[water].min() - 1.0
    building &= ~water
    noise = 0.7 * torch.randn((rows, cols), generator=g, device=device)
    wall = _wall_band(building)
    noise += torch.where(wall, 3.0 * torch.randn((rows, cols), generator=g,
                                                 device=device), 0.0)
    orthos = torch.stack([hillshade(gt, azimuth) for azimuth in (315, 135)])
    return {"gt": gt, "dsm": gt + noise, "building": building, "water": water,
            "orthos": orthos}

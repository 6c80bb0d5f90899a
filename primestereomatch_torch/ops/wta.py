"""Winner-takes-all disparity selection (src/DispSel.cpp:83-109): argmin
over d = 1 .. maxDis-1 (disparity 0 is never selected), ties to the lowest
disparity. Output is uint8."""

from __future__ import annotations

import torch


def wta_disparity(cost_volume: torch.Tensor) -> torch.Tensor:
    """(D, H, W) costs -> (H, W) uint8 disparities, d in [1, D)."""
    return (torch.argmin(cost_volume[1:], dim=0) + 1).to(torch.uint8)

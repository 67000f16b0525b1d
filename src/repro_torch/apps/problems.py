"""Random problem generators (twin of ``repro/apps/problems.py``).

Inputs come from a numpy ``default_rng(seed)`` on the host and move to
``device`` (``None``: the card), so the tests can hand the same arrays
to both packages. The distributions are ``repro``'s; the numbers are
not, since ``jax.random`` draws differently.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import compat


def _temp_power(seed: int, shape, device):
    """Temperature uniform in [70, 80), power uniform in [0, 0.1)."""
    device = compat.resolve_device(device)
    rng = np.random.default_rng(seed)
    temp = 70.0 + 10.0 * rng.random(shape, dtype=np.float32)
    power = 0.1 * rng.random(shape, dtype=np.float32)
    return (torch.from_numpy(temp.astype(np.float32)).to(device),
            torch.from_numpy(power.astype(np.float32)).to(device))


def hotspot(seed: int, h: int, w: int, device=None):
    """Rodinia Hotspot: (temperature, power) grids at hotspot.c's scale:
    temperature uniform in [70, 80), power uniform in [0, 0.1)."""
    return _temp_power(seed, (h, w), device)


def hotspot3d(seed: int, d: int, h: int, w: int, device=None):
    """Rodinia Hotspot3D: (temperature, power) volumes, with Hotspot's
    distributions."""
    return _temp_power(seed, (d, h, w), device)

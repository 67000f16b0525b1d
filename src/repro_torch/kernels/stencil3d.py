"""3D stencil plugin for the engine (twin of ``repro/kernels/stencil3d.py``).

Contributes:

  * ``_apply_3d(window, spec) -> plane``: one IR time step of a star or
    box spec at the center plane of a ``[2r+1, rows, cols]`` plane
    window. z taps read the window's planes directly (the engine owns
    the z boundary); in-plane taps use ``core.stencil.shift`` with the
    spec's boundary mode, which at the window's rim only shapes cells
    the engine crops or refills.
  * ``apply_3d_grid(p, spec)``: the same step at every cell of a
    ``[D, H, W]`` volume, z taps as shifts along axis 0 (the engine's
    plain version runs it on a volume padded and filled by ``r``).
  * ``taps_3d(spec)``: the same taps as a ``(dz, dy, dx, w)`` list in the
    order both add them (center first, then the z taps for o = -r..r,
    then y, then x, zero weights skipped; box taps in
    ``ref._box_offsets`` order). The CUDA kernel sums them in this
    order, so its float sums associate as the plain version's do.
  * ``stencil3d(...)``: a thin wrapper over ``engine.stencil_call``.
"""
from __future__ import annotations

import torch

from repro_torch.core.stencil import StencilSpec, shift, shift_nd
from repro_torch.kernels import engine
from repro_torch.kernels.ref import _box_offsets, f32


def apply_3d_grid(p: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One IR step of a 3D star or box spec at every cell of ``p``."""
    if spec.layout == "box":
        acc = torch.zeros_like(p)
        for offsets, w in _box_offsets(spec):
            acc = acc + f32(w) * shift_nd(p, offsets, spec.boundary)
        return acc
    r = spec.radius
    w = spec.weights
    acc = f32(spec.center) * p
    for a in range(3):
        for o in range(-r, r + 1):
            c = float(w[a, r + o])
            if o == 0 or c == 0.0:
                continue
            acc = acc + f32(c) * shift(p, a, o, spec.boundary)
    return acc


def _apply_3d(window: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One IR step at the center plane of a [2r+1, rows, cols] window
    (planes z-r .. z+r of the producer field)."""
    return apply_3d_grid(window, spec)[spec.radius]


def taps_3d(spec: StencilSpec) -> list[tuple[int, int, int, float]]:
    """``(dz, dy, dx, w)`` taps of a star or box 3D spec, in plugin order.

    A star's center tap comes first even when its weight is 0, as
    ``_apply_3d`` starts from ``center * plane``.
    """
    if spec.dims != 3 or spec.layout == "custom":
        raise ValueError("taps_3d needs a 3D star or box spec")
    if spec.layout == "box":
        return [(dz, dy, dx, f32(w))
                for (dz, dy, dx), w in _box_offsets(spec)]
    r = spec.radius
    w = spec.weights
    taps = [(0, 0, 0, f32(spec.center))]
    for a in range(3):
        for o in range(-r, r + 1):
            c = float(w[a, r + o])
            if o == 0 or c == 0.0:
                continue
            off = [0, 0, 0]
            off[a] = o
            taps.append((*off, c))
    return taps


def stencil3d(x: torch.Tensor, spec: StencilSpec, bx: int = 128,
              bt: int = 1, variant: str = "revolving",
              source: torch.Tensor | None = None, aux=None,
              scalars: torch.Tensor | None = None, valid_lo=None,
              valid_hi=None) -> torch.Tensor:
    """Run ``bt`` fused time steps of ``spec`` over a [D, H, W] grid."""
    if x.ndim not in (3, 4) or spec.dims != 3:
        raise ValueError("stencil3d needs a 3D grid (or a [B, D, H, W] "
                         "batch) and a 3D spec")
    return engine.stencil_call(x, spec, bx=bx, bt=bt, variant=variant,
                               source=source, aux=aux, scalars=scalars,
                               valid_lo=valid_lo, valid_hi=valid_hi)

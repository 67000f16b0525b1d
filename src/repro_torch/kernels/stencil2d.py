"""2D stencil plugin for the engine (twin of ``repro/kernels/stencil2d.py``).

Contributes:

  * ``_apply_2d(win, spec) -> win``: one IR time step of a star or box
    spec on a ``[rows, cols]`` window (custom updates come with the
    multi-sweep programs). Neighbor reads use ``core.stencil.shift`` with the
    spec's boundary mode; at the window's rim that only shapes cells
    the engine crops or refills, because the engine fills true-grid-edge
    cells before every step.
  * ``taps_2d(spec)``: the same star/box taps as a ``(dy, dx, w)`` list
    in the order ``_apply_2d`` adds them (center first, then axis 0 for
    o = -r..r, then axis 1, zero weights skipped; box taps in
    ``ref._box_offsets`` order). The CUDA kernel sums them in this
    order, so its float sums associate as the plain version's do.
  * ``stencil2d(...)``: a thin wrapper over ``engine.stencil_call``.
"""
from __future__ import annotations

import torch

from repro_torch.core.stencil import StencilSpec, shift, shift_nd
from repro_torch.kernels import engine
from repro_torch.kernels.ref import _box_offsets, f32


def _apply_2d(win: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One IR step of a star or box spec on a [rows, cols] window."""
    if spec.layout == "box":
        acc = torch.zeros_like(win)
        for offsets, w in _box_offsets(spec):
            acc = acc + f32(w) * shift_nd(win, offsets, spec.boundary)
        return acc
    r = spec.radius
    w = spec.weights
    acc = f32(spec.center) * win
    for a in range(2):
        for o in range(-r, r + 1):
            c = float(w[a, r + o])
            if o == 0 or c == 0.0:
                continue
            acc = acc + f32(c) * shift(win, a, o, spec.boundary)
    return acc


def taps_2d(spec: StencilSpec) -> list[tuple[int, int, float]]:
    """``(dy, dx, w)`` taps of a star or box 2D spec, in plugin order.

    A star's center tap comes first even when its weight is 0, as
    ``_apply_2d`` starts from ``center * win``.
    """
    if spec.dims != 2 or spec.layout == "custom":
        raise ValueError("taps_2d needs a 2D star or box spec")
    if spec.layout == "box":
        return [(dy, dx, f32(w)) for (dy, dx), w in _box_offsets(spec)]
    r = spec.radius
    w = spec.weights
    taps = [(0, 0, f32(spec.center))]
    for a in range(2):
        for o in range(-r, r + 1):
            c = float(w[a, r + o])
            if o == 0 or c == 0.0:
                continue
            taps.append((o, 0, c) if a == 0 else (0, o, c))
    return taps


def stencil2d(x: torch.Tensor, spec: StencilSpec, bx: int = 256,
              bt: int = 1, variant: str = "revolving",
              source: torch.Tensor | None = None, aux=None,
              scalars: torch.Tensor | None = None, valid_lo=None,
              valid_hi=None) -> torch.Tensor:
    """Run ``bt`` fused time steps of ``spec`` over a [H, W] grid."""
    if x.ndim not in (2, 3) or spec.dims != 2:
        raise ValueError("stencil2d needs a 2D grid (or a [B, H, W] "
                         "batch) and a 2D spec")
    return engine.stencil_call(x, spec, bx=bx, bt=bt, variant=variant,
                               source=source, aux=aux, scalars=scalars,
                               valid_lo=valid_lo, valid_hi=valid_hi)

"""The stencil IR, ported from ``repro/core/stencil.py``.

A ``StencilSpec`` describes one explicit structured-mesh update: a
``star`` (per-axis weight rows), ``box`` (a full ``(2r+1,)*dims`` weight
tensor) or ``custom`` (an ``update`` callable on torch tensors) tap
layout, a ``dirichlet0`` or ``clamp`` boundary applied at true grid
edges only, named ``source``/``coeff`` aux operands and per-step
scalars. The fields, validation and error messages are ``repro``'s, so
a spec carries across packages field for field (``convert.py``).

For star layouts the update at cell ``x`` is

    out[x] = c_center * in[x]
           + sum_axis sum_{o in [-r..r], o != 0} w[axis, r+o] * in[x + o*e_axis]
           + sum_{source operands} s[x]

``Sweep`` and ``StencilProgram`` are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

BOUNDARIES = ("dirichlet0", "clamp")
AUX_ROLES = ("source", "coeff")


# ---------------------------------------------------------------------------
# Boundary-aware neighbor reads: the one definition of what a tap means.
# ---------------------------------------------------------------------------

def shift(x: torch.Tensor, axis: int, offset: int,
          boundary: str = "dirichlet0") -> torch.Tensor:
    """x shifted so out[i] = x[i + offset] along ``axis``.

    Out-of-range reads follow ``boundary``: zero-filled for
    ``dirichlet0``, edge-replicated for ``clamp``.
    """
    if offset == 0:
        return x
    n = x.shape[axis]
    if boundary == "clamp":
        idx = (torch.arange(n, device=x.device) + offset).clamp_(0, n - 1)
        return x.index_select(axis, idx)
    r = abs(offset)
    if r >= n:
        return torch.zeros_like(x)
    body = x.narrow(axis, max(offset, 0), n - r)
    zshape = list(x.shape)
    zshape[axis] = r
    zeros = x.new_zeros(zshape)
    return torch.cat([body, zeros] if offset > 0 else [zeros, body],
                     dim=axis)


def shift_nd(x: torch.Tensor, offsets,
             boundary: str = "dirichlet0") -> torch.Tensor:
    """Multi-axis ``shift`` (box taps). Per-axis composition is exact
    for both boundary modes (corner reads clamp/zero per axis)."""
    out = x
    for axis, off in enumerate(offsets):
        if off:
            out = shift(out, axis, off, boundary)
    return out


@dataclasses.dataclass(frozen=True)
class AuxOperand:
    """A named per-cell input grid that rides along with the main grid.

    ``role``: ``"source"`` (added to every cell after each update step)
    or ``"coeff"`` (a step-constant field read by a custom ``update``;
    its boundary mode, ``None`` meaning the spec's, applies to its
    out-of-grid reads).
    """

    name: str
    role: str = "source"
    boundary: Optional[str] = None

    def __post_init__(self):
        if self.role not in AUX_ROLES:
            raise ValueError(f"aux role must be one of {AUX_ROLES}, "
                             f"got {self.role!r}")
        if self.boundary is not None and self.boundary not in BOUNDARIES:
            raise ValueError(f"aux boundary must be None or one of "
                             f"{BOUNDARIES}, got {self.boundary!r}")

    def boundary_of(self, spec: "StencilSpec") -> str:
        return self.boundary if self.boundary is not None else spec.boundary


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """One structured-mesh update in ``dims`` dimensions, radius ``r``.

    Exactly one layout is active: ``axis_weights`` (star; the center
    column must be zero, the center coefficient is ``center``),
    ``box_weights`` (box; ``center`` is derived from the tensor) or
    ``update`` (custom, 2D only: ``update(fields, spec)`` with
    ``fields["x"]`` the grid, each coeff operand by name and, when
    ``n_scalars > 0``, ``fields["scalars"]``; neighbor reads go through
    :func:`shift`/:func:`shift_nd` and stay within ``radius``).
    """

    dims: int
    radius: int
    center: float = 0.0
    axis_weights: Optional[Tuple[Tuple[float, ...], ...]] = None
    name: str = "stencil"
    boundary: str = "dirichlet0"
    box_weights: Optional[tuple] = None
    aux: Tuple[AuxOperand, ...] = ()
    n_scalars: int = 0
    update: Optional[Callable] = None

    def __post_init__(self):
        if self.dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {self.dims}")
        if not 1 <= self.radius <= 4:
            raise ValueError(f"radius must be in 1..4, got {self.radius}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"boundary must be one of {BOUNDARIES}, "
                             f"got {self.boundary!r}")
        n_layouts = sum(p is not None
                        for p in (self.axis_weights, self.box_weights,
                                  self.update))
        if n_layouts != 1:
            raise ValueError(
                "exactly one of axis_weights (star), box_weights (box) or "
                f"update (custom) must be set; got {n_layouts}")
        if self.axis_weights is not None:
            aw = np.asarray(self.axis_weights, dtype=np.float64)
            if aw.shape != (self.dims, 2 * self.radius + 1):
                raise ValueError(
                    f"axis_weights must have shape "
                    f"{(self.dims, 2*self.radius+1)}, got {aw.shape}")
            if np.any(aw[:, self.radius] != 0.0):
                raise ValueError("center column of axis_weights must be 0 "
                                 "(use `center` instead)")
        if self.box_weights is not None:
            bw = np.asarray(self.box_weights, dtype=np.float64)
            want = (2 * self.radius + 1,) * self.dims
            if bw.shape != want:
                raise ValueError(
                    f"box_weights must have shape {want}, got {bw.shape}")
            ctr = float(bw[(self.radius,) * self.dims])
            object.__setattr__(self, "center", ctr)
        if self.update is not None and self.dims != 2:
            raise ValueError("custom `update` specs are 2D-only for now")
        names = [op.name for op in self.aux]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate aux operand names: {names}")
        if any(n in ("x", "scalars") for n in names):
            raise ValueError('aux operand names "x" and "scalars" are '
                             'reserved')
        if any(op.role == "coeff" for op in self.aux) and self.update is None:
            raise ValueError("coeff aux operands require a custom `update` "
                             "(linear layouts have no use for them)")
        if self.n_scalars and self.update is None:
            raise ValueError("n_scalars > 0 requires a custom `update`")
        if self.n_scalars < 0:
            raise ValueError("n_scalars must be >= 0")

    @property
    def layout(self) -> str:
        if self.update is not None:
            return "custom"
        return "box" if self.box_weights is not None else "star"

    @property
    def points(self) -> int:
        """Taps per cell update: ``2*dims*r + 1`` for a star, the nonzero
        box entries for a box, the ``(2r+1)^dims`` cone for custom."""
        if self.layout == "star":
            return 2 * self.dims * self.radius + 1
        if self.layout == "box":
            return int(np.count_nonzero(
                np.asarray(self.box_weights, dtype=np.float64)))
        return (2 * self.radius + 1) ** self.dims

    @property
    def flops_per_cell(self) -> int:
        """One multiply per tap plus (taps - 1) adds."""
        return 2 * self.points - 1

    @property
    def weights(self) -> np.ndarray:
        return np.asarray(self.axis_weights, dtype=np.float32)

    @property
    def box(self) -> np.ndarray:
        return np.asarray(self.box_weights, dtype=np.float32)

    @property
    def source_operands(self) -> Tuple[AuxOperand, ...]:
        return tuple(op for op in self.aux if op.role == "source")

    @property
    def coeff_operands(self) -> Tuple[AuxOperand, ...]:
        return tuple(op for op in self.aux if op.role == "coeff")

    def halo(self, bt: int) -> int:
        """Halo width consumed by ``bt`` fused time steps."""
        return bt * self.radius


# ---------------------------------------------------------------------------
# Factories for the thesis's stencils plus IR-level helpers.
# ---------------------------------------------------------------------------

def diffusion(dims: int, radius: int = 1,
              boundary: str = "dirichlet0") -> StencilSpec:
    """High-order diffusion star: a tap at distance d weighs 1/d before
    normalisation, the center 0.4, and all weights sum to 1."""
    raw = np.zeros((dims, 2 * radius + 1), dtype=np.float64)
    for a in range(dims):
        for o in range(1, radius + 1):
            raw[a, radius + o] = 1.0 / o
            raw[a, radius - o] = 1.0 / o
    total = raw.sum()
    center = 0.4
    raw *= (1.0 - center) / total
    suffix = "" if boundary == "dirichlet0" else "_clamp"
    return StencilSpec(dims=dims, radius=radius, center=center,
                       axis_weights=tuple(map(tuple, raw)),
                       boundary=boundary,
                       name=f"diffusion{dims}d_r{radius}{suffix}")


def hotspot2d(sdc: float = 0.1, r_amb: float = 0.05) -> StencilSpec:
    """Hotspot-like 5-point star without the power term (Dirichlet-zero)."""
    w = sdc
    aw = np.zeros((2, 3), dtype=np.float64)
    aw[:, 0] = w
    aw[:, 2] = w
    center = 1.0 - 4.0 * w - r_amb
    return StencilSpec(dims=2, radius=1, center=center,
                       axis_weights=tuple(map(tuple, aw)), name="hotspot2d")


def hotspot3d() -> StencilSpec:
    """7-point star like Rodinia Hotspot3D's temperature update."""
    aw = np.zeros((3, 3), dtype=np.float64)
    aw[:, 0] = 0.12
    aw[:, 2] = 0.12
    return StencilSpec(dims=3, radius=1, center=1.0 - 6 * 0.12 - 0.02,
                       axis_weights=tuple(map(tuple, aw)), name="hotspot3d")


def _nested_tuple(a) -> tuple:
    """A numpy tensor as fully-nested (hashable) tuples."""
    if isinstance(a, np.ndarray) and a.ndim > 1:
        return tuple(_nested_tuple(row) for row in a)
    return tuple(float(v) for v in a)


def box_spec(weights, boundary: str = "dirichlet0",
             name: str = "box") -> StencilSpec:
    """A general box stencil from a ``(2r+1,)*dims`` weight tensor."""
    bw = np.asarray(weights, dtype=np.float64)
    if bw.ndim not in (2, 3) or len(set(bw.shape)) != 1 or bw.shape[0] % 2 == 0:
        raise ValueError(
            f"box weights must be a (2r+1,)*dims tensor, got {bw.shape}")
    radius = bw.shape[0] // 2
    return StencilSpec(dims=bw.ndim, radius=radius, center=0.0,
                       box_weights=_nested_tuple(bw),
                       boundary=boundary, name=name)


def star_as_box(spec: StencilSpec) -> StencilSpec:
    """The same stencil as ``spec`` re-expressed as a box weight tensor."""
    if spec.layout != "star":
        raise ValueError("star_as_box needs a star-layout spec")
    r, d = spec.radius, spec.dims
    bw = np.zeros((2 * r + 1,) * d, dtype=np.float64)
    ctr = (r,) * d
    bw[ctr] = spec.center
    aw = np.asarray(spec.axis_weights, dtype=np.float64)
    for a in range(d):
        for o in range(-r, r + 1):
            if o == 0:
                continue
            idx = list(ctr)
            idx[a] = r + o
            bw[tuple(idx)] += aw[a, r + o]
    return StencilSpec(dims=d, radius=r, center=0.0,
                       box_weights=_nested_tuple(bw),
                       boundary=spec.boundary, aux=spec.aux,
                       name=f"{spec.name}_as_box")


ALL_BENCH_SPECS = tuple(
    [diffusion(2, r) for r in (1, 2, 3, 4)]
    + [diffusion(3, r) for r in (1, 2, 3, 4)]
    + [hotspot2d(), hotspot3d()]
)

"""Spatial + temporal blocking planner for Hopper (twin of
``repro/core/blocking.py``).

The TPU plan keeps the full height of a ``bx``-column strip resident in
VMEM and pads to (8, 128) tiles. A Hopper thread block (CTA) has at most
227 KB of shared memory, so the plan here blocks a second axis. In 2D a
CTA owns a band of ``by`` output rows and walks the ``bx``-wide x-tiles
of that band in order (the revolving kernel); in 3D a CTA owns a
``by x bx`` tile of the (y, x) plane and streams z through it (the 3D
streaming kernel; both in ``kernels/csrc/``). ``bt`` fused steps grow
the halo to ``halo = bt * r`` on x and y. There is no lane or sublane
rule.

The bookkeeping keeps ``repro``'s meaning: redundancy (now over two
axes), HBM bytes per sweep (each input read once, the output written
once) and sweep counts, plus the CTA's shared-memory footprint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.core.stencil import StencilSpec

# Shared memory one CTA can use on an H100 (232,448 bytes).
SMEM_LIMIT = 227 * 1024
# Row bands tried, largest first, when the caller leaves ``by`` open.
BAND_CHOICES = (64, 32, 16, 8)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A resolved blocking configuration for one sweep on Hopper."""

    spec: StencilSpec
    grid_shape: Tuple[int, ...]   # (H, W) for 2D; (D, H, W) for 3D
    bx: int                       # x-tile width (last axis)
    bt: int                       # fused time steps
    by: int = 32                  # output rows per CTA (band or tile)
    itemsize: int = 4

    def __post_init__(self):
        if len(self.grid_shape) != self.spec.dims:
            raise ValueError("grid_shape rank must equal spec.dims")
        if self.bx < 1 or self.by < 1:
            raise ValueError("bx and by must be >= 1")
        if self.bt < 1:
            raise ValueError("bt >= 1")
        if self.halo > self.bx:
            # The window is assembled from the two neighbour tiles only.
            raise ValueError(f"halo {self.halo} exceeds tile width {self.bx}")

    # ---- geometry -----------------------------------------------------

    @property
    def halo(self) -> int:
        return self.spec.halo(self.bt)

    @property
    def width(self) -> int:
        return self.grid_shape[-1]

    @property
    def n_tiles(self) -> int:
        return math.ceil(self.width / self.bx)

    @property
    def window_width(self) -> int:
        return self.bx + 2 * self.halo

    @property
    def window_rows(self) -> int:
        return self.by + 2 * self.halo

    # ---- cost bookkeeping ---------------------------------------------

    @property
    def redundancy(self) -> float:
        """Cells computed per useful cell. Step ``t`` of ``bt`` computes
        the ``(by + 2(bt-t)r) x (bx + 2(bt-t)r)`` region its successors
        still need."""
        r, bx, by, bt = self.spec.radius, self.bx, self.by, self.bt
        total = sum((bx + 2 * (bt - t) * r) * (by + 2 * (bt - t) * r)
                    for t in range(1, bt + 1))
        return total / (bx * by * bt)

    @property
    def cells(self) -> int:
        return math.prod(self.grid_shape)

    @property
    def n_aux(self) -> int:
        """Operand streams beside the grid: one per coeff operand plus
        one for all source operands together (they are pre-summed)."""
        n_src = sum(op.role == "source" for op in self.spec.aux)
        return (len(self.spec.aux) - n_src) + min(n_src, 1)

    def hbm_bytes_per_sweep(self) -> float:
        """HBM traffic for one pass: one read of every input stream and
        one write of the grid (the revolving kernel reads each tile
        once)."""
        return self.cells * self.itemsize * (2.0 + self.n_aux)

    def smem_bytes(self, n_streams: int | None = None) -> int:
        """Dynamic shared memory of one CTA.

        2D (revolving kernel): a ring of three ``bx``-wide tiles of
        ``by + 2*halo`` rows per streamed operand, plus two ping-pong
        step windows. 3D (streaming kernel): ``bt`` stage rings of
        ``2r + 1`` planes, plus a ring of ``halo + 1`` source planes
        when a source streams beside the grid (``n_streams > 1``); each
        plane is the ``(by + 2*halo) x (bx + 2*halo)`` window. The last
        stage writes its block straight to HBM, so there is no output
        plane.
        """
        n_streams = 1 + self.n_aux if n_streams is None else n_streams
        plane = self.window_rows * self.window_width
        if self.spec.dims == 3:
            planes = self.bt * (2 * self.spec.radius + 1)
            if n_streams > 1:
                planes += self.halo + 1
            return planes * plane * self.itemsize
        ring = 3 * self.bx * self.window_rows
        return (n_streams * ring + 2 * plane) * self.itemsize

    def sweeps(self, n_steps: int) -> int:
        """Grid passes needed for ``n_steps`` total time steps."""
        return math.ceil(n_steps / self.bt)


def plan_2d(spec: StencilSpec, grid_shape: Tuple[int, ...], *, bx: int,
            bt: int, by: int | None = None, n_streams: int = 1,
            itemsize: int = 4) -> BlockPlan:
    """The plan for (bx, bt): ``by`` as given, else the largest band of
    ``BAND_CHOICES`` whose CTA fits ``SMEM_LIMIT``. Raises when no band
    fits. It serves 2D and 3D specs alike (``plan_3d``)."""
    for b in ((by,) if by is not None else BAND_CHOICES):
        plan = BlockPlan(spec, tuple(grid_shape), bx=bx, bt=bt, by=b,
                         itemsize=itemsize)
        if plan.smem_bytes(n_streams) <= SMEM_LIMIT:
            return plan
    raise ValueError(
        f"no row band fits one CTA's {SMEM_LIMIT} bytes of shared memory "
        f"at bx={bx}, bt={bt} (halo {plan.halo}, {n_streams} streams; "
        f"by={plan.by} needs {plan.smem_bytes(n_streams)}); lower bx or bt")


def plan_3d(spec: StencilSpec, grid_shape: Tuple[int, ...], *, bx: int,
            bt: int, by: int | None = None, n_streams: int = 1,
            itemsize: int = 4) -> BlockPlan:
    """The 3D plan for (bx, bt): the CTA's ``by x bx`` tile of the
    (y, x) plane, ``by`` chosen as ``plan_2d`` chooses its band."""
    if spec.dims != 3:
        raise ValueError("plan_3d needs a 3D spec")
    return plan_2d(spec, grid_shape, bx=bx, bt=bt, by=by,
                   n_streams=n_streams, itemsize=itemsize)


def incore_resident_bytes(spec: StencilSpec, grid_shape: Tuple[int, ...],
                          itemsize: int = 4, extra_streams: int = 0) -> int:
    """Device working set of an in-core run: the input grid, the output
    grid and one grid per declared aux operand (plus ``extra_streams``
    caller-side operands such as a legacy ``source=`` grid)."""
    return math.prod(grid_shape) * itemsize * (2 + len(spec.aux) + extra_streams)

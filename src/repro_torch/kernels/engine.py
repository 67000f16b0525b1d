"""The 2D blocked stencil engine (twin of ``repro/kernels/engine.py``).

``stencil_call`` runs ``bt`` fused time steps of one 2D spec over an
``[H, W]`` grid with the engine's semantics:

  * boundary fill at true grid edges only, before every fused step and
    once after the last: ``dirichlet0`` zeroes out-of-grid cells,
    ``clamp`` copies the nearest in-grid cell;
  * the leading-axis validity interval ``[valid_lo, valid_hi)`` (rows
    outside it count as outside the grid at every step; the full extent
    by default);
  * source operands pre-summed into one additive grid, zero outside the
    grid, added after every step: ``fill, (apply, +src, fill) * bt``.

Where it runs follows the tensors. On the card, ``variant="revolving"``
launches ``stencil2d_revolving``, the hand-written Hopper kernel in
``csrc/stencil2d_revolving.cu`` (it replaces ``repro``'s Pallas kernel
``_kernel_2d_revolving``). On the CPU the same function runs as
``stencil2d_fused_plain``, the kernel's plain PyTorch version. What the
kernel does not take yet (3D, a batch axis, coeff operands, per-step
scalars, custom updates, ``multioperand``) raises
``NotImplementedError`` naming the ROADMAP item that brings it, on
either device; nothing on the card falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.blocking import plan_2d
from repro_torch.core.stencil import StencilSpec

VARIANTS_2D = ("revolving", "multioperand")

_LATER = {
    "3d": "3D grids come with the 3D streaming kernel K3 (ROADMAP queue "
          "1, 3D + K3 + Hotspot3D)",
    "multioperand": "variant='multioperand' is kernel K1 (ROADMAP queue "
                    "1, K1 multioperand)",
    "batch": "a [B, H, W] batch comes with the batch axis (ROADMAP "
             "queue 1, batch axis and serving)",
    "coeff": "coeff operands come with the multi-sweep programs "
             "(ROADMAP queue 1, programs and solvers)",
    "scalars": "per-step scalars come with the multi-sweep programs "
               "(ROADMAP queue 1, programs and solvers)",
    "custom": "custom `update` specs need a device-side update "
              "(ROADMAP queue 1, programs and solvers)",
}


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lives on the CUDA card (the kernel route)."""
    return x.device.type == "cuda"


def _limits(valid_lo, valid_hi, rows: int) -> tuple[int, int]:
    """The leading-axis validity interval ``[lo, hi)`` as ints."""
    lo = 0 if valid_lo is None else int(valid_lo)
    hi = rows if valid_hi is None else int(valid_hi)
    if not 0 <= lo < hi <= rows:
        raise ValueError(f"validity interval [{lo}, {hi}) must satisfy "
                         f"0 <= lo < hi <= {rows}")
    return lo, hi


# ---------------------------------------------------------------------------
# The plain version: the kernel's function on the whole grid in PyTorch.
# ---------------------------------------------------------------------------

def _fill_plain(p: torch.Tensor, boundary: str, g: int, width: int,
                lo: int, hi: int) -> torch.Tensor:
    """Re-impose the true-grid boundary on a grid padded by ``g``.

    Cells outside rows ``[lo, hi)`` or columns ``[0, width)`` read 0
    (``dirichlet0``) or the nearest cell inside (``clamp``).
    """
    rows = torch.arange(p.shape[-2], device=p.device) - g
    cols = torch.arange(p.shape[-1], device=p.device) - g
    if boundary == "clamp":
        return (p.index_select(-2, rows.clamp(lo, hi - 1) + g)
                 .index_select(-1, cols.clamp(0, width - 1) + g))
    inside = (((rows >= lo) & (rows < hi))[:, None]
              & ((cols >= 0) & (cols < width))[None, :])
    return torch.where(inside, p, torch.zeros((), dtype=p.dtype,
                                              device=p.device))


def stencil2d_fused_plain(x: torch.Tensor, spec: StencilSpec, bt: int,
                          source: torch.Tensor | None = None,
                          valid_lo=None, valid_hi=None) -> torch.Tensor:
    """``bt`` fused steps of a 2D star or box spec on one ``[H, W]``
    grid, in plain PyTorch: the grid padded by ``r``, then ``fill,
    (apply, +src, fill) * bt``, then cropped. ``source`` is the
    pre-summed source grid."""
    from repro_torch.kernels.stencil2d import _apply_2d
    rows, width = x.shape
    lo, hi = _limits(valid_lo, valid_hi, rows)
    g = spec.radius

    def pad(a):
        return F.pad(a.to(x.dtype), (g, g, g, g))

    def fill(p, boundary):
        return _fill_plain(p, boundary, g, width, lo, hi)

    src = fill(pad(source), "dirichlet0") if source is not None else None
    p = pad(x)
    for _ in range(bt):
        p = _apply_2d(fill(p, spec.boundary), spec)
        if src is not None:
            p = p + src
    p = fill(p, spec.boundary)
    return p[g:g + rows, g:g + width].contiguous()


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------

def stencil2d_revolving(x: torch.Tensor, spec: StencilSpec, plan,
                        source: torch.Tensor | None = None,
                        valid_lo=None, valid_hi=None) -> torch.Tensor:
    """Launch the revolving 2D kernel: ``plan.bt`` fused steps of a star
    or box spec on a float32 ``[H, W]`` grid on the card, with an
    optional pre-summed ``source`` grid. Returns a new grid; raises on
    a refused launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil2d import taps_2d
    if not on_card(x):
        raise ValueError("stencil2d_revolving launches on a CUDA tensor; "
                         "use stencil2d_fused_plain on the CPU")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 [H, W] grid, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if tuple(plan.grid_shape) != tuple(x.shape) or plan.spec != spec:
        raise ValueError("plan was made for another spec or grid shape")
    rows, width = x.shape
    lo, hi = _limits(valid_lo, valid_hi, rows)
    x = x.contiguous()
    if source is not None:
        if source.shape != x.shape or source.device != x.device:
            raise ValueError("source must match the grid's shape and "
                             "device")
        source = source.to(torch.float32).contiguous()
    taps = taps_2d(spec)
    n = len(taps)
    dy = (ctypes.c_int * n)(*(t[0] for t in taps))
    dx = (ctypes.c_int * n)(*(t[1] for t in taps))
    w = (ctypes.c_float * n)(*(t[2] for t in taps))
    out = torch.empty_like(x)
    lib = _build.load("stencil2d_revolving")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stencil2d_revolving(
            x.data_ptr(), source.data_ptr() if source is not None else None,
            out.data_ptr(), rows, width, lo, hi, plan.bx, plan.by, plan.bt,
            spec.radius, int(spec.boundary == "clamp"), n, dy, dx, w,
            stream)
    if err != 0:
        raise RuntimeError(f"stencil2d_revolving launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    stencil2d_revolving.launches += 1
    return out


stencil2d_revolving.launches = 0


# ---------------------------------------------------------------------------
# The front door.
# ---------------------------------------------------------------------------

def stencil_call(x: torch.Tensor, spec: StencilSpec, *, bx: int, bt: int,
                 variant: str = "revolving",
                 source: torch.Tensor | None = None, aux=None,
                 scalars: torch.Tensor | None = None, valid_lo=None,
                 valid_hi=None) -> torch.Tensor:
    """Run ``bt`` fused time steps of ``spec`` over a 2D grid.

    ``aux`` maps every declared operand name to a same-shape grid;
    ``source`` is the legacy undeclared source grid; ``scalars`` is
    ``(bt, n_scalars)`` for custom updates (validated, then refused
    until they are ported); ``valid_lo``/``valid_hi`` bound the valid
    rows. On the card the kernel's row band is the largest that fits one
    CTA's shared memory (``plan_2d``).
    """
    dims = spec.dims
    if x.ndim not in (dims, dims + 1):
        raise ValueError(
            f"grid rank {x.ndim} != spec.dims {dims} (or "
            f"{dims + 1} with a leading batch axis)")
    batched = x.ndim == dims + 1
    if batched and x.shape[0] == 0:
        raise ValueError("batched grid must have at least one problem")
    halo = bt * spec.radius
    if halo > bx:
        raise ValueError(
            f"fused halo {halo} (bt={bt} x radii {[spec.radius]}) "
            f"exceeds the tile width bx={bx}")
    aux = dict(aux) if aux else {}
    declared = [op.name for op in spec.aux]
    missing = [n for n in declared if n not in aux]
    if missing:
        raise ValueError(f"spec {spec.name!r} requires aux operands "
                         f"{missing}")
    extra = [n for n in aux if n not in declared]
    if extra:
        raise ValueError(f"unknown aux operands {extra} for spec "
                         f"{spec.name!r} (declared: {declared})")
    for n, a in aux.items():
        if a.shape != x.shape:
            raise ValueError(f"aux operand {n!r} shape {tuple(a.shape)} "
                             f"!= grid shape {tuple(x.shape)}")
    if spec.n_scalars and scalars is None:
        raise ValueError(f"spec {spec.name!r} requires scalars of "
                         f"shape ({bt}, {spec.n_scalars})")
    if scalars is not None and not spec.n_scalars:
        raise ValueError("scalars passed but spec.n_scalars == 0")
    if dims == 3:
        raise NotImplementedError(_LATER["3d"])
    if variant not in VARIANTS_2D:
        raise ValueError(f"unknown 2D variant {variant!r}; "
                         f"expected one of {VARIANTS_2D}")
    for key, hit in (("multioperand", variant == "multioperand"),
                     ("batch", batched),
                     ("coeff", bool(spec.coeff_operands)),
                     ("scalars", scalars is not None),
                     ("custom", spec.layout == "custom")):
        if hit:
            raise NotImplementedError(_LATER[key])
    operands = list(aux.values()) + ([source] if source is not None else [])
    if x.device.type not in ("cpu", "cuda") or any(
            a.device != x.device for a in operands):
        raise ValueError(f"the grid and its operands must all lie on one "
                         f"CPU or CUDA device (grid on {x.device})")

    srcs = [aux[op.name] for op in spec.source_operands]
    if source is not None:
        srcs.append(source)
    combined = None
    for s in srcs:
        combined = s if combined is None else combined + s

    if on_card(x):
        plan = plan_2d(spec, x.shape, bx=bx, bt=bt,
                       n_streams=1 + (combined is not None),
                       itemsize=x.element_size())
        return stencil2d_revolving(x, spec, plan, combined, valid_lo,
                                   valid_hi)
    return stencil2d_fused_plain(x, spec, bt, combined, valid_lo, valid_hi)

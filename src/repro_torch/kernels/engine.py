"""The blocked stencil engine (twin of ``repro/kernels/engine.py``).

``stencil_call`` runs ``bt`` fused time steps of one spec over an
``[H, W]`` or ``[D, H, W]`` grid with the engine's semantics:

  * boundary fill at true grid edges only, before every fused step and
    once after the last: ``dirichlet0`` zeroes out-of-grid cells,
    ``clamp`` copies the nearest in-grid cell;
  * the leading-axis validity interval ``[valid_lo, valid_hi)`` (rows in
    2D, planes in 3D; outside it counts as outside the grid at every
    step; the full extent by default);
  * source operands pre-summed into one additive grid, zero outside the
    grid, added after every step: ``fill, (apply, +src, fill) * bt``.

Under ``clamp`` with an interior interval, the cells outside it take
the nearest valid row or plane of the result (the last fill). ``repro``
defines this for 2D only; its 3D kernel leaves pipeline leftovers there
(ROADMAP queue 3), so the port's 3D tests compare only the interval.

Where it runs follows the tensors. On the card, ``variant="revolving"``
launches a hand-written Hopper kernel from ``csrc/``:
``stencil2d_revolving`` in 2D (it replaces ``repro``'s Pallas kernel
``_kernel_2d_revolving``) and ``stencil3d_stream`` in 3D (it replaces
``_kernel_3d_stream``). On the CPU the same function runs as the
kernel's plain PyTorch version, ``stencil2d_fused_plain`` or
``stencil3d_stream_plain``. What the kernels do not take yet (a batch
axis, coeff operands, per-step scalars, custom updates,
``multioperand``) raises ``NotImplementedError`` naming the ROADMAP
item that brings it, on either device; nothing on the card falls back
to the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.blocking import plan_2d, plan_3d
from repro_torch.core.stencil import StencilSpec

VARIANTS_2D = ("revolving", "multioperand")
VARIANTS_3D = ("revolving",)   # one streaming kernel, as in repro

_LATER = {
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

def _fill_plain(p: torch.Tensor, boundary: str, g: int,
                limits) -> torch.Tensor:
    """Re-impose the true-grid boundary on a grid padded by ``g``.

    ``limits`` holds one valid interval ``(lo, hi)`` per axis; cells
    outside read 0 (``dirichlet0``) or the nearest cell inside
    (``clamp``).
    """
    inside = None
    for axis, (lo, hi) in enumerate(limits):
        idx = torch.arange(p.shape[axis], device=p.device) - g
        if boundary == "clamp":
            p = p.index_select(axis, idx.clamp(lo, hi - 1) + g)
            continue
        shape = [1] * p.ndim
        shape[axis] = -1
        m = ((idx >= lo) & (idx < hi)).reshape(shape)
        inside = m if inside is None else inside & m
    if boundary == "clamp":
        return p
    return torch.where(inside, p, torch.zeros((), dtype=p.dtype,
                                              device=p.device))


def _fused_plain(x, spec, bt, source, valid_lo, valid_hi, apply):
    """``fill, (apply, +src, fill) * bt`` on ``x`` padded by ``r`` on
    every axis, then cropped."""
    lo, hi = _limits(valid_lo, valid_hi, x.shape[0])
    limits = [(lo, hi)] + [(0, n) for n in x.shape[1:]]
    g = spec.radius

    def pad(a):
        return F.pad(a.to(x.dtype), (g, g) * x.ndim)

    def fill(p, boundary):
        return _fill_plain(p, boundary, g, limits)

    src = fill(pad(source), "dirichlet0") if source is not None else None
    p = pad(x)
    for _ in range(bt):
        p = apply(fill(p, spec.boundary), spec)
        if src is not None:
            p = p + src
    p = fill(p, spec.boundary)
    return p[tuple(slice(g, g + n) for n in x.shape)].contiguous()


def stencil2d_fused_plain(x: torch.Tensor, spec: StencilSpec, bt: int,
                          source: torch.Tensor | None = None,
                          valid_lo=None, valid_hi=None) -> torch.Tensor:
    """``bt`` fused steps of a 2D star or box spec on one ``[H, W]``
    grid, in plain PyTorch. ``source`` is the pre-summed source grid."""
    from repro_torch.kernels.stencil2d import _apply_2d
    return _fused_plain(x, spec, bt, source, valid_lo, valid_hi, _apply_2d)


def stencil3d_stream_plain(x: torch.Tensor, spec: StencilSpec, bt: int,
                           source: torch.Tensor | None = None,
                           valid_lo=None, valid_hi=None) -> torch.Tensor:
    """``bt`` fused steps of a 3D star or box spec on one ``[D, H, W]``
    grid, in plain PyTorch (z taps, then y, then x). ``source`` is the
    pre-summed source grid; ``[valid_lo, valid_hi)`` bounds the planes."""
    from repro_torch.kernels.stencil3d import apply_3d_grid
    return _fused_plain(x, spec, bt, source, valid_lo, valid_hi,
                        apply_3d_grid)


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------

def _checked(name, x, spec, plan, source, dims):
    """``x`` and ``source`` as the kernel ``name`` takes them: float32,
    contiguous, on the card, with ``plan`` made for them."""
    if not on_card(x):
        raise ValueError(f"{name} launches on a CUDA tensor; use its "
                         f"plain version on the CPU")
    axes = "[D, H, W]" if dims == 3 else "[H, W]"
    if x.ndim != dims or x.dtype != torch.float32:
        raise ValueError(f"the kernel takes a float32 {axes} grid, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if tuple(plan.grid_shape) != tuple(x.shape) or plan.spec != spec:
        raise ValueError("plan was made for another spec or grid shape")
    if source is not None:
        if source.shape != x.shape or source.device != x.device:
            raise ValueError("source must match the grid's shape and "
                             "device")
        source = source.to(torch.float32).contiguous()
    return x.contiguous(), source


def _launch(name, x, source, out, *args):
    """Call the C entry point ``name`` on the current stream; raise on a
    refused launch."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(
            x.data_ptr(), source.data_ptr() if source is not None else None,
            out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _c_array(ctype, values):
    values = list(values)
    return (ctype * len(values))(*values)


def stencil2d_revolving(x: torch.Tensor, spec: StencilSpec, plan,
                        source: torch.Tensor | None = None,
                        valid_lo=None, valid_hi=None) -> torch.Tensor:
    """Launch the revolving 2D kernel: ``plan.bt`` fused steps of a star
    or box spec on a float32 ``[H, W]`` grid on the card, with an
    optional pre-summed ``source`` grid. Returns a new grid; raises on
    a refused launch."""
    from repro_torch.kernels.stencil2d import taps_2d
    x, source = _checked("stencil2d_revolving", x, spec, plan, source, 2)
    rows, width = x.shape
    lo, hi = _limits(valid_lo, valid_hi, rows)
    taps = taps_2d(spec)
    out = torch.empty_like(x)
    _launch("stencil2d_revolving", x, source, out,
            rows, width, lo, hi, plan.bx, plan.by, plan.bt, spec.radius,
            int(spec.boundary == "clamp"), len(taps),
            _c_array(ctypes.c_int, (t[0] for t in taps)),
            _c_array(ctypes.c_int, (t[1] for t in taps)),
            _c_array(ctypes.c_float, (t[2] for t in taps)))
    stencil2d_revolving.launches += 1
    return out


stencil2d_revolving.launches = 0


def stencil3d_stream(x: torch.Tensor, spec: StencilSpec, plan,
                     source: torch.Tensor | None = None,
                     valid_lo=None, valid_hi=None) -> torch.Tensor:
    """Launch the 3D streaming kernel: ``plan.bt`` fused steps of a star
    or box spec on a float32 ``[D, H, W]`` grid on the card, with an
    optional pre-summed ``source`` grid and the plane interval
    ``[valid_lo, valid_hi)``. Returns a new grid; raises on a refused
    launch."""
    from repro_torch.kernels.stencil3d import taps_3d
    x, source = _checked("stencil3d_stream", x, spec, plan, source, 3)
    depth, rows, width = x.shape
    lo, hi = _limits(valid_lo, valid_hi, depth)
    taps = taps_3d(spec)
    out = torch.empty_like(x)
    _launch("stencil3d_stream", x, source, out,
            depth, rows, width, lo, hi, plan.bx, plan.by, plan.bt,
            spec.radius, int(spec.boundary == "clamp"), len(taps),
            *(_c_array(ctypes.c_int, (t[i] for t in taps))
              for i in range(3)),
            _c_array(ctypes.c_float, (t[3] for t in taps)))
    stencil3d_stream.launches += 1
    return out


stencil3d_stream.launches = 0


# ---------------------------------------------------------------------------
# The front door.
# ---------------------------------------------------------------------------

def stencil_call(x: torch.Tensor, spec: StencilSpec, *, bx: int, bt: int,
                 variant: str = "revolving",
                 source: torch.Tensor | None = None, aux=None,
                 scalars: torch.Tensor | None = None, valid_lo=None,
                 valid_hi=None) -> torch.Tensor:
    """Run ``bt`` fused time steps of ``spec`` over a 2D or 3D grid.

    ``aux`` maps every declared operand name to a same-shape grid;
    ``source`` is the legacy undeclared source grid; ``scalars`` is
    ``(bt, n_scalars)`` for custom updates (validated, then refused
    until they are ported); ``valid_lo``/``valid_hi`` bound the valid
    rows (2D) or planes (3D). On the card the kernel's ``by`` is the
    largest that fits one CTA's shared memory (``plan_2d``/``plan_3d``).
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
    variants = VARIANTS_3D if dims == 3 else VARIANTS_2D
    if variant not in variants:
        raise ValueError(f"unknown {dims}D variant {variant!r}; "
                         f"expected one of {variants}")
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
        plan = (plan_3d if dims == 3 else plan_2d)(
            spec, x.shape, bx=bx, bt=bt,
            n_streams=1 + (combined is not None),
            itemsize=x.element_size())
        kernel = stencil3d_stream if dims == 3 else stencil2d_revolving
        return kernel(x, spec, plan, combined, valid_lo, valid_hi)
    plain = stencil3d_stream_plain if dims == 3 else stencil2d_fused_plain
    return plain(x, spec, bt, combined, valid_lo, valid_hi)

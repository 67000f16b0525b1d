"""Public entry points of the stencil engine (twin of ``repro/kernels/ops.py``).

One device, in-core. Backends:

  * ``"auto"``      — the blocked engine (``kernels/engine.py``): the
                      Hopper kernel for tensors on the card, its plain
                      PyTorch version for tensors on the CPU;
  * ``"reference"`` — the plain oracle (``kernels/ref.py``).

``bx`` and ``bt`` are explicit: the autotuner that resolves ``None``
comes later (ROADMAP queue 1, model and tuner), as do several devices
and grids larger than the card's free memory (out-of-core).

Dispatch accounting: one tick per blocked engine dispatch issued here
(a fused sweep), as in ``repro``; the oracle route is not counted.
"""
from __future__ import annotations

import torch

from repro_torch.core.blocking import incore_resident_bytes
from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import engine as _engine
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.stencil2d import stencil2d as _stencil2d
from repro_torch.kernels.stencil3d import stencil3d as _stencil3d

BACKENDS = ("auto", "reference")

_DISPATCHES = 0


def reset_dispatch_count() -> None:
    global _DISPATCHES
    _DISPATCHES = 0


def dispatch_count() -> int:
    return _DISPATCHES


def _count_dispatch() -> None:
    global _DISPATCHES
    _DISPATCHES += 1


def _check_request(x, spec, bx, bt, backend, n_devices) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if bx is None or bt is None:
        raise NotImplementedError(
            "bx and bt must be given: the autotuner that resolves None "
            "comes later (ROADMAP queue 1, model and tuner)")
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            "n_devices > 1 comes with the multi-device runner (ROADMAP "
            "queue 1, multi-device)")


def _free_device_bytes(device: torch.device) -> int:
    """Free memory on ``device`` as ``cudaMemGetInfo`` reports it."""
    return torch.cuda.mem_get_info(device)[0]


def _check_fits(x, spec, aux, source) -> None:
    """Raise when an in-core run would not fit the card's free memory.

    The working set is ``incore_resident_bytes``; the grids already on
    the card count as held.
    """
    if not _engine.on_card(x):
        return
    operands = [x, *(aux or {}).values()]
    if source is not None:
        operands.append(source)
    need = incore_resident_bytes(spec, tuple(x.shape), x.element_size(),
                                 extra_streams=int(source is not None))
    held = sum(a.numel() * a.element_size() for a in operands
               if a.device == x.device)
    free = _free_device_bytes(x.device)
    if need - held > free:
        raise NotImplementedError(
            f"an in-core run of {tuple(x.shape)} needs {need} bytes on "
            f"{x.device} ({held} held, {free} free); grids larger than "
            f"the card come with out-of-core streaming (ROADMAP queue 1, "
            f"out-of-core)")


def stencil_sweep(x: torch.Tensor, spec: StencilSpec, bx: int | None = None,
                  bt: int | None = None, backend: str = "auto",
                  variant: str | None = None,
                  source: torch.Tensor | None = None, aux=None,
                  scalars: torch.Tensor | None = None,
                  n_devices: int | None = None) -> torch.Tensor:
    """One blocked pass = ``bt`` fused time steps over the whole grid.

    ``scalars``: ``(bt, n_scalars)`` per-step values for custom updates.
    """
    _check_request(x, spec, bx, bt, backend, n_devices)
    if backend != "reference":
        _check_fits(x, spec, aux, source)
    return _sweep(x, spec, bx, bt, backend, variant, source, aux, scalars)


def _sweep(x, spec, bx, bt, backend, variant, source, aux, scalars):
    if backend == "reference":
        return _ref.stencil_multistep(x, spec, bt, source, aux=aux,
                                      scalars=scalars)
    fn = _stencil2d if spec.dims == 2 else _stencil3d
    _count_dispatch()
    return fn(x, spec, bx=bx, bt=bt,
              variant=variant if variant is not None else "revolving",
              source=source, aux=aux, scalars=scalars)


def stencil_run(x: torch.Tensor, spec: StencilSpec, n_steps: int,
                bx: int | None = None, bt: int | None = None,
                backend: str = "auto", variant: str | None = None,
                source: torch.Tensor | None = None, aux=None,
                scalars: torch.Tensor | None = None,
                n_devices: int | None = None) -> torch.Tensor:
    """``n_steps`` time steps as ``ceil(n_steps / bt)`` blocked sweeps;
    the trailing partial sweep runs the remainder. ``scalars``:
    ``(n_steps, n_scalars)`` per-step values, sliced per sweep."""
    _check_request(x, spec, bx, bt, backend, n_devices)
    if backend != "reference":
        # Once per run: the free-memory query (cudaMemGetInfo) blocks the
        # host, so it stays out of the sweep loop.
        _check_fits(x, spec, aux, source)
    bt = min(bt, n_steps) if n_steps else bt
    if scalars is not None:
        scalars = torch.as_tensor(scalars, dtype=torch.float32,
                                  device=x.device).reshape(n_steps, -1)
    full, rem = divmod(n_steps, bt)
    done = 0
    for bts in [bt] * full + ([rem] if rem else []):
        x = _sweep(x, spec, bx, bts, backend, variant, source, aux,
                   scalars[done:done + bts] if scalars is not None else None)
        done += bts
    return x

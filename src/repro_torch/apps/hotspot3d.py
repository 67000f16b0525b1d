"""Rodinia Hotspot3D, 3D thermal simulation (twin of ``repro/apps/hotspot3d.py``).

A first-order 7-point star with Rodinia's clamp boundary plus the
per-step power term as a ``source`` operand: the Hotspot update lifted
to 3D, with no ambient term.

  * ``hotspot3d_reference`` — one oracle step at a time (``kernels/ref.py``);
  * ``hotspot3d_blocked``   — 2.5D spatial blocking (a ``by x bx`` tile
    of the plane per CTA, z streamed) with ``bt`` pipelined time steps
    through ``ops.stencil_run``: the Hopper kernel on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.apps import problems
from repro_torch.core.stencil import AuxOperand, StencilSpec
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class Hotspot3DParams:
    rx: float = 10.0
    ry: float = 10.0
    rz: float = 8.0
    cap: float = 16.0
    dt: float = 1.0
    t_amb: float = 80.0


def spec_of(p: Hotspot3DParams) -> StencilSpec:
    cx = p.dt / (p.cap * p.rx)
    cy = p.dt / (p.cap * p.ry)
    cz = p.dt / (p.cap * p.rz)
    center = 1.0 - 2.0 * (cx + cy + cz)
    aw = ((cz, 0.0, cz),     # z axis
          (cy, 0.0, cy),     # y axis
          (cx, 0.0, cx))     # x axis
    return StencilSpec(dims=3, radius=1, center=center, axis_weights=aw,
                       boundary="clamp",
                       aux=(AuxOperand("power", role="source"),),
                       name="hotspot3d")


def source_of(power: torch.Tensor, p: Hotspot3DParams) -> torch.Tensor:
    return (p.dt / p.cap) * power


def hotspot3d_reference(temp: torch.Tensor, power: torch.Tensor,
                        n_steps: int,
                        p: Hotspot3DParams = Hotspot3DParams()
                        ) -> torch.Tensor:
    """One oracle sweep per step."""
    spec = spec_of(p)
    aux = {"power": source_of(power, p)}
    for _ in range(n_steps):
        temp = ref.stencil_multistep(temp, spec, 1, aux=aux)
    return temp


def hotspot3d_blocked(temp: torch.Tensor, power: torch.Tensor, n_steps: int,
                      bt: int | None = None, bx: int | None = None,
                      p: Hotspot3DParams = Hotspot3DParams(),
                      backend: str = "auto",
                      n_devices: int | None = None) -> torch.Tensor:
    """Blocked 2.5D Hotspot3D through the engine; ``bx`` and ``bt`` are
    explicit until the autotuner is ported."""
    spec = spec_of(p)
    return ops.stencil_run(temp, spec, n_steps, bx=bx, bt=bt,
                           backend=backend,
                           aux={"power": source_of(power, p)},
                           n_devices=n_devices)


random_problem = problems.hotspot3d

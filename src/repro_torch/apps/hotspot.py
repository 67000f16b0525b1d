"""Rodinia Hotspot, 2D thermal simulation (twin of ``repro/apps/hotspot.py``).

Update rule (Rodinia, constants folded):

    T'[y,x] = T + dt/Cap * ( (T[y,x-1]+T[y,x+1]-2T)/Rx
                           + (T[y-1,x]+T[y+1,x]-2T)/Ry
                           + (Tamb - T)/Rz + P[y,x] )

a 5-point star with Rodinia's clamp boundary plus the power term as a
``source`` operand added every step.

  * ``hotspot_reference`` — one oracle step at a time (``kernels/ref.py``);
  * ``hotspot_blocked``   — spatial + temporal blocking through
    ``ops.stencil_run``: the Hopper kernel on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.apps import problems
from repro_torch.core.stencil import AuxOperand, StencilSpec
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class HotspotParams:
    """Physical constants, defaults matching Rodinia's hotspot.c scale."""
    rx: float = 10.0
    ry: float = 10.0
    rz: float = 4.0
    cap: float = 16.0
    dt: float = 1.0
    t_amb: float = 80.0


def spec_of(p: HotspotParams) -> StencilSpec:
    """The full Hotspot update as a stencil-IR spec: clamp-boundary
    5-point star + the power term as a source operand."""
    cx = p.dt / (p.cap * p.rx)
    cy = p.dt / (p.cap * p.ry)
    cz = p.dt / (p.cap * p.rz)
    center = 1.0 - 2.0 * cx - 2.0 * cy - cz
    aw = ((cy, 0.0, cy),     # y axis
          (cx, 0.0, cx))     # x axis
    return StencilSpec(dims=2, radius=1, center=center, axis_weights=aw,
                       boundary="clamp",
                       aux=(AuxOperand("power", role="source"),),
                       name="hotspot2d")


def source_of(power: torch.Tensor, p: HotspotParams) -> torch.Tensor:
    return (p.dt / p.cap) * power + (p.dt / (p.cap * p.rz)) * p.t_amb


def hotspot_reference(temp: torch.Tensor, power: torch.Tensor, n_steps: int,
                      p: HotspotParams = HotspotParams()) -> torch.Tensor:
    """One oracle sweep per step."""
    spec = spec_of(p)
    aux = {"power": source_of(power, p)}
    for _ in range(n_steps):
        temp = ref.stencil_multistep(temp, spec, 1, aux=aux)
    return temp


def hotspot_blocked(temp: torch.Tensor, power: torch.Tensor, n_steps: int,
                    bt: int | None = None, bx: int | None = None,
                    p: HotspotParams = HotspotParams(),
                    backend: str = "auto",
                    n_devices: int | None = None) -> torch.Tensor:
    """Spatial + temporal blocked Hotspot through the engine; ``bx`` and
    ``bt`` are explicit until the autotuner is ported."""
    spec = spec_of(p)
    return ops.stencil_run(temp, spec, n_steps, bx=bx, bt=bt,
                           backend=backend,
                           aux={"power": source_of(power, p)},
                           n_devices=n_devices)


random_problem = problems.hotspot

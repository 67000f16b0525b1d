"""Carry state from ``repro`` into the port without importing ``repro``.

  * ``spec_from_fields(d)``: a ``StencilSpec`` from the plain fields of
    another package's spec (``dataclasses.asdict``: floats, tuples and
    nested dicts for the aux operands);
  * ``grid_from_numpy(a, device)``: a numpy array as a tensor on
    ``device`` (``None``: the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.stencil import AuxOperand, StencilSpec


def spec_from_fields(d: dict) -> StencilSpec:
    """The port's spec with the same fields as ``d``."""
    fields = dict(d)
    fields["aux"] = tuple(AuxOperand(**dict(op)) for op in fields["aux"])
    return StencilSpec(**fields)


def grid_from_numpy(a, device=None) -> torch.Tensor:
    """``a`` (any array-like numpy accepts) as a tensor on ``device``."""
    return torch.from_numpy(np.array(a)).to(compat.resolve_device(device))

"""Plain PyTorch oracles (twin of ``repro/kernels/ref.py``).

Semantics contract, shared with the engine and its kernels: the stencil
IR of ``core.stencil.StencilSpec``; ``"dirichlet0"`` reads outside the
grid return 0 at every time step, ``"clamp"`` replicates the edge;
``"source"`` operands are added after every step; ``"coeff"`` operands
and per-step scalars are fed to a custom update. 2D and 3D, unbatched.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec, shift, shift_nd


def _box_offsets(spec: StencilSpec):
    """(offsets, weight) pairs of the nonzero box taps, in index order."""
    bw = np.asarray(spec.box_weights, dtype=np.float64)
    r = spec.radius
    out = []
    for idx in itertools.product(range(2 * r + 1), repeat=spec.dims):
        w = float(bw[idx])
        if w != 0.0:
            out.append((tuple(i - r for i in idx), w))
    return out


def f32(v: float) -> float:
    """A Python float rounded to float32, as ``jnp.asarray(v, f32)`` does."""
    return float(np.float32(v))


def stencil_step(x: torch.Tensor, spec: StencilSpec, aux=None,
                 scalars_t=None) -> torch.Tensor:
    """One time step of ``spec`` (rank matching ``spec.dims``).

    ``aux`` maps every spec.aux operand name to a same-shape grid;
    ``scalars_t`` is this step's ``(n_scalars,)`` vector (custom updates).
    """
    if x.ndim != spec.dims:
        raise ValueError(f"rank {x.ndim} != spec.dims {spec.dims}")
    aux = aux or {}
    missing = [op.name for op in spec.aux if op.name not in aux]
    if missing:
        raise ValueError(f"spec {spec.name!r} requires aux operands "
                         f"{missing}")

    if spec.update is not None:
        fields = {"x": x}
        for op in spec.coeff_operands:
            fields[op.name] = aux[op.name]
        if spec.n_scalars:
            if scalars_t is None:
                raise ValueError(f"spec {spec.name!r} requires "
                                 f"{spec.n_scalars} per-step scalars")
            fields["scalars"] = scalars_t
        acc = spec.update(fields, spec)
    elif spec.layout == "box":
        acc = torch.zeros_like(x)
        for offsets, w in _box_offsets(spec):
            acc = acc + f32(w) * shift_nd(x, offsets, spec.boundary)
    else:
        w = spec.weights
        acc = f32(spec.center) * x
        r = spec.radius
        for a in range(spec.dims):
            for o in range(-r, r + 1):
                coeff = float(w[a, r + o])
                if o == 0 or coeff == 0.0:
                    continue
                acc = acc + f32(coeff) * shift(x, a, o, spec.boundary)

    for op in spec.source_operands:
        acc = acc + aux[op.name]
    return acc


def stencil_multistep(x: torch.Tensor, spec: StencilSpec, n_steps: int,
                      source: torch.Tensor | None = None, aux=None,
                      scalars: torch.Tensor | None = None) -> torch.Tensor:
    """``n_steps`` time steps: the oracle for the blocked engine.

    ``source`` is a legacy per-step additive grid (an undeclared source
    operand); ``aux`` the spec's declared operands by name; ``scalars``
    ``(n_steps, n_scalars)`` per-step values for custom updates.
    """
    if x.ndim == spec.dims + 1:
        raise NotImplementedError(
            "a [B, *grid] batch comes with the batch axis (ROADMAP queue "
            "1, batch axis and serving); loop over the problems")
    if scalars is not None:
        scalars = torch.as_tensor(scalars, dtype=torch.float32,
                                  device=x.device).reshape(n_steps, -1)
    for t in range(n_steps):
        out = stencil_step(x, spec, aux,
                           scalars[t] if scalars is not None else None)
        if source is not None:
            out = out + source
        x = out
    return x

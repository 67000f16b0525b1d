"""The 3D slice on the CPU: the port's Rodinia Hotspot3D held against
``repro.apps.hotspot3d`` (engine pinned to ``backend="interpret"``) and
against both packages' ``hotspot3d_reference``, at 8 x 24 x 260 for 4
steps, with exact dispatch counts; the 3D specs carried across with
``convert.spec_from_fields``; the problem generator's ranges."""
import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.apps import hotspot3d as j_hotspot3d
from repro.core import stencil as js
from repro.kernels import ops as j_ops
from repro_torch import convert
from repro_torch.apps import hotspot3d as t_hotspot3d
from repro_torch.apps import problems
from repro_torch.core import stencil as ts
from repro_torch.kernels import engine as t_engine
from repro_torch.kernels import ops as t_ops

TOL = dict(rtol=3e-5, atol=3e-5)
D, H, W, STEPS = 8, 24, 260, 4


@pytest.fixture(scope="module")
def grids():
    temp, power = problems.hotspot3d(0, D, H, W, device="cpu")
    want = j_hotspot3d.hotspot3d_reference(jnp.asarray(temp.numpy()),
                                           jnp.asarray(power.numpy()), STEPS)
    return temp, power, np.asarray(want)


def test_hotspot3d_blocked_matches_repro(grids):
    temp, power, want_ref = grids
    j_ops.reset_dispatch_count()
    want = j_hotspot3d.hotspot3d_blocked(jnp.asarray(temp.numpy()),
                                         jnp.asarray(power.numpy()), STEPS,
                                         bt=2, bx=128, backend="interpret")
    t_ops.reset_dispatch_count()
    launches = t_engine.stencil3d_stream.launches
    got = t_hotspot3d.hotspot3d_blocked(temp, power, STEPS, bt=2, bx=128)
    assert got.shape == (D, H, W) and got.device.type == "cpu"
    assert t_ops.dispatch_count() == j_ops.dispatch_count() == 2
    assert t_engine.stencil3d_stream.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("bt", [3, 4])
def test_hotspot3d_blocked_counts_dispatches(grids, bt):
    temp, power, want_ref = grids
    t_ops.reset_dispatch_count()
    got = t_hotspot3d.hotspot3d_blocked(temp, power, STEPS, bt=bt, bx=64)
    assert t_ops.dispatch_count() == math.ceil(STEPS / bt)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_hotspot3d_reference_matches_repro(grids):
    temp, power, want = grids
    got = t_hotspot3d.hotspot3d_reference(temp, power, STEPS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    blocked = t_hotspot3d.hotspot3d_blocked(temp, power, STEPS, bt=2, bx=64,
                                            backend="reference")
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("name", ["hotspot3d_app", "hotspot3d",
                                  "diffusion_r1", "diffusion_r4_clamp"])
def test_spec_from_fields_carries_3d_specs(name):
    pairs = {
        "hotspot3d_app": (
            j_hotspot3d.spec_of(j_hotspot3d.Hotspot3DParams()),
            t_hotspot3d.spec_of(t_hotspot3d.Hotspot3DParams())),
        "hotspot3d": (js.hotspot3d(), ts.hotspot3d()),
        "diffusion_r1": (js.diffusion(3, 1), ts.diffusion(3, 1)),
        "diffusion_r4_clamp": (js.diffusion(3, 4, "clamp"),
                               ts.diffusion(3, 4, "clamp")),
    }
    jspec, tspec = pairs[name]
    carried = convert.spec_from_fields(dataclasses.asdict(jspec))
    assert carried == tspec
    assert dataclasses.asdict(carried) == dataclasses.asdict(jspec)
    assert carried.dims == 3 and carried.points == jspec.points


def test_hotspot3d_problem_generator():
    temp, power = problems.hotspot3d(3, 4, 6, 10, device="cpu")
    again, _ = problems.hotspot3d(3, 4, 6, 10, device="cpu")
    assert temp.dtype == power.dtype == torch.float32
    assert temp.shape == power.shape == (4, 6, 10)
    assert torch.equal(temp, again)
    assert 70.0 <= float(temp.min()) and float(temp.max()) < 80.0
    assert 0.0 <= float(power.min()) and float(power.max()) < 0.1
    assert t_hotspot3d.random_problem is problems.hotspot3d

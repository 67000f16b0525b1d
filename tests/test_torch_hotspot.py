"""The whole slice on the CPU: the port's Rodinia Hotspot held against
``repro.apps.hotspot`` (engine pinned to ``backend="interpret"``) and
against both packages' ``hotspot_reference``, at 24 x 256 for 8 steps,
with exact dispatch counts."""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.apps import hotspot as j_hotspot
from repro.kernels import ops as j_ops
from repro_torch.apps import hotspot as t_hotspot
from repro_torch.apps import problems
from repro_torch.kernels import engine as t_engine
from repro_torch.kernels import ops as t_ops

TOL = dict(rtol=3e-5, atol=3e-5)
H, W, STEPS = 24, 256, 8


@pytest.fixture(scope="module")
def grids():
    temp, power = problems.hotspot(0, H, W, device="cpu")
    want = j_hotspot.hotspot_reference(jnp.asarray(temp.numpy()),
                                       jnp.asarray(power.numpy()), STEPS)
    return temp, power, np.asarray(want)


@pytest.mark.parametrize("bt", [3, 8])
def test_hotspot_blocked_matches_repro(grids, bt):
    temp, power, want_ref = grids
    j_ops.reset_dispatch_count()
    want = j_hotspot.hotspot_blocked(jnp.asarray(temp.numpy()),
                                     jnp.asarray(power.numpy()), STEPS,
                                     bt=bt, bx=128, backend="interpret")
    t_ops.reset_dispatch_count()
    launches = t_engine.stencil2d_revolving.launches
    got = t_hotspot.hotspot_blocked(temp, power, STEPS, bt=bt, bx=128)
    assert got.shape == (H, W) and got.device.type == "cpu"
    assert t_ops.dispatch_count() == math.ceil(STEPS / bt)
    assert t_ops.dispatch_count() == j_ops.dispatch_count()
    assert t_engine.stencil2d_revolving.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_hotspot_reference_matches_repro(grids):
    temp, power, want = grids
    got = t_hotspot.hotspot_reference(temp, power, STEPS)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    blocked = t_hotspot.hotspot_blocked(temp, power, STEPS, bt=4, bx=64,
                                        backend="reference")
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), **TOL)


def test_hotspot_problem_generator():
    temp, power = problems.hotspot(3, 16, 40, device="cpu")
    again, _ = problems.hotspot(3, 16, 40, device="cpu")
    assert temp.dtype == power.dtype == torch.float32
    assert temp.shape == power.shape == (16, 40)
    assert torch.equal(temp, again)
    assert 70.0 <= float(temp.min()) and float(temp.max()) < 80.0
    assert 0.0 <= float(power.min()) and float(power.max()) < 0.1
    assert t_hotspot.random_problem is problems.hotspot

"""The port's 3D engine on the CPU (the 3D streaming kernel's plain
version) held against ``repro.kernels.engine.stencil_call(...,
backend="interpret")``, plus the 3D tap order, the 3D block plan, the
3D validation errors and the 3D batch refusal.

Inputs come from numpy seeds and go to both packages. Under ``clamp``
with an interior plane interval ``[lo, hi)``, ``repro``'s 3D kernel
leaves pipeline leftovers in the planes outside it (ROADMAP queue 3),
so that case compares the planes inside only.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import stencil as js
from repro.kernels import engine as j_engine
from repro.kernels import stencil3d as j_stencil3d
from repro_torch import convert
from repro_torch.core import blocking as t_blocking
from repro_torch.core import stencil as ts
from repro_torch.kernels import engine as t_engine
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.stencil3d import _apply_3d, stencil3d, taps_3d

TOL = dict(rtol=3e-5, atol=3e-5)


def _port(spec):
    return convert.spec_from_fields(dataclasses.asdict(spec))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.1 * rng.standard_normal(shape)).astype(np.float32))


def _both(jspec, shape, bt, with_src, seed, **kw):
    """(repro's result, the port's result) on the same inputs."""
    x, s = _inputs(shape, seed)
    want = j_engine.stencil_call(
        jnp.asarray(x), jspec, bx=128, bt=bt,
        source=jnp.asarray(s) if with_src else None, backend="interpret",
        **kw)
    got = t_engine.stencil_call(
        torch.from_numpy(x), _port(jspec), bx=128, bt=bt,
        source=torch.from_numpy(s) if with_src else None, **kw)
    assert got.shape == shape
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_engine3d_radius_matches_repro(radius):
    want, got = _both(js.diffusion(3, radius), (6, 11, 263), 1, False,
                      seed=radius)
    np.testing.assert_allclose(got, want, **TOL)


def test_engine3d_temporal_pipeline_matches_repro():
    want, got = _both(js.diffusion(3, 1), (7, 10, 260), 3, False, seed=7)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
@pytest.mark.parametrize("radius,bt", [(1, 3), (2, 2)])
def test_engine3d_boundary_source_matches_repro(radius, bt, boundary,
                                                with_src):
    shape = (7, 10, 260) if radius == 1 else (6, 11, 263)
    want, got = _both(js.diffusion(3, radius, boundary=boundary), shape, bt,
                      with_src, seed=10 * radius + bt)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
def test_engine3d_box_matches_repro(boundary):
    bw = np.random.default_rng(8).standard_normal((3, 3, 3)) * 0.05
    want, got = _both(js.box_spec(bw, boundary=boundary), (5, 9, 140), 2,
                      True, seed=8)
    np.testing.assert_allclose(got, want, **TOL)


def test_engine3d_interval_dirichlet0_matches_repro_everywhere():
    want, got = _both(js.diffusion(3, 1, "dirichlet0"), (9, 10, 140), 2,
                      True, seed=9, valid_lo=2, valid_hi=7)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:2].any() and not got[7:].any()


def test_engine3d_interval_clamp_matches_repro_inside():
    want, got = _both(js.diffusion(3, 1, "clamp"), (9, 10, 140), 2, True,
                      seed=9, valid_lo=2, valid_hi=7)
    np.testing.assert_allclose(got[2:7], want[2:7], **TOL)
    # repro's outside planes hold pipeline leftovers (ROADMAP queue 3);
    # the port's replicate the nearest valid plane.
    assert np.abs(want[:2] - got[:2]).max() > 0.1
    np.testing.assert_array_equal(got[:2], np.broadcast_to(got[2],
                                                           got[:2].shape))
    np.testing.assert_array_equal(got[7:], np.broadcast_to(got[6],
                                                           got[7:].shape))


def test_engine3d_equals_oracle_and_runs_through_ops():
    """``ops`` routes 3D through the engine, one dispatch per sweep."""
    x, s = _inputs((6, 13, 70), 11)
    spec = ts.diffusion(3, 2, boundary="clamp")
    ops.reset_dispatch_count()
    got = ops.stencil_run(torch.from_numpy(x), spec, 5, bx=32, bt=2,
                          source=torch.from_numpy(s))
    assert ops.dispatch_count() == 3
    want = t_ref.stencil_multistep(torch.from_numpy(x), spec, 5,
                                   source=torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    one = stencil3d(torch.from_numpy(x), spec, bx=32, bt=2,
                    source=torch.from_numpy(s))
    np.testing.assert_allclose(
        one.numpy(), t_ref.stencil_multistep(
            torch.from_numpy(x), spec, 2,
            source=torch.from_numpy(s)).numpy(), **TOL)


@pytest.mark.parametrize("layout", ["star", "box"])
def test_apply_3d_matches_repro_plugin(layout):
    spec = js.diffusion(3, 2, boundary="clamp")
    if layout == "box":
        spec = js.star_as_box(spec)
    win, _ = _inputs((5, 9, 17), 12)
    want = j_stencil3d._apply_3d(jnp.asarray(win), spec)
    got = _apply_3d(torch.from_numpy(win), _port(spec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_taps_3d_follow_plugin_order():
    spec = ts.diffusion(3, 2)
    taps = taps_3d(spec)
    assert [t[:3] for t in taps] == [
        (0, 0, 0),
        (-2, 0, 0), (-1, 0, 0), (1, 0, 0), (2, 0, 0),
        (0, -2, 0), (0, -1, 0), (0, 1, 0), (0, 2, 0),
        (0, 0, -2), (0, 0, -1), (0, 0, 1), (0, 0, 2)]
    assert taps[0][3] == float(np.float32(spec.center))
    assert taps[1][3] == float(spec.weights[0, 0])
    box = ts.star_as_box(spec)
    assert [t[:3] for t in taps_3d(box)] == [
        off for off, _ in t_ref._box_offsets(box)]
    with pytest.raises(ValueError):
        taps_3d(ts.diffusion(2, 1))


def test_plan_3d_sizing():
    from repro_torch.apps.hotspot3d import Hotspot3DParams, spec_of
    hs = spec_of(Hotspot3DParams())
    plan = t_blocking.plan_3d(hs, (512, 512, 512), bx=64, bt=4, n_streams=2)
    # 4 stage rings of 3 planes + 5 source planes, each 40 x 72 floats.
    assert plan.by == 32 and plan.halo == 4
    assert plan.smem_bytes(2) == (4 * 3 + 5) * 40 * 72 * 4
    assert plan.smem_bytes() == plan.smem_bytes(2)
    assert plan.hbm_bytes_per_sweep() == 512 ** 3 * 4 * 3
    assert plan.redundancy == pytest.approx(
        sum((64 + 2 * t) * (32 + 2 * t) for t in range(4)) / (64 * 32 * 4))
    dspec = ts.diffusion(3, 4)
    dplan = t_blocking.plan_3d(dspec, (512, 512, 512), bx=64, bt=2)
    # 2 stage rings of 9 planes, each 32 x 80 floats.
    assert dplan.by == 16
    assert dplan.smem_bytes(1) == 2 * 9 * 32 * 80 * 4
    assert dplan.hbm_bytes_per_sweep() == 512 ** 3 * 4 * 2
    bigger = t_blocking.BlockPlan(dspec, (512, 512, 512), bx=64, bt=2, by=32)
    assert bigger.smem_bytes(1) > t_blocking.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        t_blocking.plan_3d(dspec, (64, 64, 4096), bx=512, bt=2)
    with pytest.raises(ValueError, match="3D spec"):
        t_blocking.plan_3d(ts.diffusion(2, 1), (64, 64), bx=64, bt=1)


VALIDATION_3D = {
    "rank": lambda m, x, sp: dict(x=x[None, None], spec=sp),
    "halo": lambda m, x, sp: dict(x=x, spec=sp, bx=2, bt=3),
    "missing_aux": lambda m, x, sp: dict(x=x, spec=m.hotspot3d_spec()),
    "extra_aux": lambda m, x, sp: dict(x=x, spec=sp, aux={"bogus": x}),
    "aux_shape": lambda m, x, sp: dict(x=x, spec=m.hotspot3d_spec(),
                                       aux={"power": x[:2]}),
    "variant": lambda m, x, sp: dict(x=x, spec=sp, variant="multioperand"),
    "scalars_extra": lambda m, x, sp: dict(x=x, spec=sp,
                                           scalars=m.ones((1, 1))),
}


class _J:
    @staticmethod
    def hotspot3d_spec():
        from repro.apps.hotspot3d import Hotspot3DParams, spec_of
        return spec_of(Hotspot3DParams())

    @staticmethod
    def ones(shape):
        return jnp.ones(shape, jnp.float32)


class _T:
    @staticmethod
    def hotspot3d_spec():
        from repro_torch.apps.hotspot3d import Hotspot3DParams, spec_of
        return spec_of(Hotspot3DParams())

    @staticmethod
    def ones(shape):
        return torch.ones(shape)


@pytest.mark.parametrize("case", sorted(VALIDATION_3D))
def test_engine3d_validation_matches_repro(case):
    x, _ = _inputs((4, 8, 140), 0)
    jkw = {"bx": 128, "bt": 1,
           **VALIDATION_3D[case](_J, jnp.asarray(x), js.diffusion(3, 1))}
    tkw = {"bx": 128, "bt": 1,
           **VALIDATION_3D[case](_T, torch.from_numpy(x),
                                 ts.diffusion(3, 1))}
    with pytest.raises(ValueError) as want:
        j_engine.stencil_call(jkw.pop("x"), jkw.pop("spec"),
                              backend="interpret", **jkw)
    with pytest.raises(ValueError) as got:
        t_engine.stencil_call(tkw.pop("x"), tkw.pop("spec"), **tkw)
    assert str(got.value) == str(want.value)


def test_stencil3d_wrapper_checks_rank_like_repro():
    with pytest.raises(ValueError) as want:
        j_stencil3d.stencil3d(jnp.zeros((4, 5)), js.diffusion(3, 1))
    with pytest.raises(ValueError) as got:
        stencil3d(torch.zeros(4, 5), ts.diffusion(3, 1))
    assert str(got.value) == str(want.value)


def test_kernel3d_wrapper_refuses_cpu_tensors():
    spec = ts.diffusion(3, 1)
    plan = t_blocking.plan_3d(spec, (4, 8, 70), bx=64, bt=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_engine.stencil3d_stream(torch.zeros(4, 8, 70), spec, plan)

"""The port's 2D engine on the CPU (the kernel's plain version) held
against ``repro.kernels.engine.stencil_call(..., backend="interpret")``,
plus the port's validation, its card-only ``NotImplementedError``s
(checked with the card route forced, no GPU needed), the Hopper block
plan, the ops entry points and the toolchain plumbing.

Inputs come from numpy seeds and go to both packages; only the true
``[H, W]`` region is compared (``repro`` pads to (8, 128) tiles).
"""
import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blocking as j_blocking
from repro.core import stencil as js
from repro.kernels import engine as j_engine
from repro_torch import compat, convert
from repro_torch.core import blocking as t_blocking
from repro_torch.core import stencil as ts
from repro_torch.kernels import _build, ops
from repro_torch.kernels import engine as t_engine
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.stencil2d import stencil2d, taps_2d

TOL = dict(rtol=3e-5, atol=3e-5)


def _port(spec):
    return convert.spec_from_fields(dataclasses.asdict(spec))


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.1 * rng.standard_normal(shape)).astype(np.float32))


def _compare(jspec, shape, bt, with_src, seed, **kw):
    x, s = _inputs(shape, seed)
    jx, tx = _both(x)
    js_, t_s = _both(s)
    want = j_engine.stencil_call(jx, jspec, bx=128, bt=bt,
                                 source=js_ if with_src else None,
                                 backend="interpret", **kw)
    got = t_engine.stencil_call(tx, _port(jspec), bx=128, bt=bt,
                                source=t_s if with_src else None, **kw)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


@pytest.mark.parametrize("bt,with_src", [(1, False), (2, True), (3, True)])
@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_engine_matches_repro_interpret(radius, boundary, bt, with_src):
    shape = (13, 140) if (radius + bt) % 2 else (21, 259)
    _compare(js.diffusion(2, radius, boundary=boundary), shape, bt,
             with_src, seed=radius * 10 + bt)


@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
def test_engine_validity_interval_matches_repro(boundary):
    _compare(js.diffusion(2, 2, boundary=boundary), (37, 263), 3, True,
             seed=5, valid_lo=5, valid_hi=30)


def test_engine_box_matches_repro():
    bw = np.random.default_rng(6).standard_normal((5, 5)) * 0.04
    _compare(js.box_spec(bw, boundary="clamp"), (21, 259), 2, True, seed=6)


def _varcoef_update(mod):
    def update(fields, spec):
        j, c, s = fields["x"], fields["c"], fields["scalars"]
        lap = (mod.shift(j, 0, -1, "clamp") + mod.shift(j, 0, 1, "clamp")
               + mod.shift(j, 1, -1, "clamp") + mod.shift(j, 1, 1, "clamp")
               - 4.0 * j)
        return j + s[0] * c * lap
    return update


def _varcoef(mod):
    return mod.StencilSpec(dims=2, radius=1, boundary="clamp",
                           update=_varcoef_update(mod), n_scalars=1,
                           aux=(mod.AuxOperand("c", role="coeff"),),
                           name="varcoef")


def test_oracle_custom_coeff_scalars_match_repro():
    """The oracle runs custom updates with coeff operands and per-step
    scalars, which the engine refuses until they are ported."""
    x, _ = _inputs((27, 197), 3)
    c = np.random.default_rng(4).uniform(0.05, 0.2, x.shape).astype(
        np.float32)
    scal = np.array([[0.3], [0.1], [0.2]], np.float32)
    want = j_engine.stencil_call(jnp.asarray(x), _varcoef(js), bx=128, bt=3,
                                 aux={"c": jnp.asarray(c)},
                                 scalars=jnp.asarray(scal),
                                 backend="interpret")
    oracle = t_ref.stencil_multistep(torch.from_numpy(x), _varcoef(ts), 3,
                                     aux={"c": torch.from_numpy(c)},
                                     scalars=torch.from_numpy(scal))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **TOL)


def test_engine_equals_oracle_on_cpu():
    x, s = _inputs((21, 70), 9)
    spec = ts.diffusion(2, 3, boundary="clamp")
    got = stencil2d(torch.from_numpy(x), spec, bx=32, bt=3,
                    source=torch.from_numpy(s))
    want = t_ref.stencil_multistep(torch.from_numpy(x), spec, 3,
                                   source=torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


VALIDATION = {
    "rank": lambda m, x, sp: dict(x=x[None, None], spec=sp),
    "halo": lambda m, x, sp: dict(x=x, spec=sp, bx=2, bt=3),
    "missing_aux": lambda m, x, sp: dict(
        x=x, spec=m.hotspot_like()),
    "extra_aux": lambda m, x, sp: dict(x=x, spec=sp, aux={"bogus": x}),
    "aux_shape": lambda m, x, sp: dict(
        x=x, spec=m.hotspot_like(), aux={"power": x[:3]}),
    "variant": lambda m, x, sp: dict(x=x, spec=sp, variant="shiftreg"),
    "scalars_extra": lambda m, x, sp: dict(x=x, spec=sp,
                                           scalars=m.ones((1, 1))),
}


class _J:
    @staticmethod
    def hotspot_like():
        from repro.apps.hotspot import HotspotParams, spec_of
        return spec_of(HotspotParams())

    @staticmethod
    def ones(shape):
        return jnp.ones(shape, jnp.float32)


class _T:
    @staticmethod
    def hotspot_like():
        from repro_torch.apps.hotspot import HotspotParams, spec_of
        return spec_of(HotspotParams())

    @staticmethod
    def ones(shape):
        return torch.ones(shape)


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_engine_validation_matches_repro(case):
    x, _ = _inputs((16, 140), 0)
    jx, tx = _both(x)
    jkw = {"bx": 128, "bt": 1, **VALIDATION[case](_J, jx, js.diffusion(2, 1))}
    tkw = {"bx": 128, "bt": 1, **VALIDATION[case](_T, tx, ts.diffusion(2, 1))}
    with pytest.raises(ValueError) as want:
        j_engine.stencil_call(jkw.pop("x"), jkw.pop("spec"),
                              backend="interpret", **jkw)
    with pytest.raises(ValueError) as got:
        t_engine.stencil_call(tkw.pop("x"), tkw.pop("spec"), **tkw)
    assert str(got.value) == str(want.value)


NOT_YET = {
    "multioperand": (lambda x: dict(variant="multioperand"), "K1"),
    "batch": (lambda x: dict(x=x[None]), "batch axis"),
    "coeff": (lambda x: dict(spec=_varcoef(ts), aux={"c": x},
                             scalars=torch.ones(1, 1)), "coeff operands"),
    "scalars": (lambda x: dict(
        spec=ts.StencilSpec(dims=2, radius=1, update=lambda f, s: f["x"],
                            n_scalars=1),
        scalars=torch.ones(1, 1)), "scalars"),
    "custom": (lambda x: dict(
        spec=ts.StencilSpec(dims=2, radius=1, update=lambda f, s: f["x"])),
        "custom"),
}


@pytest.mark.parametrize("case", sorted(NOT_YET))
def test_card_route_raises_not_implemented(case, monkeypatch):
    """What the kernel does not take yet raises on the CPU and on the
    card route alike, before any launch."""
    x = torch.zeros(16, 140)
    make, match = NOT_YET[case]
    kw = dict(x=x, spec=ts.diffusion(2, 1), bx=128, bt=1)
    kw.update(make(x))
    with pytest.raises(NotImplementedError, match=match):
        t_engine.stencil_call(**kw)
    monkeypatch.setattr(t_engine, "on_card", lambda t: True)
    launches = t_engine.stencil2d_revolving.launches
    with pytest.raises(NotImplementedError, match=match):
        t_engine.stencil_call(**kw)
    assert t_engine.stencil2d_revolving.launches == launches


def test_3d_raises_not_implemented_everywhere(monkeypatch):
    """3D grids run now; a [B, D, H, W] batch of them is what still
    raises, on the CPU and on the card route alike, before any launch."""
    x = torch.zeros(2, 5, 6, 7)
    spec = ts.diffusion(3, 1)
    with pytest.raises(NotImplementedError, match="batch axis"):
        t_engine.stencil_call(x, spec, bx=128, bt=1)
    with pytest.raises(NotImplementedError, match="batch axis"):
        ops.stencil_sweep(x, spec, bx=128, bt=1)
    assert t_engine.stencil_call(x[0], spec, bx=128, bt=1).shape == (5, 6, 7)
    monkeypatch.setattr(t_engine, "on_card", lambda t: True)
    launches = t_engine.stencil3d_stream.launches
    with pytest.raises(NotImplementedError, match="batch axis"):
        t_engine.stencil_call(x, spec, bx=128, bt=1)
    assert t_engine.stencil3d_stream.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    spec = ts.diffusion(2, 1)
    plan = t_blocking.plan_2d(spec, (16, 140), bx=128, bt=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_engine.stencil2d_revolving(torch.zeros(16, 140), spec, plan)


def test_validity_interval_is_checked():
    x = torch.zeros(16, 140)
    for lo, hi in ((-1, 5), (5, 5), (0, 17)):
        with pytest.raises(ValueError, match="validity interval"):
            t_engine.stencil_call(x, ts.diffusion(2, 1), bx=128, bt=1,
                                  valid_lo=lo, valid_hi=hi)


def test_taps_follow_plugin_order():
    spec = ts.diffusion(2, 2)
    taps = taps_2d(spec)
    assert [(dy, dx) for dy, dx, _ in taps] == [
        (0, 0), (-2, 0), (-1, 0), (1, 0), (2, 0),
        (0, -2), (0, -1), (0, 1), (0, 2)]
    assert taps[0][2] == float(np.float32(spec.center))
    box = ts.star_as_box(spec)
    assert [(dy, dx) for dy, dx, _ in taps_2d(box)] == [
        off for off, _ in t_ref._box_offsets(box)]
    with pytest.raises(ValueError):
        taps_2d(ts.diffusion(3, 1))


# ---------------------------------------------------------------------------
# The Hopper block plan
# ---------------------------------------------------------------------------

def test_block_plan_bookkeeping_matches_repro():
    for jspec in (js.diffusion(2, 4), js.hotspot2d()):
        tspec = _port(jspec)
        for bt in (1, 4):
            jp = j_blocking.BlockPlan(jspec, (300, 1000), bx=128, bt=bt)
            tp = t_blocking.BlockPlan(tspec, (300, 1000), bx=128, bt=bt)
            assert tp.halo == jp.halo and tp.n_tiles == jp.n_tiles
            assert tp.hbm_bytes_per_sweep() == jp.hbm_bytes_per_sweep()
            assert tp.sweeps(64) == jp.sweeps(64) == math.ceil(64 / bt)
            assert tp.n_aux == jp.n_aux
    with pytest.raises(ValueError, match="exceeds tile width"):
        t_blocking.BlockPlan(ts.diffusion(2, 4), (64, 64), bx=8, bt=3)
    with pytest.raises(ValueError, match="exceeds tile width"):
        j_blocking.BlockPlan(js.diffusion(2, 4), (64, 256), bx=128, bt=33)


def test_block_plan_smem_and_band_choice():
    spec = ts.diffusion(2, 4)
    plan = t_blocking.BlockPlan(spec, (8192, 8192), bx=128, bt=4, by=32)
    h = 16
    assert plan.smem_bytes() == 4 * (3 * 128 * (32 + 2 * h)
                                     + 2 * (32 + 2 * h) * (128 + 2 * h))
    assert plan.redundancy > 1.0
    assert t_blocking.BlockPlan(spec, (64, 64), bx=64, bt=1,
                                by=8).redundancy == 1.0
    assert t_blocking.BlockPlan(spec, (64, 64), bx=64, bt=2,
                                by=8).redundancy == pytest.approx(
        (72 * 16 + 64 * 8) / (64 * 8 * 2))
    chosen = t_blocking.plan_2d(spec, (8192, 8192), bx=128, bt=4)
    assert chosen.smem_bytes() <= t_blocking.SMEM_LIMIT
    bigger = t_blocking.BlockPlan(spec, (8192, 8192), bx=128, bt=4,
                                  by=chosen.by * 2)
    assert bigger.smem_bytes() > t_blocking.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        t_blocking.plan_2d(spec, (64, 4096), bx=2048, bt=1)
    plan3 = t_blocking.BlockPlan(ts.diffusion(3, 1), (4, 8, 8), bx=8, bt=1,
                                 by=8)
    assert plan3.smem_bytes() == 3 * 10 * 10 * 4
    assert plan3.smem_bytes(2) == (3 + 2) * 10 * 10 * 4


# ---------------------------------------------------------------------------
# Entry points, devices and the build
# ---------------------------------------------------------------------------

def test_ops_request_checks():
    x = torch.zeros(16, 140)
    spec = ts.diffusion(2, 1)
    with pytest.raises(NotImplementedError, match="autotuner"):
        ops.stencil_run(x, spec, 4, bx=None, bt=2)
    with pytest.raises(NotImplementedError, match="autotuner"):
        ops.stencil_sweep(x, spec, bx=128)
    with pytest.raises(NotImplementedError, match="multi-device"):
        ops.stencil_run(x, spec, 4, bx=128, bt=2, n_devices=2)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.stencil_run(x, spec, 4, bx=128, bt=2, backend="pallas")


def test_ops_refuses_grids_beyond_free_memory(monkeypatch):
    x = torch.zeros(16, 140)
    spec = ts.diffusion(2, 1)
    monkeypatch.setattr(t_engine, "on_card", lambda t: True)
    monkeypatch.setattr(ops, "_free_device_bytes", lambda d: 100)
    with pytest.raises(NotImplementedError, match="out-of-core"):
        ops.stencil_sweep(x, spec, bx=128, bt=1)
    monkeypatch.setattr(ops, "_free_device_bytes", lambda d: 1 << 30)
    with pytest.raises(NotImplementedError, match="K1"):
        ops.stencil_sweep(x, spec, bx=128, bt=1, variant="multioperand")


def test_ops_run_queries_free_memory_once(monkeypatch):
    """The free-memory query blocks the host, so a run asks for it once,
    not once per sweep."""
    calls, sweeps = [], []
    monkeypatch.setattr(t_engine, "on_card", lambda t: True)
    monkeypatch.setattr(ops, "_free_device_bytes",
                        lambda d: calls.append(d) or 1 << 30)
    monkeypatch.setattr(ops, "_stencil2d",
                        lambda x, spec, **kw: sweeps.append(kw["bt"]) or x)
    ops.stencil_run(torch.zeros(16, 140), ts.diffusion(2, 1), 20, bx=128,
                    bt=8)
    assert sweeps == [8, 8, 4] and len(calls) == 1


def test_ops_run_reference_matches_engine_and_counts():
    x, s = _inputs((21, 70), 11)
    spec = ts.diffusion(2, 2, boundary="clamp")
    ops.reset_dispatch_count()
    got = ops.stencil_run(torch.from_numpy(x), spec, 7, bx=64, bt=3,
                          source=torch.from_numpy(s))
    assert ops.dispatch_count() == 3
    want = ops.stencil_run(torch.from_numpy(x), spec, 7, bx=64, bt=3,
                           source=torch.from_numpy(s), backend="reference")
    assert ops.dispatch_count() == 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.grid_from_numpy(np.zeros((2, 2)))
    assert compat.platform() == "cpu"
    assert compat.available_backends() == ("reference",)
    probe = compat.probe()
    assert probe["cuda_available"] is False and probe["torch"]
    assert convert.grid_from_numpy(np.ones((2, 3)), "cpu").shape == (2, 3)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    for name in ("stencil2d_revolving", "stencil3d_stream"):
        assert _build._library_path(name).parent == tmp_path

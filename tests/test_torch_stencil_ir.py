"""The port's stencil IR and oracle held against ``repro``'s.

Specs carry across through ``repro_torch.convert.spec_from_fields`` and
must come out field-equal to the port's own factories; validation
raises the same errors; and the port's ``ref.stencil_multistep`` equals
``repro.kernels.ref.stencil_multistep`` over dims 2/3 x radius 1-4 x
both boundaries x star/box x with/without source (the cases of
``tests/test_stencil_ir.py::test_golden_2d/_3d`` and
``test_box_embeds_star``), on the same numpy inputs.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.apps import hotspot as j_hotspot
from repro.core import stencil as js
from repro.kernels import ref as j_ref
from repro_torch import convert
from repro_torch.apps import hotspot as t_hotspot
from repro_torch.core import stencil as ts
from repro_torch.kernels import ref as t_ref

TOL = dict(rtol=3e-5, atol=3e-5)


def _fields(spec):
    return dataclasses.asdict(spec)


def _port(spec):
    return convert.spec_from_fields(dataclasses.asdict(spec))


_BOX = np.random.default_rng(3).standard_normal((5, 5)) * 0.05

FACTORIES = {
    "diffusion2d_r1": lambda m: m.diffusion(2, 1),
    "diffusion2d_r4_clamp": lambda m: m.diffusion(2, 4, boundary="clamp"),
    "diffusion3d_r3": lambda m: m.diffusion(3, 3),
    "hotspot2d": lambda m: m.hotspot2d(),
    "hotspot2d_args": lambda m: m.hotspot2d(0.2, 0.01),
    "hotspot3d": lambda m: m.hotspot3d(),
    "box_r2": lambda m: m.box_spec(_BOX, boundary="clamp", name="b"),
    "star_as_box": lambda m: m.star_as_box(m.diffusion(3, 2, "clamp")),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_specs_field_equal(name):
    want = FACTORIES[name](js)
    got = FACTORIES[name](ts)
    assert _fields(got) == _fields(want)
    assert _port(want) == got


def test_bench_specs_and_hotspot_spec_field_equal():
    assert len(ts.ALL_BENCH_SPECS) == len(js.ALL_BENCH_SPECS)
    for a, b in zip(ts.ALL_BENCH_SPECS, js.ALL_BENCH_SPECS):
        assert _fields(a) == _fields(b)
    want = j_hotspot.spec_of(j_hotspot.HotspotParams())
    got = t_hotspot.spec_of(t_hotspot.HotspotParams())
    assert _fields(got) == _fields(want)
    assert _port(want) == got


def _update(fields, spec):
    return fields["x"]


BAD_SPECS = {
    "no_layout": dict(dims=2, radius=1),
    "dims": dict(dims=4, radius=1, update=_update),
    "radius": dict(dims=2, radius=5, update=_update),
    "boundary": dict(dims=2, radius=1, update=_update, boundary="reflect"),
    "two_layouts": dict(dims=2, radius=1, update=_update,
                        axis_weights=((0.0, 0.0, 0.0),) * 2),
    "aw_shape": dict(dims=2, radius=1, axis_weights=((0.0, 0.0),) * 2),
    "aw_center": dict(dims=2, radius=1, axis_weights=((0.0, 1.0, 0.0),) * 2),
    "box_shape": dict(dims=2, radius=1, box_weights=((0.0,) * 3,) * 2),
    "custom_3d": dict(dims=3, radius=1, update=_update),
    "dup_aux": dict(dims=2, radius=1, update=_update,
                    aux=("s", "s")),
    "reserved": dict(dims=2, radius=1, update=_update, aux=("x",)),
    "coeff_linear": dict(dims=2, radius=1, axis_weights=((0.0,) * 3,) * 2,
                         aux=(("c", "coeff"),)),
    "scalars_linear": dict(dims=2, radius=1,
                           axis_weights=((0.0,) * 3,) * 2, n_scalars=1),
    "scalars_negative": dict(dims=2, radius=1, update=_update, n_scalars=-1),
}


def _make(mod, kw):
    kw = dict(kw)
    if "aux" in kw:
        kw["aux"] = tuple(mod.AuxOperand(*((a,) if isinstance(a, str)
                                           else a)) for a in kw["aux"])
    return mod.StencilSpec(**kw)


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_matches_repro(case):
    with pytest.raises(ValueError) as want:
        _make(js, BAD_SPECS[case])
    with pytest.raises(ValueError) as got:
        _make(ts, BAD_SPECS[case])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(name="a", role="sink"),
                                dict(name="a", boundary="reflect")])
def test_aux_validation_matches_repro(kw):
    with pytest.raises(ValueError) as want:
        js.AuxOperand(**kw)
    with pytest.raises(ValueError) as got:
        ts.AuxOperand(**kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        js.box_spec(np.zeros((4, 4)))
    with pytest.raises(ValueError) as got:
        ts.box_spec(np.zeros((4, 4)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("offset", [-3, -1, 2, 9])
def test_shift_matches_repro(boundary, axis, offset):
    x = np.random.default_rng(1).standard_normal((7, 8)).astype(np.float32)
    want = np.asarray(js.shift(jnp.asarray(x), axis, offset, boundary))
    got = ts.shift(torch.from_numpy(x), axis, offset, boundary).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_src", [False, True])
@pytest.mark.parametrize("layout", ["star", "box"])
@pytest.mark.parametrize("boundary", ["dirichlet0", "clamp"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("dims", [2, 3])
def test_oracle_matches_repro(dims, radius, boundary, layout, with_src):
    jspec = js.diffusion(dims, radius, boundary=boundary)
    if layout == "box":
        jspec = js.star_as_box(jspec)
    tspec = _port(jspec)
    shape = (23, 61) if dims == 2 else (7, 11, 19)
    rng = np.random.default_rng(10 * dims + radius)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    want = j_ref.stencil_multistep(
        jnp.asarray(x), jspec, 2,
        source=jnp.asarray(s) if with_src else None)
    got = t_ref.stencil_multistep(
        convert.grid_from_numpy(x, "cpu"), tspec, 2,
        source=convert.grid_from_numpy(s, "cpu") if with_src else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_oracle_declared_source_and_errors():
    jspec = j_hotspot.spec_of(j_hotspot.HotspotParams())
    tspec = _port(jspec)
    rng = np.random.default_rng(2)
    x = (70 + 10 * rng.random((16, 33))).astype(np.float32)
    p = (0.1 * rng.random((16, 33))).astype(np.float32)
    want = j_ref.stencil_multistep(jnp.asarray(x), jspec, 3,
                                   aux={"power": jnp.asarray(p)})
    got = t_ref.stencil_multistep(torch.from_numpy(x), tspec, 3,
                                  aux={"power": torch.from_numpy(p)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="requires aux operands"):
        t_ref.stencil_step(torch.from_numpy(x), tspec)
    with pytest.raises(ValueError, match="rank"):
        t_ref.stencil_step(torch.zeros(3, 4, 5), tspec)
    with pytest.raises(NotImplementedError, match="batch"):
        t_ref.stencil_multistep(torch.zeros(2, 3, 4), ts.diffusion(2, 1), 1)

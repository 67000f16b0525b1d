#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. probe: torch/CUDA versions, the card, nvcc, nvidia-smi;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (nvcc runs in parallel, one per source), with ptxas's report;
  3. each kernel against its plain PyTorch version on the card, case by
     case, at rtol = atol = 3e-5. 2D (``stencil2d_revolving``): radius
     1-4 stars x both boundaries x source on/off at bt 1 and 3, a
     radius-2 box, validity intervals, odd shapes, the main path's
     shapes. 3D (``stencil3d_stream``): radius 1-4 stars x both
     boundaries x source on/off at bt 1 and 2, radius-1 and radius-2
     boxes, interior plane intervals (the whole grid compared), odd
     shapes, the main path's shapes. Then each kernel's time at its main
     shapes beside its plain version's;
  4. the main paths, each held against the port's oracle on the card,
     with the kernel's launch count (it must be ceil(64 / bt) and equal
     the dispatch count), CUDA-event time, GCell/s and the HBM-bytes
     bound, after the host time of CUDA's free-memory query: at 8192^2
     float32 for 64 steps, Rodinia Hotspot through
     ``apps.hotspot.hotspot_blocked`` and ``diffusion(2, 4)`` through
     ``ops.stencil_run``; at 512^3 float32 for 64 steps, Rodinia
     Hotspot3D through ``apps.hotspot3d.hotspot3d_blocked`` and
     ``diffusion(3, 4)`` through ``ops.stencil_run``;
  5. the card's ``name, power.limit`` line, a ``kernels`` line, and last
     ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero and prints no ``ok`` line; so does a
host without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

TOL = dict(rtol=3e-5, atol=3e-5)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
SIZE = 8192                    # the thesis's 8000^2-class 2D grids
SIZE3D = 512                   # its 512^3-class 3D grids
STEPS = 64
HOTSPOT_BLOCKING = dict(bx=128, bt=8)
DIFFUSION_BLOCKING = dict(bx=128, bt=4)
HOTSPOT3D_BLOCKING = dict(bx=64, bt=4)
DIFFUSION3D_BLOCKING = dict(bx=64, bt=2)
# kernel -> (source, the Pallas kernel it replaces, the main config
# whose times stand in the ``kernels`` line)
KERNELS = {
    "stencil2d_revolving": (
        "src/repro_torch/kernels/csrc/stencil2d_revolving.cu",
        "src/repro/kernels/engine.py:277", "hotspot2d"),
    "stencil3d_stream": (
        "src/repro_torch/kernels/csrc/stencil3d_stream.cu",
        "src/repro/kernels/engine.py:352", "hotspot3d"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from repro_torch import compat
    from repro_torch.apps import hotspot, hotspot3d, problems
    from repro_torch.core.blocking import plan_2d, plan_3d
    from repro_torch.core.stencil import box_spec, diffusion
    from repro_torch.kernels import _build, engine, ops, ref

    dev = compat.default_device()
    card = compat.nvidia_smi()
    failures: list[str] = []
    # dims -> (kernel wrapper, its plain version, its planner)
    routes = {2: (engine.stencil2d_revolving, engine.stencil2d_fused_plain,
                  plan_2d),
              3: (engine.stencil3d_stream, engine.stencil3d_stream_plain,
                  plan_3d)}

    # 1. probe ------------------------------------------------------------
    emit({"phase": "probe", **compat.probe()})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "Compiling" in ln
                        or "stack frame" in ln]
                    for k, v in logs.items()}})

    # 3. kernels against plain -------------------------------------------
    def rand(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)

    errs = {2: [], 3: []}

    def compare(name, spec, shape, bt, src=False, lo=None, hi=None,
                by=None, bx=128, x=None, s=None, seed=0):
        kernel, plain, planner = routes[len(shape)]
        x = rand(shape, seed) if x is None else x
        if src and s is None:
            s = 0.1 * rand(shape, seed + 1)
        plan = planner(spec, shape, bx=bx, bt=bt, by=by,
                       n_streams=1 + (s is not None))
        got = kernel(x, spec, plan, s, lo, hi)
        want = plain(x, spec, bt, s, lo, hi)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **TOL))
        emit({"phase": "kernel_vs_plain", "kernel": kernel.__name__,
              "case": name, "shape": list(shape), "bt": bt, "by": plan.by,
              "bx": bx, "max_abs_err": err, "ok": ok})
        if not ok:
            failures.append(f"kernel_vs_plain {name}: max_abs_err {err}")
        errs[len(shape)].append(err)

    for r in (1, 2, 3, 4):
        for boundary in ("dirichlet0", "clamp"):
            spec = diffusion(2, r, boundary=boundary)
            for src in (False, True):
                for bt in (1, 3):
                    compare(f"star_r{r}_{boundary}_src{int(src)}", spec,
                            (45, 300), bt, src=src, by=16, seed=r)
    box = box_spec(np.random.default_rng(5).standard_normal((5, 5)) * 0.04,
                   boundary="clamp", name="box_r2")
    for bt in (1, 3):
        compare("box_r2_clamp_src1", box, (45, 300), bt, src=True, by=16)
    for bt in (1, 3):
        for boundary in ("dirichlet0", "clamp"):
            compare(f"interval_{boundary}",
                    diffusion(2, 2, boundary=boundary),
                    (37, 263), bt, src=True, lo=5, hi=30, by=8)
            # Bands [0, 8) and [32, 37) lie wholly outside [10, 27).
            compare(f"interval_outer_bands_{boundary}",
                    diffusion(2, 2, boundary=boundary),
                    (37, 263), bt, src=True, lo=10, hi=27, by=8)
        for shape in ((13, 140), (21, 259)):
            for by in (None, 8):
                compare(f"odd_{shape[0]}x{shape[1]}_by{by}",
                        diffusion(2, 3, boundary="clamp"),
                        shape, bt, src=True, by=by)

    # 3D: every case on 8-row tiles of 64 columns, so a grid spans
    # several tiles on both axes, ragged at both far edges.
    for r in (1, 2, 3, 4):
        for boundary in ("dirichlet0", "clamp"):
            spec = diffusion(3, r, boundary=boundary)
            for src in (False, True):
                for bt in (1, 2):
                    compare(f"star3d_r{r}_{boundary}_src{int(src)}", spec,
                            (12, 45, 150), bt, src=src, by=8, bx=64,
                            seed=r)
    rng = np.random.default_rng(6)
    for r, boundary in ((1, "clamp"), (2, "dirichlet0")):
        box3 = box_spec(rng.standard_normal((2 * r + 1,) * 3) * 0.01,
                        boundary=boundary, name=f"box3d_r{r}")
        for bt in (1, 2):
            compare(f"box3d_r{r}_{boundary}_src1", box3, (12, 45, 150), bt,
                    src=True, by=8, bx=64)
    for boundary in ("dirichlet0", "clamp"):
        # Under clamp the planes outside [lo, hi) take plane lo or hi - 1
        # in both versions, so the whole grid is compared.
        compare(f"interval3d_{boundary}", diffusion(3, 1, boundary=boundary),
                (9, 10, 140), 2, src=True, lo=2, hi=7, bx=64)
        compare(f"interval3d_r2_{boundary}",
                diffusion(3, 2, boundary=boundary), (13, 20, 100), 2,
                src=True, lo=3, hi=11, by=8, bx=64)
    for shape in ((6, 11, 263), (7, 10, 260), (5, 9, 140)):
        for by in (None, 8):
            compare(f"odd3d_{'x'.join(map(str, shape))}_by{by}",
                    diffusion(3, 3, boundary="clamp"), shape, 2, src=True,
                    by=by, bx=64)

    # The main paths' shapes: one sweep of each main config, then each
    # timed against the plain version.
    hp = hotspot.HotspotParams()
    hspec = hotspot.spec_of(hp)
    temp, power = problems.hotspot(0, SIZE, SIZE, device=dev)
    hp3 = hotspot3d.Hotspot3DParams()
    hspec3 = hotspot3d.spec_of(hp3)
    temp3, power3 = problems.hotspot3d(0, SIZE3D, SIZE3D, SIZE3D,
                                       device=dev)
    shape2, shape3 = (SIZE, SIZE), (SIZE3D,) * 3
    dspec, dspec3 = diffusion(2, 4), diffusion(3, 4)
    dx0, dx3 = rand(shape2, 7), rand(shape3, 8)
    main_cases = {
        "hotspot2d": (hspec, temp, hotspot.source_of(power, hp),
                      HOTSPOT_BLOCKING),
        "diffusion2d_r4": (dspec, dx0, None, DIFFUSION_BLOCKING),
        "hotspot3d": (hspec3, temp3, hotspot3d.source_of(power3, hp3),
                      HOTSPOT3D_BLOCKING),
        "diffusion3d_r4": (dspec3, dx3, None, DIFFUSION3D_BLOCKING),
    }
    timing = {}
    for name, (spec, x, s, blk) in main_cases.items():
        kernel, plain, planner = routes[x.ndim]
        compare(f"main_{name}", spec, tuple(x.shape), blk["bt"], x=x, s=s,
                bx=blk["bx"])
        plan = planner(spec, tuple(x.shape), bx=blk["bx"], bt=blk["bt"],
                       n_streams=1 + (s is not None))

        def run_kernel():
            return kernel(x, spec, plan, s)

        def run_plain():
            return plain(x, spec, plan.bt, s)

        def ms_of(fn, reps):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps

        p1 = ms_of(run_plain, 3)
        k1 = ms_of(run_kernel, 10)
        k2 = ms_of(run_kernel, 10)
        p2 = ms_of(run_plain, 3)
        n_src = int(s is not None)
        bytes_moved = plan.hbm_bytes_per_sweep()
        flops = x.numel() * plan.bt * (spec.flops_per_cell + n_src)
        bound = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
        timing[name] = {
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound * 1e3,
            "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS_PER_S else "operations"),
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "bx": plan.bx, "by": plan.by, "bt": plan.bt,
            "smem_bytes": plan.smem_bytes(1 + n_src),
            "hbm_bytes_per_sweep": bytes_moved,
        }
        emit({"phase": "kernel_time", "kernel": kernel.__name__,
              "config": name, "card": card, **timing[name]})

    # 4. the main paths ----------------------------------------------------
    # Host time of the free-memory query that ops.stencil_run makes once
    # per run, inside the main path's timed window.
    query_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        torch.cuda.mem_get_info(dev)
        query_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "free_mem_query", "ms_runs": query_ms})

    launches = dict.fromkeys(KERNELS, 0)

    def main_path(name, run, check):
        x = main_cases[name][1]
        kernel = routes[x.ndim][0]
        bt = timing[name]["bt"]
        for k in routes.values():
            k[0].launches = 0
        ops.reset_dispatch_count()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        counts = {k[0].__name__: k[0].launches for k in routes.values()}
        dispatches = ops.dispatch_count()
        ms = start.elapsed_time(end)
        want = check()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        finite = bool(torch.isfinite(out).all())
        n = counts[kernel.__name__]
        expected = math.ceil(STEPS / bt)
        ok = (bool(torch.allclose(out, want, **TOL)) and finite
              and out.shape == x.shape and n == expected
              and dispatches == n and sum(counts.values()) == n)
        emit({"phase": "main_path", "config": name, "card": card,
              "kernel": kernel.__name__, "shape": list(x.shape),
              "steps": STEPS, "bx": timing[name]["bx"],
              "by": timing[name]["by"], "bt": bt, "launches": n,
              "launches_expected": expected, "dispatches": dispatches,
              "ms": ms, "gcell_per_s": x.numel() * STEPS / (ms * 1e-3) / 1e9,
              "bound_ms": timing[name]["bound_ms"] * expected,
              "max_abs_err_vs_oracle": err, "finite": finite, "ok": ok})
        if not ok:
            failures.append(f"main_path {name}: err {err}, launches "
                            f"{counts}, dispatches {dispatches}")
        launches[kernel.__name__] += n

    main_path(
        "hotspot2d",
        lambda: hotspot.hotspot_blocked(temp, power, STEPS,
                                        **HOTSPOT_BLOCKING, p=hp),
        lambda: hotspot.hotspot_reference(temp, power, STEPS, hp))
    main_path(
        "diffusion2d_r4",
        lambda: ops.stencil_run(dx0, dspec, STEPS, **DIFFUSION_BLOCKING),
        lambda: ref.stencil_multistep(dx0, dspec, STEPS))
    main_path(
        "hotspot3d",
        lambda: hotspot3d.hotspot3d_blocked(temp3, power3, STEPS,
                                            **HOTSPOT3D_BLOCKING, p=hp3),
        lambda: hotspot3d.hotspot3d_reference(temp3, power3, STEPS, hp3))
    main_path(
        "diffusion3d_r4",
        lambda: ops.stencil_run(dx3, dspec3, STEPS, **DIFFUSION3D_BLOCKING),
        lambda: ref.stencil_multistep(dx3, dspec3, STEPS))

    # 5. summary ---------------------------------------------------------
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(card if card else "nvidia-smi: not available", flush=True)
    lines = []
    for name, (source, replaces, config) in KERNELS.items():
        t = timing[config]
        dims = main_cases[config][1].ndim
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[dims]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

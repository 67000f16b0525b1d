#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. probe: torch/CUDA versions, the card, nvcc, nvidia-smi;
  2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (nvcc runs in parallel, one per source), with ptxas's report;
  3. kernel against its plain PyTorch version on the card, case by case
     (radius 1-4 stars x both boundaries x source on/off at bt 1 and 3,
     a radius-2 box, two validity intervals, odd shapes, the main path's
     shapes), at rtol = atol = 3e-5;
  4. the main path at 8192 x 8192 float32, 64 steps: Rodinia Hotspot
     through ``apps.hotspot.hotspot_blocked`` and ``diffusion(2, 4)``
     through ``ops.stencil_run``, each held against the port's oracle
     on the card, with the kernel's launch count (it must be
     ceil(64 / bt)), CUDA-event time, GCell/s and the HBM-bytes bound,
     after the host time of CUDA's free-memory query;
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
STEPS = 64
HOTSPOT_BLOCKING = dict(bx=128, bt=8)
DIFFUSION_BLOCKING = dict(bx=128, bt=4)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/stencil2d_revolving.cu"
REPLACES = "src/repro/kernels/engine.py:277"


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
    from repro_torch.apps import hotspot, problems
    from repro_torch.core.blocking import plan_2d
    from repro_torch.core.stencil import box_spec, diffusion
    from repro_torch.kernels import _build, engine, ops, ref

    dev = compat.default_device()
    card = compat.nvidia_smi()
    failures: list[str] = []
    kernel = engine.stencil2d_revolving
    plain = engine.stencil2d_fused_plain

    # 1. probe ------------------------------------------------------------
    emit({"phase": "probe", **compat.probe()})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "Compiling" in ln]
                    for k, v in logs.items()}})

    # 3. kernel against plain --------------------------------------------
    def rand(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev)

    def compare(name, spec, shape, bt, src=False, lo=None, hi=None,
                by=None, bx=128, x=None, s=None, seed=0):
        x = rand(shape, seed) if x is None else x
        if src and s is None:
            s = 0.1 * rand(shape, seed + 1)
        plan = plan_2d(spec, shape, bx=bx, bt=bt, by=by,
                       n_streams=1 + (s is not None))
        got = kernel(x, spec, plan, s, lo, hi)
        want = plain(x, spec, bt, s, lo, hi)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **TOL))
        emit({"phase": "kernel_vs_plain", "case": name,
              "shape": list(shape), "bt": bt, "by": plan.by, "bx": bx,
              "max_abs_err": err, "ok": ok})
        if not ok:
            failures.append(f"kernel_vs_plain {name}: max_abs_err {err}")
        return err

    errs = []
    for r in (1, 2, 3, 4):
        for boundary in ("dirichlet0", "clamp"):
            spec = diffusion(2, r, boundary=boundary)
            for src in (False, True):
                for bt in (1, 3):
                    errs.append(compare(
                        f"star_r{r}_{boundary}_src{int(src)}", spec,
                        (45, 300), bt, src=src, by=16, seed=r))
    box = box_spec(np.random.default_rng(5).standard_normal((5, 5)) * 0.04,
                   boundary="clamp", name="box_r2")
    for bt in (1, 3):
        errs.append(compare("box_r2_clamp_src1", box, (45, 300), bt,
                            src=True, by=16))
    for bt in (1, 3):
        for boundary in ("dirichlet0", "clamp"):
            errs.append(compare(f"interval_{boundary}",
                                diffusion(2, 2, boundary=boundary),
                                (37, 263), bt, src=True, lo=5, hi=30, by=8))
            # Bands [0, 8) and [32, 37) lie wholly outside [10, 27).
            errs.append(compare(f"interval_outer_bands_{boundary}",
                                diffusion(2, 2, boundary=boundary),
                                (37, 263), bt, src=True, lo=10, hi=27, by=8))
        for shape in ((13, 140), (21, 259)):
            for by in (None, 8):
                errs.append(compare(f"odd_{shape[0]}x{shape[1]}_by{by}",
                                    diffusion(2, 3, boundary="clamp"),
                                    shape, bt, src=True, by=by))

    # The main path's shapes: one Hotspot sweep and one diffusion(2, 4)
    # sweep at 8192^2, then each timed against the plain version.
    hp = hotspot.HotspotParams()
    hspec = hotspot.spec_of(hp)
    temp, power = problems.hotspot(0, SIZE, SIZE, device=dev)
    hsrc = hotspot.source_of(power, hp)
    dspec = diffusion(2, 4)
    dx0 = rand((SIZE, SIZE), 7)
    main_cases = {
        "hotspot2d": (hspec, temp, hsrc, HOTSPOT_BLOCKING),
        "diffusion2d_r4": (dspec, dx0, None, DIFFUSION_BLOCKING),
    }
    timing = {}
    for name, (spec, x, s, blk) in main_cases.items():
        errs.append(compare(f"main_{name}", spec, (SIZE, SIZE), blk["bt"],
                            x=x, s=s, bx=blk["bx"]))
        plan = plan_2d(spec, (SIZE, SIZE), bx=blk["bx"], bt=blk["bt"],
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
        flops = SIZE * SIZE * plan.bt * (spec.flops_per_cell + n_src)
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
        emit({"phase": "kernel_time", "config": name, **timing[name]})

    # 4. the main path ------------------------------------------------------
    # Host time of the free-memory query that ops.stencil_run makes once
    # per run, inside the main path's timed window.
    query_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        torch.cuda.mem_get_info(dev)
        query_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "free_mem_query", "ms_runs": query_ms})

    def main_path(name, run, check, bt):
        kernel.launches = 0
        ops.reset_dispatch_count()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        launches = kernel.launches
        dispatches = ops.dispatch_count()
        ms = start.elapsed_time(end)
        want = check()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        finite = bool(torch.isfinite(out).all())
        ok = (bool(torch.allclose(out, want, **TOL)) and finite
              and tuple(out.shape) == (SIZE, SIZE)
              and launches == math.ceil(STEPS / bt)
              and dispatches == launches)
        emit({"phase": "main_path", "config": name, "card": card,
              "shape": [SIZE, SIZE],
              "steps": STEPS, "bt": bt, "launches": launches,
              "launches_expected": math.ceil(STEPS / bt),
              "dispatches": dispatches, "ms": ms,
              "gcell_per_s": SIZE * SIZE * STEPS / (ms * 1e-3) / 1e9,
              "bound_ms": timing[name]["bound_ms"] * math.ceil(STEPS / bt),
              "max_abs_err_vs_oracle": err, "finite": finite, "ok": ok})
        if not ok:
            failures.append(f"main_path {name}: err {err}, launches "
                            f"{launches}, dispatches {dispatches}")
        return launches

    launches = main_path(
        "hotspot2d",
        lambda: hotspot.hotspot_blocked(temp, power, STEPS,
                                        **HOTSPOT_BLOCKING, p=hp),
        lambda: hotspot.hotspot_reference(temp, power, STEPS, hp),
        HOTSPOT_BLOCKING["bt"])
    launches += main_path(
        "diffusion2d_r4",
        lambda: ops.stencil_run(dx0, dspec, STEPS, **DIFFUSION_BLOCKING),
        lambda: ref.stencil_multistep(dx0, dspec, STEPS),
        DIFFUSION_BLOCKING["bt"])

    # 5. summary ---------------------------------------------------------
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(card if card else "nvidia-smi: not available", flush=True)
    h = timing["hotspot2d"]
    emit({"kernels": [{
        "name": "stencil2d_revolving", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max(errs),
        "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

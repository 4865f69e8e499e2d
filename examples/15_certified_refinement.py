# -*- coding: utf-8 -*-
"""Certified f64-class residuals from f32 arithmetic
(iParams tolType='refined').

The reference runs float64 numba kernels end-to-end; the fast path here
is float32, and a single f32 state stalls at a relative-residual floor of
roughly
``eps * mean|w0*S| / mean|g|`` — ~1e-1 for the 2048^2 full-sphere Poisson
(polar metric inflation).  `tolType='refined'` routes the inversion
through mixed-precision iterative refinement (refine.solve_refined):

1. the state is an unevaluated double-float32 (hi, lo) pair
   (kept in ``xv.models.api.LAST_REFINE`` after the call);
2. its TRUE residual is measured with error-free transformations
   (ops/compensated.py — TwoSum / TwoProd are exact under the XLA
   compilers, so the certificate matches true f64 arithmetic to <0.1%,
   asserted in tests/test_refine.py);
3. corrections solve on the fast f32 path.

On a GPU, chip_smoke.py certifies the 2048^2 full-sphere case to 1e-5.
On CPU under x64 this example runs the same machinery in f64 (the operator
builds in the grid metric's dtype), pushing the certificate toward the
f64 floor instead.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import xinvert_tpu as xv

ny, nx = 96, 192
lat = np.linspace(-88.75, 88.75, ny)
lon = np.linspace(0, 360 - 360 / nx, nx)
llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
vor = (np.sin(3 * llon) * np.cos(2 * llat) * 1e-5).astype(np.float32)
F = xv.Field(vor, ("lat", "lon"), {"lat": lat, "lon": lon}, name="vor")

iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "printInfo": False}

# residual-rule solve: stops at the state's representable floor
sf0 = xv.invert_Poisson(F, dims=["lat", "lon"],
                        iParams={**iP, "mxLoop": 30000,
                                 "tolerance": 1e-9, "tolType": "residual"})
print("residual-rule relative residual:",
      float(np.max(np.asarray(xv.models.api.LAST_SOLVE.rel_change))))

# refined: certified relative residual <= tolerance, double-float state
sf = xv.invert_Poisson(F, dims=["lat", "lon"],
                       iParams={**iP, "mxLoop": 30000,
                                "tolerance": 1e-7, "tolType": "refined"})
r = xv.models.api.LAST_REFINE
print(f"refined: certified rel residual "
      f"{float(np.max(np.asarray(r.rel_residual))):.2e} "
      f"in {r.rounds} correction rounds")
print("low-word magnitude (double-float precision in play):",
      float(np.abs(np.asarray(r.S_lo)).max()),
      "vs state scale", float(np.abs(np.asarray(r.S_hi)).max()))

# the two solutions agree to the coarse of the two tolerances
a, b = np.asarray(sf0.values), np.asarray(sf.values)
print("refined vs residual-rule max rel diff:",
      float(np.abs(a - b).max() / np.abs(a).max()))

# -*- coding: utf-8 -*-
"""Reproducing the reference's PUBLISHED runs digit for digit
(iParams scheme='lexico').

The reference's tutorials print per-slice convergence records, e.g.
notebook 07 (Gill-Matsuno):

    loops  600 and tolerance is 5.608964e-05
    loops   87 and tolerance is 4.905623e-06
    loops  600 and tolerance is 5.174635e-05

``scheme='lexico'`` runs the reference's EXACT lexicographic iterate
sequence (within-row Gauss-Seidel as an associative-scan recurrence,
lexico.py) under its per-sweep stopping rule — so published xinvert runs
reproduce through this framework's public API to all printed digits on
float64 workloads.  One detail: the reference's loop counter has an
off-by-one (numbas.py:278-414 — printed ``loops L`` means L+1 sweeps), so
we pass ``mxLoop + 1`` and read ``loops L+1`` for the same final state.

The full reproduction matrix (9 notebook workloads, published + directly
driven reference oracles) lives in tests/test_notebook_parity.py.
"""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import xinvert_tpu as xv

# notebook 07's three synthetic heating patterns (Q1/Q2/Q3)
lon = np.linspace(0, 360, 144)
lat = np.linspace(-90, 90, 73)
L, N = np.meshgrid(lat, lon, indexing="ij")
mk = lambda a: xv.Field(a, ("lat", "lon"), {"lat": lat, "lon": lon})
Q1 = mk(0.05 * np.exp(-((L - 0) ** 2 + (N - 120) ** 2) / 100.0))
Q2 = mk(0.05 * np.exp(-((L - 10) ** 2 + (N - 120) ** 2) / 100.0)
        - 0.05 * np.exp(-((L + 10) ** 2 + (N - 120) ** 2) / 100.0))
Q3 = mk(0.05 * np.exp(-((L - 10) ** 2 + (N - 120) ** 2) / 100.0))

iP = {"BCs": ["fixed", "periodic"], "mxLoop": 601, "tolerance": 1e-5,
      "optArg": 1.4, "scheme": "lexico"}
mP = {"epsilon": 1e-5, "Phi": 5000}

published = [(600, 5.608964e-05), (87, 4.905623e-06), (600, 5.174635e-05)]
for Q, (L_ref, tol_ref) in zip((Q1, Q2, Q3), published):
    xv.invert_GillMatsuno(Q, dims=["lat", "lon"], mParams=mP, iParams=iP)
    res = xv.models.api.LAST_SOLVE
    got = float(np.asarray(res.rel_change).reshape(-1)[0])
    print(f"  published {L_ref:4d}/{tol_ref:.6e}  ->  ours "
          f"{int(np.asarray(res.iters).reshape(-1)[0])}/{got:.6e}  "
          f"(digit match: {np.isclose(got, tol_ref, rtol=5e-7)})")

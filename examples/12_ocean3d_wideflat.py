# -*- coding: utf-8 -*-
"""3-D damped ocean circulation on a wide-flat (SODA-class) grid.

The reference ships `invert_3DOcean` (apps.py:830-888) but its SODA test
is fully commented out (tests/test_3DOcean.py) and the fixture stripped.
Here: a global ocean volume with realistic continents (subsampled from the
soda_curl_like fixture's land mask), an exponential N-squared profile, and
interior mass forcing.  The demo runs at 1.5 degrees; the full
0.5-degree 30x330x720 volume runs the same code (its sweep rate on the
GPU is in PERF.md).
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import xinvert_tpu as xv
from xinvert_tpu import Field

if not os.path.exists("Data/soda_curl_like.nc"):
    os.system("python tools/make_fixtures.py")
soda = xv.open_dataset("Data/soda_curl_like.nc")

# subsample the 0.5-degree land mask to 1.5 degrees for the CPU demo
land2d = np.isnan(np.asarray(soda.curl.isel(time=0).values))[::3, ::3]
lat = np.asarray(soda.curl.coords["lat"])[::3]
lon = np.asarray(soda.curl.coords["lon"])[::3]

nz = 20
lev = np.linspace(0.0, 2850.0, nz)
mask = np.broadcast_to(~land2d, (nz,) + land2d.shape).copy()
mask[12:] &= np.roll(mask[0], 2, axis=0)     # crude shelf: deep cells shrink

# interior mass forcing: high-latitude sources, uniform sink (Stommel-Arons
# style), decaying with depth
zprof = np.exp(-lev / 700.0)[:, None, None]
src = np.exp(-((lat[None, :, None] - 62.0) / 8.0) ** 2) \
    + np.exp(-((lat[None, :, None] + 58.0) / 8.0) ** 2)
F = 1e-11 * zprof * (src - 0.35)
F = np.where(mask, F, np.nan)

Ff = Field(F, ("LEV", "lat", "lon"), {"LEV": lev, "lat": lat, "lon": lon})
N2 = Field(1e-5 * np.exp(-lev / 1000.0) + 1e-7, ("LEV",), {"LEV": lev})

iParams = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
           "tolerance": 1e-8, "mxLoop": 2000}
W = xv.invert_3DOcean(Ff, dims=["LEV", "lat", "lon"], iParams=iParams,
                      mParams={"epsilon": 7e-6, "k": 1e-5, "N2": N2})

v = np.asarray(W.values)
print("potential range:", float(np.nanmin(v)), float(np.nanmax(v)))
print("land NaN preserved:", bool(np.isnan(v[~mask]).all()))
# z boundaries are fixed cells (the reference's BCz semantics), so report
# a mid-depth level
print("mid-depth |phi| mean:", float(np.nanmean(np.abs(v[nz // 2]))))

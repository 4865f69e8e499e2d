# -*- coding: utf-8 -*-
"""The complete multigrid matrix (+Eψ family) and sharded biharmonic and
3-D solves.

- Every 2-D/3-D problem family now has a residual-certified `invert_*_mg`
  entry (15 of 16 apps; the 1-D pair is a one-shot direct tridiagonal
  solve, so MG is N/A by design).  The +Eψ pyramids keep the exact
  reference discretisation at level 0 and re-express coarse levels in
  upwinded general form (the antisymmetric cross-flux beta term is
  advection in disguise).
- The Stommel-Munk gyre class shards over ('y','x') meshes, and 3-D
  volumes run checked solves on-mesh (GSPMD, through iParams['mesh']).

Runs on 8 virtual CPU devices; identical code runs on a mesh of GPUs."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
from jax.sharding import Mesh
from xinvert_tpu import (Field, invert_Fofonoff, invert_Fofonoff_mg,
                         invert_Stommel_test, invert_Stommel_test_mg,
                         invert_StommelMunk, invert_omega)
from xinvert_tpu.models import api

# ---- 1) +Epsi multigrid: Fofonoff free mode, 6 cycles vs ~1200 sweeps
xc = np.linspace(0, 600000, 257)
yc = np.linspace(0, 500000, 193)
F = Field(np.broadcast_to(yc[:, None] - xc[None, :], (193, 257)),
          ("y", "x"), {"y": yc, "x": xc})
mP = {"f0": 1e-4, "beta": 2e-11, "c0": 8e-9, "c1": 1e-4}
sor = invert_Fofonoff(F, dims=["y", "x"], coords="cartesian", mParams=mP,
                      iParams={"BCs": ["fixed", "fixed"], "mxLoop": 6000,
                               "tolerance": 1e-14, "optArg": 1.2,
                               "printInfo": False})
print(f"Fofonoff SOR : {int(api.LAST_SOLVE.iters)} sweeps")
mg = invert_Fofonoff_mg(F, dims=["y", "x"], coords="cartesian",
                        mParams=mP, tol=1e-10,
                        iParams={"BCs": ["fixed", "fixed"],
                                 "printInfo": False})
rel = np.abs(np.asarray(mg) - np.asarray(sor)).max() / \
    np.abs(np.asarray(sor)).max()
print(f"Fofonoff MG  : {int(api.LAST_SOLVE.iters)} cycles, "
      f"agrees with SOR to {rel:.1e}")

# ---- 2) the hidden-advection case: standardised Stommel (B = -C = -f)
ny, nx = 65, 128
lat = np.linspace(15, 60, ny)
lon = np.linspace(0, 60, nx)
curl = Field(np.sin(np.linspace(0, np.pi, ny))[:, None]
             * np.cos(np.linspace(0, 4 * np.pi, nx))[None, :] * 1e-7,
             ("lat", "lon"), {"lat": lat, "lon": lon})
mPs = {"f0": 1e-4, "R": 5e-3, "D": 200.0, "rho0": 1027.0}
ref = invert_Stommel_test(curl, dims=["lat", "lon"], mParams=mPs,
                          iParams={"BCs": ["fixed", "fixed"],
                                   "mxLoop": 8000, "tolerance": 1e-13,
                                   "optArg": 1.4, "printInfo": False})
print(f"Stommel_test SOR: {int(api.LAST_SOLVE.iters)} sweeps")
mgs = invert_Stommel_test_mg(curl, dims=["lat", "lon"], mParams=mPs,
                             tol=1e-8,
                             iParams={"BCs": ["fixed", "fixed"],
                                      "printInfo": False})
rel = np.abs(np.asarray(mgs) - np.asarray(ref)).max() / \
    np.abs(np.asarray(ref)).max()
print(f"Stommel_test MG : {int(api.LAST_SOLVE.iters)} cycles, "
      f"agrees to {rel:.1e}")

# ---- 3) biharmonic gyre on a ('y','x') mesh (x-split ghost columns)
rng = np.random.default_rng(3)
ny2, nx2 = 128, 512
xcc = np.arange(nx2) * 5e4
ycc = np.arange(ny2) * 5e4
curl2 = Field(rng.normal(0, 1e-7, (ny2, nx2)), ("yc", "xc"),
              {"yc": ycc, "xc": xcc})
iP = {"BCs": ["fixed", "fixed"], "undef": np.nan, "mxLoop": 60,
      "tolerance": 0.0, "printInfo": False, "optArg": 1.0}
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("y", "x"))
one = invert_StommelMunk(curl2, dims=["yc", "xc"], coords="cartesian",
                         mParams={"A4": 5e3, "R": 0.0}, iParams=iP)
shd = invert_StommelMunk(curl2, dims=["yc", "xc"], coords="cartesian",
                         mParams={"A4": 5e3, "R": 0.0},
                         iParams={**iP, "mesh": mesh})
print("Stommel-Munk ('y','x') mesh == single device:",
      np.array_equal(one.values, shd.values, equal_nan=True))

# ---- 4) checked 3-D omega on a row mesh (reference stopping on-mesh)
nz, ny3, nx3 = 24, 48, 144
lev = np.linspace(1000e2, 100e2, nz)
lat3 = np.linspace(-60, 60, ny3)
lon3 = np.linspace(0, 360 - 360 / nx3, nx3)
F3 = Field(rng.normal(0, 1e-12, (nz, ny3, nx3)), ("lev", "lat", "lon"),
           {"lev": lev, "lat": lat3, "lon": lon3})
iP3 = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
       "mxLoop": 200, "tolerance": 1e-9, "printInfo": False}
w1 = invert_omega(F3, dims=["lev", "lat", "lon"], mParams={"N2": 2e-4},
                  iParams=iP3)
ymesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("y",))
w2 = invert_omega(F3, dims=["lev", "lat", "lon"], mParams={"N2": 2e-4},
                  iParams={**iP3, "mesh": ymesh})
print("checked sharded omega matches single device:",
      np.allclose(w1.values, w2.values, rtol=1e-9, atol=1e-13),
      f"({int(np.atleast_1d(api.LAST_SOLVE.iters)[0])} sweeps on-mesh)")

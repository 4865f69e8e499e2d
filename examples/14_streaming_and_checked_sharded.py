# -*- coding: utf-8 -*-
"""Out-of-core host streaming, the convergence-checked sharded solve, and
the Chebyshev scheme.

Runs on 8 virtual CPU devices; the same code runs on a mesh of GPUs."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8").strip()
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp
from xinvert_tpu.grid import Grid
from xinvert_tpu.models import problems
from xinvert_tpu.models.params import default_mParams
from xinvert_tpu import solve, solve_streamed

ny, nx, batch = 64, 96, 12
lat = np.linspace(-80, 80, ny)
lon = np.linspace(0, 360 - 360 / nx, nx)
grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                 bcs=("extend", "periodic"))
rng = np.random.default_rng(0)
vor = rng.normal(0, 1e-5, (batch, ny, nx))      # e.g. a year of time slices
Fdef = np.ones((ny, nx), bool)
Fdef[20:30, 30:50] = False                      # a land mass
spec = problems.build_poisson(jnp.asarray(vor), jnp.asarray(Fdef), grid,
                              default_mParams)

# --- out-of-core streaming: the batch stays in HOST memory and moves
# through the device 4 slices at a time, H2D/compute/D2H overlapped;
# results are bit-identical to the resident batched solve ---------------
streamed = solve_streamed(spec, np.zeros((batch, ny, nx)), None,
                          tol=1e-11, max_iters=3000, chunk=4,
                          check_every=8)
resident = solve(spec, jnp.zeros((batch, ny, nx)), None,
                 tol=1e-11, max_iters=3000, check_every=8)
assert np.array_equal(streamed.S, np.asarray(resident.S))
print("streamed == resident:", True,
      "| iters", streamed.iters[:4], "...")
# the same path is one iParams key away at the application level:
#   invert_Poisson(vor, dims=..., iParams={"streamChunk": 4})

# --- convergence-checked sharded solve: the reference's stopping
# semantics on a GSPMD-sharded state (global norm, per-element telemetry)
from xinvert_tpu.parallel import solve_sharded, make_grid_mesh

ny2, nx2 = 512, 128
lat2 = np.linspace(-80, 80, ny2)
lon2 = np.linspace(0, 360 - 360 / nx2, nx2)
grid2 = Grid.make(("lat", "lon"), (lat2, lon2), "lat-lon",
                  bcs=("extend", "periodic"))
vor2 = rng.normal(0, 1e-5, (ny2, nx2))
spec1 = problems.build_poisson(jnp.asarray(vor2),
                               jnp.ones((ny2, nx2), bool), grid2,
                               default_mParams)
shrd = solve_sharded(spec1, jnp.zeros((ny2, nx2)), mesh=make_grid_mesh(8),
                     omega=1.8, tol=1e-11, max_iters=3000, check_every=8)
host = solve(spec1, jnp.zeros((ny2, nx2)), 1.8, tol=1e-11, max_iters=3000,
             check_every=8)
print("sharded checked solve: iters", int(shrd.iters),
      "(host", int(host.iters), ") max|diff|",
      float(jnp.max(jnp.abs(shrd.S - host.S))))

# --- Chebyshev: per-half-sweep factors from the Golub-Varga recurrence --
cheb = solve(spec1, jnp.zeros((ny2, nx2)), 1.8, tol=1e-11, max_iters=3000,
             check_every=8, scheme="cheby")
print("cheby: iters", int(cheb.iters), "rel", float(cheb.rel_change))

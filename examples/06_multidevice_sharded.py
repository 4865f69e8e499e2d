# -*- coding: utf-8 -*-
"""Multi-device solves: GSPMD-sharded and explicit halo-exchange executors
over a ('batch','y','x') mesh (a capability beyond the reference).

Runs on 8 virtual CPU devices; identical code runs on a mesh of GPUs
(and multiple hosts after jax.distributed.initialize())."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=8").strip()
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp
from xinvert_tpu.grid import Grid
from xinvert_tpu.models import problems
from xinvert_tpu.models.params import default_mParams
from xinvert_tpu.solver import solve_fixed
from xinvert_tpu.parallel import make_grid_mesh, solve_sharded
from xinvert_tpu.parallel.halo import solve_fixed_halo

ny, nx, batch = 64, 96, 4
lat = np.linspace(-80, 80, ny)
lon = np.linspace(0, 360 - 360 / nx, nx)
grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                 bcs=("extend", "periodic"))
rng = np.random.default_rng(0)
vor = rng.normal(0, 1e-5, (batch, ny, nx))
Fdef = np.ones((ny, nx), bool)
Fdef[20:30, 30:50] = False     # a land mass
spec = problems.build_poisson(jnp.asarray(vor), jnp.asarray(Fdef), grid,
                              default_mParams)
S0 = jnp.zeros((batch, ny, nx))

mesh = make_grid_mesh(8, batch=2)            # 2 x (2x2) mesh
print("mesh:", dict(mesh.shape))

res = solve_sharded(spec, S0, mesh=mesh, tol=1e-11, max_iters=3000)
print("sharded solve: iters", np.asarray(res.iters),
      "rel", np.asarray(res.rel_change))

# explicit ppermute halo executor on the spatial sub-mesh (batch dims ride
# along unsharded)
sub = jax.sharding.Mesh(np.asarray(mesh.devices)[0], ("y", "x"))
h = solve_fixed_halo(spec, S0, 1.8, 200, mesh=sub)
single = solve_fixed(spec, S0, 1.8, 200)
print("halo executor max |diff| vs single-device:",
      float(jnp.max(jnp.abs(h - single))))

# -*- coding: utf-8 -*-
"""Multi-device distribution layer: device meshes, domain decomposition and
sharded SOR solves.

The reference framework is single-process and single-threaded (see
/root/reference/xinvert/core.py:129-139 — a sequential Python loop over batch
slices).  Here the grid is decomposed over a ``jax.sharding.Mesh`` with axes
('batch', 'y', 'x'): non-core dims shard over 'batch' (data parallelism),
and the core grid shards spatially over ('y', 'x').  Stencil neighbor access
compiles to XLA collective-permutes between devices; convergence norms become
global cross-device reductions — XLA's SPMD partitioner inserts the
collectives from the sharding annotations.
"""
from .mesh import (                                              # noqa: F401
    make_grid_mesh, shard_problem, solve_sharded, solve_fixed_sharded,
    problem_pspecs, shard_mg_levels, solve_mg_sharded,
)
from .halo import solve_fixed_halo                               # noqa: F401
from .scaling import (                                           # noqa: F401
    initialize_distributed, make_hybrid_mesh, scaling_bench,
    format_scaling_table,
)

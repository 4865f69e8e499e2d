# -*- coding: utf-8 -*-
"""xinvert_tpu — a JAX framework for inverting elliptic equations of
geophysical fluid dynamics (Poisson/streamfunction, Helmholtz, QG PV,
Eliassen, Gill-Matsuno, Stommel/Munk, QG-omega, ...).

A from-scratch JAX/XLA rebuild of the capabilities of miniufo/xinvert:
every reference kernel family is compiled into one universal stencil
program executed by a red-black SOR engine that jits, vmaps over non-core
(batch) dims, shards over device meshes, and runs a fused CUDA sweep
kernel on NVIDIA GPUs.

Public API mirrors xinvert/__init__.py:8-33 plus extensions.
"""

__version__ = "0.1.0"

from .field import Field, as_field, concat                      # noqa: F401
from .io import open_dataset, save_dataset, Dataset             # noqa: F401
from .grid import Grid, optimal_omega                           # noqa: F401
from .stencil import StencilSpec                                # noqa: F401
from .solver import (solve, solve_fixed, solve_fixed_cheby,  # noqa: F401
                     solve_trajectory, SolveResult)
from .stream import solve_streamed                              # noqa: F401
from .fd import FiniteDiff, padBCs, deriv, deriv2               # noqa: F401
from .ops.tridiag import trace, traceCyclic, tridiag_solve      # noqa: F401
from .ops.direct import solve_direct, direct_applicable         # noqa: F401
from .mg import (                                               # noqa: F401
    build_pyramid_standard2d, build_pyramid_standard3d, build_pyramid_bih2d,
    build_pyramid_general2d, build_pyramid_general3d,
    solve_mg,
)
from .lexico import solve_fixed_lexicographic                   # noqa: F401
from .refine import solve_refined, RefineResult                 # noqa: F401
from .core import (                                             # noqa: F401
    inv_standard1D, inv_standard2D, inv_standard2D_test, inv_standard3D,
    inv_general2D, inv_general2D_bih, inv_general3D,
)
from .models.params import default_iParams, default_mParams     # noqa: F401
from .models.api import (                                       # noqa: F401
    invert_Poisson, invert_Poisson_mg, invert_omega_mg, invert_StommelMunk_mg,
    invert_GillMatsuno_mg, invert_Stommel_mg, invert_StommelArons_mg,
    invert_3DOcean_mg, invert_PV2D_mg, invert_Eliassen_mg,
    invert_geostrophic_mg, invert_RefState_mg, invert_Fofonoff_mg,
    invert_BrethertonHaidvogel_mg, invert_GillMatsuno_test_mg,
    invert_Stommel_test_mg, invert_RefState, invert_GeoAdjustment,
    invert_RefStateSWM, invert_PV2D, invert_Eliassen,
    invert_GillMatsuno, invert_GillMatsuno_test, invert_Stommel,
    invert_Stommel_test, invert_StommelMunk, invert_StommelArons,
    invert_geostrophic, invert_BrethertonHaidvogel, invert_Fofonoff,
    invert_omega, invert_3DOcean, animate_iteration, invert_MultiGrid,
    cal_flow, loop_noncore,
)


from .ops.implicit import (                                     # noqa: F401
    solve_implicit, transpose_spec,
)


def enable_compile_cache(min_compile_secs=2.0):
    """Turn on JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and this only sets the minimum compile time worth caching;
    otherwise the cache goes to ``.jax_cache`` at the root of the checkout
    (listed in .gitignore).  A fixed path matters: it is part of the
    cache's key.  Call before the first jit dispatch; returns the cache
    directory.
    """
    import os as _os
    import jax as _jax
    path = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache")
        _os.makedirs(path, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", path)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs",
                       float(min_compile_secs))
    return path

# -*- coding: utf-8 -*-
"""Problem builders and meshes shared by the sharded-solve tests
(test_sharded_2d.py, test_sharded_3d.py, test_sharded_fuzz.py)."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from xinvert_tpu import stencil


def mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def mesh_yx(my, mx):
    return mesh((my, mx), ("y", "x"))


def mesh_byx(b, my, mx):
    return mesh((b, my, mx), ("batch", "y", "x"))


def prob2d(ny, nx, bcs, cross=False, mask=True, seed=0, B=0, rng=None):
    rng = np.random.default_rng(seed) if rng is None else rng
    A = np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5
    Bc = rng.normal(0, 0.2, (ny, nx)) if cross else 0.0
    C = np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5
    F = rng.normal(0, 1, ((B,) if B else ()) + (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    if mask:
        Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    spec = stencil.standard_2d(
        jnp.asarray(A), Bc if not cross else jnp.asarray(Bc),
        jnp.asarray(C), jnp.asarray(F), jnp.asarray(Fdef), (1.3, 1.0), bcs)
    return spec, jnp.zeros(((B,) if B else ()) + (ny, nx))


def prob_bih(ny, nx, bcs, B=0, seed=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    Z = np.zeros((ny, nx))
    D = -np.abs(rng.normal(1, 0.1, (ny, nx))) * 1e-2
    J = rng.normal(0, 1, ((B,) if B else ()) + (ny, nx))
    spec = stencil.general_2d_bih(
        *(jnp.asarray(a) for a in (A, Z, A, D, Z, D, Z, Z, Z)),
        jnp.asarray(J), jnp.ones((ny, nx), bool), (1.1, 1.0), bcs)
    return spec, jnp.zeros(((B,) if B else ()) + (ny, nx))


def prob3d(nz, ny, nx, bcs, B=0, seed=0, mask=True, general=False):
    rng = np.random.default_rng(seed)
    sh = (nz, ny, nx)
    A = (np.abs(rng.normal(1.0, 0.1, sh)) + 0.5) * 2e-2
    Bc = np.abs(rng.normal(1.0, 0.1, sh)) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, sh)) + 0.5
    F = rng.normal(0.0, 1.0, ((B,) if B else ()) + sh)
    Fdef = np.ones(sh, bool)
    if mask:
        Fdef[nz // 3:nz // 2 + 1, ny // 4:ny // 2, nx // 4:nx // 2] = False
    if general:
        D, E, Fx = (rng.normal(0, 1e-3, sh) for _ in range(3))
        G = -np.abs(rng.normal(1e-3, 1e-4, sh))
        spec = stencil.general_3d(*map(jnp.asarray, (A, Bc, C, D, E, Fx, G,
                                                     F)),
                                  jnp.asarray(Fdef), (0.5, 1.1, 1.0), bcs)
    else:
        spec = stencil.standard_3d(jnp.asarray(A), jnp.asarray(Bc),
                                   jnp.asarray(C), jnp.asarray(F),
                                   jnp.asarray(Fdef), (0.5, 1.1, 1.0), bcs)
    return spec, jnp.zeros(((B,) if B else ()) + sh)


def close(out, ref, rtol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))

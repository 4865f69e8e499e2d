# -*- coding: utf-8 -*-
"""3-D QG-omega inversion on the synthesized atmosphere (the reference's
atmos3D.nc workload shape: 37 lev x 72 lat x 144 lon; tests/test_OmegaEq.py
structure with N2 profile, periodic x, and topographic icbc)."""
import numpy as np
import pytest

from xinvert_tpu import open_dataset, invert_omega

DATA = "Data/atmos3d_like.nc"


@pytest.fixture(scope="module")
def atmos3d():
    import os
    if not os.path.exists(DATA):
        import subprocess, sys
        subprocess.run([sys.executable, "tools/make_fixtures.py"], check=True)
    return open_dataset(DATA)


IPARAMS = {"BCs": ["fixed", "fixed", "periodic"], "tolerance": 1e-12,
           "mxLoop": 2000, "printInfo": False}


def test_omega_3d(atmos3d):
    W = invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                     iParams=IPARAMS, mParams={"N2": atmos3d.N2prof})
    assert W.dims == atmos3d.F.dims
    assert W.shape == atmos3d.F.shape
    v = W.values
    assert np.isfinite(v).all()
    # forcing is mid-latitude wave train; response is too (energy in the
    # 30-60 degree bands dominates the tropics)
    lat = atmos3d.F.coords["lat"]
    mid = (np.abs(lat) > 30) & (np.abs(lat) < 60)
    trop = np.abs(lat) < 15
    assert np.abs(v[:, mid]).mean() > 3 * np.abs(v[:, trop]).mean()

    # linearity of the inversion
    W2 = invert_omega(atmos3d.F * 2.0, dims=["LEV", "lat", "lon"],
                      iParams=IPARAMS, mParams={"N2": atmos3d.N2prof})
    scale = np.abs(v).max()
    assert np.abs(W2.values - 2.0 * v).max() < 1e-5 * scale


def test_omega_3d_golden(atmos3d):
    """Frozen-value regression on the synthetic fixture (the reference pins
    WQG extrema on its stripped atmos3D.nc, tests/test_OmegaEq.py:100-105;
    this is the equivalent oracle for the synthesized workload).  Goldens
    from the f64 CPU run (round 2): 178 sweeps -> 4.2e-13."""
    from xinvert_tpu.models import api
    W = invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                     iParams=IPARAMS, mParams={"N2": atmos3d.N2prof})
    r = api.LAST_SOLVE
    assert int(r.iters) < 400
    assert float(r.rel_change) < 1e-12
    v = W.values
    assert np.isclose(v.min(), -9.2235775957, rtol=1e-6)
    assert np.isclose(v.max(), 9.2509417407, rtol=1e-6)
    assert np.isclose(np.abs(v).sum(), 3.6570388548e5, rtol=1e-6)


def test_omega_3d_icbc(atmos3d):
    """Topographic lower boundary via icbc (tests/test_OmegaEq.py:83-98)."""
    W0 = invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                      iParams=IPARAMS, mParams={"N2": atmos3d.N2prof})
    Wt = invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                      icbc=atmos3d.WBC, iParams=IPARAMS,
                      mParams={"N2": atmos3d.N2prof})
    # boundary level holds the imposed pattern; interior responds
    assert np.allclose(Wt.values[-1], atmos3d.WBC.values[-1])
    assert not np.allclose(Wt.values[18], W0.values[18])


def test_omega_scalar_vs_profile_n2(atmos3d):
    Wp = invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                      iParams=IPARAMS, mParams={"N2": 2e-5})
    assert np.isfinite(Wp.values).all()
    with pytest.raises(ValueError):
        bad = atmos3d.N2prof.copy()
        bad.values[5] = -1.0
        invert_omega(atmos3d.F, dims=["LEV", "lat", "lon"],
                     iParams=IPARAMS, mParams={"N2": bad})


def test_omega_3d_deep_73_levels(atmos3d):
    """The reference notebook's deep-atmosphere variant interpolates the
    37-level case to 73 levels (11_Omega_equation.ipynb); run the inversion
    end-to-end at that depth."""
    from xinvert_tpu import Field
    from xinvert_tpu.models import api

    F37 = atmos3d.F.values
    lev = np.asarray(atmos3d.F.coords["LEV"], float)
    lat = atmos3d.F.coords["lat"]
    lon = atmos3d.F.coords["lon"]
    lev73 = np.linspace(lev[0], lev[-1], 73)
    t = (lev73 - lev[0]) / (lev[-1] - lev[0]) * (len(lev) - 1)
    i0 = np.clip(np.floor(t).astype(int), 0, len(lev) - 2)
    fr = (t - i0)[:, None, None]
    F73 = F37[i0] * (1 - fr) + F37[i0 + 1] * fr
    n2 = np.asarray(atmos3d.N2prof.values, float)
    N73 = n2[i0] * (1 - fr[:, 0, 0]) + n2[i0 + 1] * fr[:, 0, 0]

    Ff = Field(F73, ("LEV", "lat", "lon"),
               {"LEV": lev73, "lat": lat, "lon": lon})
    Nf = Field(N73, ("LEV",), {"LEV": lev73})
    W = invert_omega(Ff, dims=["LEV", "lat", "lon"],
                     iParams={"BCs": ["fixed", "fixed", "periodic"],
                              "tolerance": 1e-9, "mxLoop": 800,
                              "printInfo": False},
                     mParams={"N2": Nf})
    r = api.LAST_SOLVE
    assert int(r.iters) < 800 and float(r.rel_change) < 1e-9
    v = W.values
    assert v.shape == (73, 72, 144) and np.isfinite(v).all()
    # the mid-latitude wave-train response structure survives the deep grid
    latv = np.asarray(lat)
    mid = (np.abs(latv) > 30) & (np.abs(latv) < 60)
    trop = np.abs(latv) < 15
    assert np.abs(v[:, mid]).mean() > 3 * np.abs(v[:, trop]).mean()

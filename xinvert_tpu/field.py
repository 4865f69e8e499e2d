#  -*- coding: utf-8 -*-
"""Minimal named-dimension array used at the edges of xinvert_tpu.

The reference framework (miniufo/xinvert) exposes its whole API through
``xarray.DataArray`` (see /root/reference/xinvert/apps.py).  xarray is not a
dependency of this rebuild: the compute core is pure JAX on raw
arrays, and this module provides the small labelled-array adapter the public
API and tests need (dims + 1-D coords + broadcasting arithmetic).  If real
xarray objects are passed to the public API they are duck-type converted via
:func:`as_field`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Field", "as_field", "concat", "zeros_like", "full_like"]


def _asarray(data):
    # Keep jax arrays as-is is tempting, but Field is a host-side container:
    # normalise to numpy so tests and IO behave predictably.  The solver layer
    # converts to jnp at its boundary.
    return np.asarray(data)


class Field:
    """A tiny xarray.DataArray-alike: values + named dims + 1-D coords."""

    __slots__ = ("values", "dims", "coords", "name", "attrs")
    # make numpy defer binary ops (np.ndarray * Field -> Field.__rmul__)
    __array_priority__ = 100

    def __init__(self, values, dims, coords=None, name=None, attrs=None):
        values = _asarray(values)
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        if values.ndim != len(dims):
            raise ValueError(f"values.ndim={values.ndim} != len(dims)={len(dims)}")
        coords = dict(coords or {})
        for d, c in list(coords.items()):
            coords[d] = _asarray(c)
        for d, n in zip(dims, values.shape):
            if d in coords and coords[d].shape != (n,):
                raise ValueError(f"coord {d} has shape {coords[d].shape}, expected ({n},)")
        self.values = values
        self.dims = dims
        self.coords = coords
        self.name = name
        self.attrs = dict(attrs or {})

    # ------------------------------------------------------------------ basic
    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def size(self):
        return self.values.size

    def __len__(self):
        return self.values.shape[0]

    def __repr__(self):
        cs = ", ".join(f"{d}:{n}" for d, n in zip(self.dims, self.shape))
        return f"<Field {self.name or ''} ({cs}) dtype={self.dtype}>\n{self.values!r}"

    def copy(self, deep=True, data=None):
        """xarray-style copy; ``data`` replaces the values (same shape)."""
        if data is not None:
            data = np.asarray(data)
            if data.shape != self.shape:
                raise ValueError(
                    f"replacement data shape {data.shape} != {self.shape}")
            return Field(data, self.dims, dict(self.coords), self.name,
                         dict(self.attrs))
        vals = self.values.copy() if deep else self.values
        return Field(vals, self.dims, dict(self.coords), self.name,
                     dict(self.attrs))

    def rename(self, name):
        return Field(self.values, self.dims, self.coords, name, self.attrs)

    def astype(self, dtype):
        return Field(self.values.astype(dtype), self.dims, self.coords, self.name, self.attrs)

    def item(self):
        return self.values.item()

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, key):
        """field['lat'] -> coordinate Field (xarray style)."""
        if isinstance(key, str):
            if key not in self.coords:
                raise KeyError(key)
            return Field(self.coords[key], (key,), {key: self.coords[key]}, name=key)
        raise TypeError("positional indexing not supported; use isel/sel")

    # -------------------------------------------------------------- selection
    def isel(self, indexers=None, **kw):
        indexers = dict(indexers or {})
        indexers.update(kw)
        idx = [slice(None)] * self.ndim
        newdims, newcoords = [], {}
        for d in indexers:
            if d not in self.dims:
                raise KeyError(d)
        for ax, d in enumerate(self.dims):
            if d in indexers:
                idx[ax] = indexers[d]
        vals = self.values[tuple(idx)]
        for ax, d in enumerate(self.dims):
            sel = indexers.get(d, slice(None))
            if np.isscalar(sel) or (isinstance(sel, np.ndarray) and sel.ndim == 0) or isinstance(sel, int):
                continue  # dim dropped
            newdims.append(d)
            if d in self.coords:
                newcoords[d] = self.coords[d][sel]
        for d in self.dims:
            if d not in indexers and d in self.coords:
                newcoords[d] = self.coords[d]
        return Field(vals, newdims, newcoords, self.name, self.attrs)

    def sel(self, indexers=None, **kw):
        indexers = dict(indexers or {})
        indexers.update(kw)
        isel = {}
        for d, v in indexers.items():
            c = self.coords[d]
            if isinstance(v, slice):
                lo = -np.inf if v.start is None else v.start
                hi = np.inf if v.stop is None else v.stop
                if lo > hi:
                    lo, hi = hi, lo
                isel[d] = np.where((c >= lo) & (c <= hi))[0]
            else:
                isel[d] = int(np.argmin(np.abs(c - v)))
        return self.isel(isel)

    def squeeze(self):
        keep = [i for i, n in enumerate(self.shape) if n != 1]
        dims = [self.dims[i] for i in keep]
        coords = {d: self.coords[d] for d in dims if d in self.coords}
        return Field(self.values.reshape([self.shape[i] for i in keep]), dims, coords,
                     self.name, self.attrs)

    def transpose(self, *dims):
        axes = [self.dims.index(d) for d in dims]
        return Field(self.values.transpose(axes), dims, self.coords, self.name, self.attrs)

    def expand_dims(self, dim, coord=None, axis=0):
        vals = np.expand_dims(self.values, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = _asarray(coord)
        return Field(vals, dims, coords, self.name, self.attrs)

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, op, reflexive=False):
        if isinstance(other, Field):
            dims, a, b, coords = _broadcast(self, other)
            vals = op(b, a) if reflexive else op(a, b)
            return Field(vals, dims, coords)
        other_arr = np.asarray(other)
        if other_arr.ndim > self.ndim:
            raise ValueError("cannot broadcast unlabeled array with more dims")
        vals = op(other_arr, self.values) if reflexive else op(self.values, other_arr)
        return Field(vals, self.dims, self.coords, self.name, self.attrs)

    def __add__(self, o): return self._binop(o, np.add)
    def __radd__(self, o): return self._binop(o, np.add, True)
    def __sub__(self, o): return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._binop(o, np.subtract, True)
    def __mul__(self, o): return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._binop(o, np.multiply, True)
    def __truediv__(self, o): return self._binop(o, np.divide)
    def __rtruediv__(self, o): return self._binop(o, np.divide, True)
    def __pow__(self, o): return self._binop(o, np.power)
    def __neg__(self): return Field(-self.values, self.dims, self.coords, self.name)
    def __abs__(self): return Field(np.abs(self.values), self.dims, self.coords, self.name)
    def __lt__(self, o): return self._binop(o, np.less)
    def __le__(self, o): return self._binop(o, np.less_equal)
    def __gt__(self, o): return self._binop(o, np.greater)
    def __ge__(self, o): return self._binop(o, np.greater_equal)
    def __eq__(self, o): return self._binop(o, np.equal)          # noqa: D105
    def __ne__(self, o): return self._binop(o, np.not_equal)
    __hash__ = None

    # ------------------------------------------------------------ reductions
    def _reduce(self, fn, dim=None, **kw):
        if dim is None:
            return fn(self.values, **kw)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        vals = fn(self.values, axis=axes, **kw)
        nd = [d for d in self.dims if d not in dims]
        nc = {d: self.coords[d] for d in nd if d in self.coords}
        return Field(vals, nd, nc, self.name)

    def mean(self, dim=None, **kw): return self._reduce(np.nanmean, dim, **kw)
    def sum(self, dim=None, **kw): return self._reduce(np.nansum, dim, **kw)
    def min(self, dim=None, **kw): return self._reduce(np.nanmin, dim, **kw)
    def max(self, dim=None, **kw): return self._reduce(np.nanmax, dim, **kw)
    def std(self, dim=None, **kw): return self._reduce(np.nanstd, dim, **kw)

    # ---------------------------------------------------------- differencing
    def shift(self, shifts=None, **kw):
        """xarray-style shift: positive shift moves values toward higher index,
        filling vacated entries with NaN."""
        shifts = dict(shifts or {})
        shifts.update(kw)
        vals = self.values.astype(float) if not np.issubdtype(self.dtype, np.floating) else self.values.copy()
        for d, s in shifts.items():
            ax = self.dims.index(d)
            vals = np.roll(vals, s, axis=ax)
            idx = [slice(None)] * self.ndim
            if s > 0:
                idx[ax] = slice(0, s)
            elif s < 0:
                idx[ax] = slice(s, None)
            else:
                continue
            vals[tuple(idx)] = np.nan
        return Field(vals, self.dims, self.coords, self.name)

    def diff(self, dim, n=1):
        ax = self.dims.index(dim)
        vals = np.diff(self.values, n=n, axis=ax)
        coords = dict(self.coords)
        if dim in coords:
            coords[dim] = coords[dim][n:]
        return Field(vals, self.dims, coords, self.name)

    def differentiate(self, dim):
        """Central differences w.r.t. the coordinate (xarray.differentiate)."""
        ax = self.dims.index(dim)
        vals = np.gradient(self.values, self.coords[dim], axis=ax)
        return Field(vals, self.dims, self.coords, self.name)

    def pad(self, widths, mode="constant", constant_values=0.0):
        """Pad along named dims; coords are linearly extrapolated."""
        pw = [(0, 0)] * self.ndim
        for d, w in widths.items():
            pw[self.dims.index(d)] = w
        if mode == "constant":
            vals = np.pad(self.values, pw, mode=mode, constant_values=constant_values)
        else:
            vals = np.pad(self.values, pw, mode=mode)
        coords = dict(self.coords)
        for d, (lo, hi) in widths.items():
            if d in coords and (lo or hi):
                c = coords[d]
                step_lo = c[1] - c[0]
                step_hi = c[-1] - c[-2]
                pre = c[0] - step_lo * np.arange(lo, 0, -1)
                post = c[-1] + step_hi * np.arange(1, hi + 1)
                coords[d] = np.concatenate([pre, c, post])
        return Field(vals, self.dims, coords, self.name)

    # --------------------------------------------------------------- masking
    def where(self, cond, other=np.nan):
        cond_v = cond.values if isinstance(cond, Field) else np.asarray(cond)
        if isinstance(cond, Field) and cond.dims != self.dims:
            dims, a, b, coords = _broadcast(self, cond)
            other_v = other.values if isinstance(other, Field) else other
            return Field(np.where(b, a, other_v), dims, coords, self.name)
        other_v = other.values if isinstance(other, Field) else other
        return Field(np.where(cond_v, self.values, other_v), self.dims, self.coords, self.name)

    def fillna(self, value):
        return Field(np.where(np.isnan(self.values), value, self.values),
                     self.dims, self.coords, self.name)

    def isnull(self):
        return Field(np.isnan(self.values), self.dims, self.coords, self.name)


def _broadcast(a: Field, b: Field):
    """Align two Fields by dim names (xarray broadcasting by-name)."""
    dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    av = _expand(a, dims)
    bv = _expand(b, dims)
    coords = {}
    for d in dims:
        if d in a.coords:
            coords[d] = a.coords[d]
        elif d in b.coords:
            coords[d] = b.coords[d]
    return tuple(dims), av, bv, coords


def _expand(f: Field, dims):
    """Return f.values transposed/reshaped to the given dim order."""
    cur = [d for d in dims if d in f.dims]
    vals = np.transpose(f.values, [f.dims.index(d) for d in cur])
    shape = [f.shape[f.dims.index(d)] if d in f.dims else 1 for d in dims]
    return vals.reshape(shape)


def as_field(obj, dims=None, coords=None, name=None):
    """Coerce Field / xarray.DataArray / ndarray to a Field."""
    if isinstance(obj, Field):
        return obj
    if hasattr(obj, "dims") and hasattr(obj, "values") and hasattr(obj, "coords"):
        # duck-typed xarray.DataArray
        cs = {}
        for d in obj.dims:
            if d in obj.coords:
                cs[d] = np.asarray(obj.coords[d].values)
        return Field(np.asarray(obj.values), tuple(obj.dims), cs,
                     getattr(obj, "name", None))
    arr = np.asarray(obj)
    if dims is None:
        raise ValueError("dims required when passing a raw array")
    return Field(arr, dims, coords, name)


def concat(fields, dim, coord=None):
    """Concatenate along a (possibly new) dimension."""
    fields = list(fields)
    f0 = fields[0]
    if dim in f0.dims:
        ax = f0.dims.index(dim)
        vals = np.concatenate([f.values for f in fields], axis=ax)
        coords = dict(f0.coords)
        if all(dim in f.coords for f in fields):
            coords[dim] = np.concatenate([f.coords[dim] for f in fields])
        return Field(vals, f0.dims, coords, f0.name)
    vals = np.stack([f.values for f in fields], axis=0)
    dims = (dim,) + f0.dims
    coords = dict(f0.coords)
    if coord is not None:
        coords[dim] = _asarray(coord)
    return Field(vals, dims, coords, f0.name)


def zeros_like(f: Field):
    return Field(np.zeros_like(f.values), f.dims, f.coords, f.name)


def full_like(f: Field, v):
    return Field(np.full_like(f.values, v), f.dims, f.coords, f.name)

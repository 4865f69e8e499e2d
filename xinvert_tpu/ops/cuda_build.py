# -*- coding: utf-8 -*-
"""Build and register the CUDA kernels (csrc/*.cu) for the XLA FFI.

The shared library is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``_build/`` beside this file (listed in .gitignore), once per source
version: its name carries a hash of the source and the flags, so an edited
kernel rebuilds and an unchanged one loads at once.  Build it ahead of the
first solve with::

    python -m xinvert_tpu.ops.cuda_build

A missing ``nvcc`` or a failed build raises; nothing falls back to XLA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load_sor2d"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "sor2d.cu"
BUILD_DIR = _HERE / "_build"
# --fmad=false: no contraction of a*b+c into one rounding, so the kernel
# rounds exactly as XLA's sweep does and the two agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    the toolkit's default install directory."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``_build/`` (if not built already) and
    return the library's path."""
    import jax.ffi
    include = jax.ffi.include_dir()
    key = hashlib.sha256(source.read_bytes() + " ".join(
        NVCC_FLAGS + (include,)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", include, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_sor2d():
    """Load the 2-D SOR kernel and register it as the FFI target
    ``xinvert_sor2d`` on the CUDA platform (once per process)."""
    global _lib
    if _lib is None:
        import jax
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            "xinvert_sor2d", jax.ffi.pycapsule(lib.XinvertSor2d),
            platform="CUDA")
        _lib = lib
    return _lib


if __name__ == "__main__":
    print(build())

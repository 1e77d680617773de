"""Native (C++) runtime components, loaded via ctypes.

The compute path is jax/XLA; the serialization hot loops around it
are native C++ (csrc/), compiled on demand with g++ into a cached shared
library. Everything here degrades gracefully: if the toolchain or the build
is unavailable, callers fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
# built into the checkout (listed in .gitignore), never outside it
_CACHE = os.environ.get(
    "NSTPU_NATIVE_CACHE",
    os.path.join(os.path.dirname(__file__), "..", "..", ".native_build"),
)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    src = os.path.abspath(os.path.join(_SRC, "snapshot_codec.cpp"))
    if not os.path.exists(src):
        return None
    os.makedirs(_CACHE, exist_ok=True)
    out = os.path.join(_CACHE, "libsnapshot_codec.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The codec library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.write_vtk_binary.restype = ctypes.c_int
        lib.write_vtk_binary.argtypes = [
            ctypes.c_char_p,                      # path
            ctypes.POINTER(ctypes.c_int),         # dims[3]
            ctypes.POINTER(ctypes.c_double),      # spacing[3]
            ctypes.c_int,                         # n_vec
            ctypes.POINTER(ctypes.c_void_p),      # vec ptrs
            ctypes.c_int,                         # n_scalars
            ctypes.c_char_p,                      # scalar names
            ctypes.POINTER(ctypes.c_void_p),      # scalar ptrs
            ctypes.c_char_p,                      # title
        ]
        _lib = lib
        return _lib


def write_vtk_binary(path, dims, spacing, vec_comps, scalars, title) -> bool:
    """Write a binary VTK file natively. Returns False if unavailable.

    vec_comps: list of C-order float32 arrays (velocity components).
    scalars: dict name -> C-order float32 array.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    dims3 = (ctypes.c_int * 3)(*(list(dims) + [1] * (3 - len(dims))))
    sp3 = (ctypes.c_double * 3)(*(list(spacing) + [1.0] * (3 - len(spacing))))
    vecs = [np.ascontiguousarray(v, dtype=np.float32) for v in vec_comps]
    # reshape 2D fields to (nx, ny, 1) C-order == same memory
    vec_ptrs = (ctypes.c_void_p * max(1, len(vecs)))(
        *[v.ctypes.data_as(ctypes.c_void_p) for v in vecs] or [None]
    )
    scal = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in scalars.items()}
    names = "\n".join(scal.keys()).encode()
    scal_ptrs = (ctypes.c_void_p * max(1, len(scal)))(
        *[v.ctypes.data_as(ctypes.c_void_p) for v in scal.values()] or [None]
    )
    rc = lib.write_vtk_binary(
        path.encode(), dims3, sp3, len(vecs), vec_ptrs, len(scal), names,
        scal_ptrs, title.encode(),
    )
    return rc == 0

"""Native host runtime: the C++ IRT kernel through ctypes.

Counterpart of ``tt_irt_tpu/native/__init__.py``: a CPU executor for the
sampling hot path (the reference's MEX/CTypes layer, python/tt_irt_py/
tt_irt.py + tt_irt1_int32.c), compiled on demand with g++ (OpenMP) and
loaded through ctypes; an independent f64 implementation used to check
the torch samplers.  The source is the JAX package's
``tt_irt_tpu/native/tt_irt_core.cpp``, read where it is and never copied
or edited; the library is built under ``build/native/`` at the root of
the checkout (git-ignored), not beside the source.  A host engine by
design: it takes numpy arrays or CPU tensors.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np
import torch

__all__ = ["tt_irt_native", "native_available", "build_native",
           "NATIVE_LIB"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "tt_irt_tpu", "native", "tt_irt_core.cpp")
NATIVE_LIB = os.path.join(_ROOT, "build", "native", "libttirt.so")
_LOCK = threading.Lock()
_CACHED = {"lib": None, "tried": False}


def build_native(force: bool = False) -> bool:
    """Compile the shared library with g++ into ``NATIVE_LIB`` unless it
    is newer than the source (``force``: always); False if g++ fails or
    is missing."""
    with _LOCK:
        if (os.path.exists(NATIVE_LIB) and not force
                and os.path.getmtime(NATIVE_LIB) >= os.path.getmtime(_SRC)):
            return True
        os.makedirs(os.path.dirname(NATIVE_LIB), exist_ok=True)
        tmp = f"{NATIVE_LIB}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
               "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return False
        os.replace(tmp, NATIVE_LIB)
        _CACHED["lib"] = None
        _CACHED["tried"] = False
        return True


def _load():
    with _LOCK:
        if _CACHED["lib"] is not None or _CACHED["tried"]:
            return _CACHED["lib"]
        _CACHED["tried"] = True
    if not build_native():
        return None
    try:
        lib = ctypes.CDLL(NATIVE_LIB)
    except OSError:
        return None
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.tt_irt_native.restype = ctypes.c_int
    lib.tt_irt_native.argtypes = [ctypes.c_int, ctypes.c_int, i64, i64, f64,
                                  f64, ctypes.c_int64, f64, f64, f64]
    with _LOCK:
        _CACHED["lib"] = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        if a.device.type != "cpu":
            raise ValueError("tt_irt_native is a host engine: pass numpy "
                             f"arrays or CPU tensors, got {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=np.float64)


def tt_irt_native(grids, tt, q, mode: str = "sqr"):
    """Run the native IRT: (grids, TT, seeds) -> (samples, log density),
    numpy f64.

    mode: 'lin' (density TT) or 'sqr' (sqrt-density TT).  Grids must
    contain the boundary points; cores missing boundaries are
    extrapolated as the torch samplers do (``samplers.irt._canon_grid``).
    The TT's cores lie on the CPU."""
    from ..samplers.irt import _canon_grid

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    for c in tt.cores:
        _host(c)
    if isinstance(grids, (list, tuple)):
        grids = [torch.from_numpy(_host(g)) for g in grids]
    else:
        grids = torch.from_numpy(_host(grids))
    gs, tt = _canon_grid(grids, tt)
    d = tt.d
    n = np.asarray(tt.n, dtype=np.int64)
    r = np.asarray(tt.ranks, dtype=np.int64)
    cores = np.concatenate([_host(c).ravel() for c in tt.cores])
    grid_cat = np.concatenate([_host(g) for g in gs])
    q = _host(q)
    m = q.shape[0]
    if q.shape[1] != d:
        raise ValueError("marginal sampling not supported by the native "
                         "kernel; pass full-dimension seeds")
    x_out = np.empty((m, d), dtype=np.float64)
    lf_out = np.empty((m,), dtype=np.float64)
    code = lib.tt_irt_native(0 if mode == "lin" else 1, d, n, r,
                             cores, grid_cat, m, q, x_out, lf_out)
    if code != 0:
        raise RuntimeError(f"native kernel failed with code {code}")
    return x_out, lf_out

"""Native (C++) components, built on demand with g++ and loaded via ctypes.

The exact squared Euclidean distance transform (edt.cpp, a copy of the JAX
package's) used by SDF construction. The library is built into the
ignored `build/gpmp2_tpu_torch/` directory beside the package, keyed by a
hash of the source; a failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR, build_library

__all__ = ["edt"]

_SRC = Path(__file__).resolve().parent / "edt.cpp"
# no -march=native: a built library may be loaded on another host
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256(
                _SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
            so = BUILD_DIR / f"libgpmp2_edt_{digest[:16]}.so"
            if not so.exists():
                build_library(["g++", *_FLAGS, str(_SRC)], so)
            lib = ctypes.CDLL(str(so))
            lib.edt_sq.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.edt_sq.restype = None
            _lib = lib
        return _lib


def edt(occupied: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (in cells) to the nearest True voxel.

    Matches scipy.ndimage.distance_transform_edt(~occupied) semantics:
    distance 0 at occupied voxels."""
    lib = _load()
    occupied = np.ascontiguousarray(occupied, dtype=bool)
    f = np.where(occupied, 0.0, np.inf).astype(np.float64)
    dims = np.asarray(f.shape, dtype=np.int64)
    lib.edt_sq(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(f.ndim),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return np.sqrt(f)

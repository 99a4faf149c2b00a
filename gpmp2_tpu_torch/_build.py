"""Build the port's CUDA kernels at first use and load them with ctypes.

`kernels_lib()` compiles every `csrc/*.cu` with nvcc for Hopper
(`sm_90a`), one nvcc process per source, all started together, and links
the objects into one shared library with a plain C interface, under
`build/gpmp2_tpu_torch/<source hash>/libgpmp2_tpu_torch_kernels.so` beside
the package, and loads it. Nothing is built at import time: the first
CUDA tensor that reaches a kernel wrapper triggers the build, so the
package imports on machines without a CUDA toolkit. A failed build raises
with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "build_library", "kernels_lib", "check"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gpmp2_tpu_torch"
_LIB_NAME = "libgpmp2_tpu_torch_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of csrc/*.cu; every launcher returns a cudaError_t as int
_SIGNATURES = {
    # D, U, b, lam, x, G, B, n, m, scale, f64, stream
    "gpmp2_btsolve": [_P] * 6 + [_I] * 5 + [_P],
    # m, f64, out {threads, shared bytes}
    "gpmp2_btsolve_plan": [_I, _I, _IP],
    # q, consts, base, scent, link_ids, centers, J, N, d, S, f64, stream
    "gpmp2_fk_arm": [_P] * 7 + [_I] * 4 + [_P],
    # d, S, f64, out {configurations per block, threads, shared bytes}
    "gpmp2_fk_arm_plan": [_I, _I, _I, _IP],
    # pts, stride, table, origin, cell, out, ok, N, queries_per_world, nz,
    # rows, cols, dim, layout, storage, f64, screen, thresh, n_thresh,
    # screen table, coarse cell, screen shape (3), scratch, stream
    "gpmp2_sdf_lookup": ([_P, _I] + [_P] * 5 + [_L] * 2 + [_I] * 8 + [_P, _L] + [_P] * 2
                         + [_I] * 3 + [_P] * 2),
    # operand pointers (26), B, n, d, S, T, goal_prior, f64, stream
    "gpmp2_assemble_vec": [_P] + [_I] * 7 + [_P],
    # d, S, T, f64, out {states a chunk, threads, shared bytes}
    "gpmp2_assemble_vec_plan": [_I] * 4 + [_IP],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "gpmp2_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels are built from csrc/ at first use")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME


def build_library(cmd, out: Path) -> None:
    """Run the compiler command `cmd` with `-o` appended, building `out`.

    The library is written under a temporary name and renamed, so
    concurrent processes never load a half-written file. A failed build
    raises with the compiler's stderr."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"gpmp2_tpu_torch: building {out.name} failed "
                f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _compile_objects(nvcc: str, sources, obj_dir: Path):
    """Compile each source to an object, all nvcc processes at once."""
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("gpmp2_tpu_torch: nvcc failed on " + "\n".join(failed))
    return [str(obj) for _, obj, _ in procs]


def kernels_lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                nvcc = _nvcc()
                cu = [s for s in _sources() if s.suffix == ".cu"]
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    objs = _compile_objects(nvcc, cu, Path(tmp))
                    build_library([nvcc, *_ARCH, "-shared", *objs], path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.gpmp2_error_string.argtypes = [_I]
            lib.gpmp2_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = kernels_lib().gpmp2_error_string(rc).decode()
        raise RuntimeError(f"gpmp2_tpu_torch: {what} failed: {msg} ({rc})")

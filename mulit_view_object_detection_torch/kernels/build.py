"""Build and load the port's CUDA kernels.

The sources in `csrc/` are compiled by nvcc at first use, one nvcc per
source, all started together, and linked into one shared library with a
plain C interface under `build/kernels/` at the root of the checkout,
loaded with ctypes. The file name carries a
hash of the sources and flags, so an edited source is rebuilt. A failed
build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # csrc/unproject.cu: feats, x, y, out, b, v, fh, fw, c, n, relu, vec,
    # gx, vy, is_bf16, stream
    "mvod_unproject_fused": [_P] * 4 + [_I] * 11 + [_P],
    # grid, xg, yg, iz (host), out, b, nx, ny, nz, c, s_d, npix, vec, gx,
    # vy, is_bf16, stream
    "mvod_reproject_nearest": [_P] * 5 + [_I] * 11 + [_P],
    # g, saved, x, y, acc, dfeats, b, v, fh, fw, c, n, relu, gx, lanes,
    # chunk, is_bf16, stream
    "mvod_unproject_fused_bwd": [_P] * 6 + [_I] * 11 + [_P],
    # g, xg, yg, iz (host), dgrid, b, nx, ny, nz, c, s_d, npix, vec, gx,
    # items, chunk, is_bf16, stream
    "mvod_reproject_nearest_bwd": [_P] * 5 + [_I] * 12 + [_P],
}


def find_nvcc():
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels cannot be built on this host")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"libmvod_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile csrc/*.cu into library_path(): one nvcc per source, all
    started together, then one link. Returns nvcc's output."""
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        log = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so, target)
    return "".join(log) + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if it is missing."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")

"""Build the port's native sources at first use and load them with ctypes.

Two sources live in seaweedfs_tpu_torch/csrc/:

- gf2_apply.cu: the CUDA kernels behind its two entry points (nvcc,
  `-gencode arch=compute_90a,code=sm_90a`), a plain C interface with no
  PyTorch headers, so it builds in seconds;
- crc32c.cpp: host CRC32C (g++), used by the shard sidecars.

Each library is built into seaweedfs_tpu_torch/build/ (listed in
.gitignore) under a name that carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.
The compiler writes to a private temporary name that is renamed into
place, so concurrent builders (test workers, threads) never load a
half-written file. Nothing is built when the package is imported:
`load` builds on the first call that needs a library, and `build_all`
starts every compiler at once (chip_smoke.py does this as set-up).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_SOURCES = {"gf2_apply": "gf2_apply.cu", "crc32c": "crc32c.cpp"}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, the default toolkit location, or PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return found


def _command(name: str) -> tuple[list[str], Path]:
    src = CSRC_DIR / _SOURCES[name]
    if src.suffix == ".cu":
        compiler, flags = nvcc_path(), NVCC_FLAGS
    else:
        compiler, flags = shutil.which("g++") or "g++", GXX_FLAGS
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    return [compiler, *flags, str(src)], out


def build_all(names=tuple(_SOURCES)) -> dict[str, str]:
    """Compile every library in `names` that is not built yet, all
    compilers running at once. Returns each name's compiler output
    (empty for a library that was already built); raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cmd, out = _command(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [*cmd, "-o", str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            if tmp.exists():
                tmp.unlink()
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return logs


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "gf2_apply":
        fn = lib.gf2_apply
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        fn = lib.gf2_apply_planes
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    else:
        fn = lib.crc32c
        fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint32


def load(name: str) -> ctypes.CDLL:
    """The built library `name` ("gf2_apply" or "crc32c"), building it
    on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_command(name)[1]))
            _bind(name, lib)
            _loaded[name] = lib
    return lib

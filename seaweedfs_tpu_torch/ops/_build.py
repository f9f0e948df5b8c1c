"""Build the port's native sources at first use and load them with ctypes.

Three sources live in seaweedfs_tpu_torch/csrc/:

- gf2_apply.cu: the CUDA kernels behind its two entry points (nvcc,
  `-gencode arch=compute_90a,code=sm_90a`), a plain C interface with no
  PyTorch headers, so it builds in seconds;
- seaweed_native.cpp: the host library (g++, `-pthread`): the byte
  plane (CRC32C, batched positioned reads with an inline CRC, the
  stateful shard sink), the network byte plane's socket calls (with
  the helpers of csrc/sn_net.h) and the GF(2^8) apply of the native CPU
  backend (utils/native.py binds it);
- fastread.cpp: the volume server's bulk-read sidecar (g++, `-pthread`),
  a Unix-socket sendfile server over csrc/sn_net.h (utils/fastread.py
  binds it).

Each library is built into seaweedfs_tpu_torch/build/ (listed in
.gitignore) under a name that carries a hash of its source, the headers
of csrc/ and the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
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
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

_SOURCES = {"gf2_apply": "gf2_apply.cu", "seaweed_native": "seaweed_native.cpp",
            "fastread": "fastread.cpp"}

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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
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


_c = ctypes
_P = ctypes.c_void_p
# restype and argtypes of every exported function, per library.
_SIGNATURES = {
    "gf2_apply": {
        "gf2_apply": (_c.c_int, [_P, _c.c_int, _c.c_int, _P, _c.c_int64, _P, _c.c_int, _P]),
        "gf2_apply_planes": (
            _c.c_int, [_P, _c.c_int, _c.c_int, _c.c_int, _P, _c.c_int64, _P, _c.c_int, _P],
        ),
    },
    "seaweed_native": {
        "sn_crc32c": (_c.c_uint32, [_c.c_uint32, _P, _c.c_size_t]),
        "sn_crc32c_combine": (_c.c_uint32, [_c.c_uint32, _c.c_uint32, _c.c_uint64]),
        # fds, offsets, nrows, dst, width, stride, pad_eof, granule,
        # crc_state, filled_state, out_crcs, out_counts, max_out
        "sn_batch_pread": (_c.c_int, [
            _c.POINTER(_c.c_int), _c.POINTER(_c.c_uint64), _c.c_int, _P, _c.c_size_t,
            _c.c_size_t, _c.c_int, _c.c_uint32, _P, _P, _P, _P, _c.c_int32,
        ]),
        "sn_fadvise_willneed": (_c.c_int, [_c.c_int, _c.c_uint64, _c.c_uint64]),
        # fds, n, block_size, leaf_size, flags
        "sn_sink_create": (_P, [
            _c.POINTER(_c.c_int), _c.c_int, _c.c_uint32, _c.c_uint32, _c.c_uint32,
        ]),
        # handle, rows, width, out block crcs and counts, out leaf crcs
        # and counts, max_out
        "sn_sink_append": (_c.c_int, [
            _P, _c.POINTER(_P), _c.c_size_t, _P, _P, _P, _P, _c.c_int32,
        ]),
        # handle, tail block crc and valid, tail leaf crc and valid, sizes
        "sn_sink_finish": (_c.c_int, [_P, _P, _P, _P, _P, _P]),
        "sn_sink_direct_flags": (_c.c_int, [_P, _P]),
        "sn_sink_destroy": (None, [_P]),
        # coeffs, out_rows, in_rows, data, out, n
        "sn_rs_apply": (None, [_c.c_char_p, _c.c_int, _c.c_int, _P, _P, _c.c_size_t]),
        # ... and threads
        "sn_rs_apply_mt": (None, [_c.c_char_p, _c.c_int, _c.c_int, _P, _P, _c.c_size_t, _c.c_int]),
        # body, then sn_rs_apply's arguments
        "sn_rs_apply_body": (
            _c.c_int, [_c.c_int, _c.c_char_p, _c.c_int, _c.c_int, _P, _P, _c.c_size_t],
        ),
        "sn_gf_mul": (_c.c_uint8, [_c.c_uint8, _c.c_uint8]),
        "sn_has_avx2": (_c.c_int, []),
        # out_fd (socket), in_fd (file), offset, len, timeout_ms
        "sn_send_file": (_c.c_int64, [_c.c_int, _c.c_int, _c.c_uint64, _c.c_uint64, _c.c_int]),
        # fd, bufs, lens, n, timeout_ms
        "sn_sendv": (_c.c_int64, [
            _c.c_int, _c.POINTER(_P), _c.POINTER(_c.c_uint64), _c.c_int, _c.c_int,
        ]),
        # fd, dst, len, timeout_ms, granule, crc_state, filled_state,
        # out_crcs, out_count, max_out, overlap_mode
        "sn_recv_into": (_c.c_int64, [
            _c.c_int, _P, _c.c_uint64, _c.c_int, _c.c_uint32, _P, _P, _P, _P, _c.c_int32,
            _c.c_int32,
        ]),
        # fd (socket), out_fd (file), offset, len, timeout_ms, crc_out
        "sn_recv_file": (_c.c_int64, [_c.c_int, _c.c_int, _c.c_uint64, _c.c_uint64, _c.c_int, _P]),
        "sn_recv_overlap_active": (_c.c_int, [_c.c_uint64]),
        "sn_pool_threads": (_c.c_int, []),
        # path, ids, offsets, sizes, crc_ok, max_entries
        "sn_scan_dat": (_c.c_int64, [_c.c_char_p, _P, _P, _P, _P, _c.c_int64]),
    },
    "fastread": {
        # socket_path, root_dir
        "sn_fastread_serve": (_c.c_int, [_c.c_char_p, _c.c_char_p]),
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes


def load(name: str) -> ctypes.CDLL:
    """The built library `name` ("gf2_apply", "seaweed_native" or "fastread"),
    building it on first use. A failed build or load raises."""
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

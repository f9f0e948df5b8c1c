"""Pluggable byte-store backends under a volume, and tiering transfers.

Port of seaweedfs_tpu/storage/backend.py (reference
weed/storage/backend/backend.go, the BackendStorageFile SPI, and the
tiering RPCs weed/server/volume_grpc_tier_upload.go / tier_download.go):
a sealed volume's .dat moves to an object store while the .idx stays
local, and reads become ranged GETs against the cold tier. The remote
backend speaks plain S3-style HTTP (PUT object, ranged GET, HEAD,
DELETE).

The JAX package speaks HTTP through `requests`; the port uses the
standard library (`urllib.request`), since the card's host has no
`requests`. That is a change of HTTP client only, not of behaviour: the
same `Range` headers, a 206 or a 200 (sliced locally) taken the same
way, a short body refused, the same PUT body bounds (`_SizedReader`),
the same status checks and the same `BackendError`s.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request
from typing import BinaryIO

from .. import faults


class BackendError(Exception):
    pass


def _open(url: str, method: str = "GET", headers: dict | None = None, data=None,
          timeout: float = 60):
    """(status, response or error) of one request: an HTTP error status
    is a response to read, not an exception (the callers check the
    status, as they do with `requests`). Transport failures raise
    OSError (`urllib.error.URLError`)."""
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e.code, e
    return resp.status, resp


class BackendStorageFile:
    """Read-side SPI a tiered Volume consumes (reference
    backend.BackendStorageFile ReadAt/WriteAt/Truncate/Close/Name;
    tiered volumes are sealed, so only the read surface is required)."""

    name: str = ""

    def read_at(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class DiskFile(BackendStorageFile):
    """Local-file backend (the default hot tier)."""

    def __init__(self, path: str):
        self.name = path
        self._f = open(path, "rb")

    def read_at(self, offset: int, size: int) -> bytes:
        # fault points: raised IOError / latency, then byte corruption
        # (bit flip, torn read) of the payload itself
        faults.fire("storage.disk.read_at", path=self.name, offset=offset, size=size)
        self._f.seek(offset)
        data = self._f.read(size)
        return faults.mutate("storage.disk.read_at", data, path=self.name, offset=offset, size=size)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def close(self) -> None:
        self._f.close()


class S3RemoteFile(BackendStorageFile):
    """Ranged-GET reader against an S3-style object URL
    (http://host:port/bucket/key)."""

    def __init__(self, url: str):
        self.name = url
        self._size: int | None = None

    def read_at(self, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        faults.fire("storage.remote.read_at", url=self.name, offset=offset, size=size)
        status, r = _open(self.name, headers={"Range": f"bytes={offset}-{offset + size - 1}"},
                          timeout=60)
        with r:
            if status not in (200, 206):
                raise BackendError(
                    f"cold-tier read {self.name} [{offset}:{offset+size}]: HTTP {status}"
                )
            data = r.read()
        if status == 200:
            # the endpoint ignored Range: slice locally
            data = data[offset : offset + size]
        data = faults.mutate("storage.remote.read_at", data, url=self.name, offset=offset,
                             size=size)
        if len(data) < size:
            raise BackendError(f"cold-tier short read {self.name}: {len(data)} < {size}")
        return data

    def size(self) -> int:
        if self._size is None:
            status, r = _open(self.name, method="HEAD", timeout=30)
            with r:
                if status != 200:
                    raise BackendError(f"cold-tier stat {self.name}: HTTP {status}")
                self._size = int(r.headers.get("Content-Length", "0"))
        return self._size


def open_backend_file(url: str) -> BackendStorageFile:
    if url.startswith(("http://", "https://")):
        return S3RemoteFile(url)
    return DiskFile(url)


# ------------------------------------------------------------- transfers

_CHUNK = 8 * 1024 * 1024


class _SizedReader:
    """File-like body with a known length, sent with a plain
    Content-Length (never chunked alongside it, which strict S3
    endpoints reject). Every read is clamped to ``_CHUNK``, so a
    multi-GiB PUT never holds more than one bounded chunk whatever the
    HTTP stack asks for; a source that runs dry before `size` bytes
    raises instead of sending a short body the endpoint would stall on."""

    def __init__(self, f: BinaryIO, size: int):
        self._f = f
        self._remaining = size
        self._size = size

    def __len__(self) -> int:
        return self._size

    def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n is None or n < 0:
            n = self._remaining
        piece = self._f.read(min(n, self._remaining, _CHUNK))
        if not piece:
            raise BackendError(
                f"upload source truncated: {self._remaining} of {self._size} bytes still owed"
            )
        self._remaining -= len(piece)
        return piece


def put_object(url: str, src: BinaryIO, size: int) -> None:
    """Streaming PUT of `size` bytes from `src` to an S3-style URL."""
    # torn-write model: a fault here kills the upload before any byte
    # moves; mid-stream tears truncate _SizedReader's budget, so the
    # endpoint sees a short body and rejects it
    faults.fire("storage.put_object", url=url, size=size)
    status, r = _open(url, method="PUT", data=_SizedReader(src, size),
                      headers={"Content-Length": str(size)}, timeout=3600)
    with r:
        if status >= 300:
            text = r.read()[:200].decode(errors="replace")
            raise BackendError(f"cold-tier upload {url}: HTTP {status} {text}")


def fetch_object(url: str, dest_path: str) -> int:
    """Streaming GET of a cold object into a local file (durable: written
    to a temp, fsynced, renamed)."""
    from ..utils.fs import fsync_dir

    tmp = f"{dest_path}.fetch.{os.getpid()}.{os.urandom(4).hex()}"
    n = 0
    try:
        status, r = _open(url, timeout=3600)
        with r:
            if status != 200:
                raise BackendError(f"cold-tier download {url}: HTTP {status}")
            with open(tmp, "wb") as f:
                while True:
                    piece = r.read(_CHUNK)
                    if not piece:
                        break
                    piece = faults.mutate("storage.fetch_object.chunk", piece, url=url, offset=n)
                    f.write(piece)
                    n += len(piece)
                f.flush()
                faults.fire("storage.fetch_object.before_fsync", url=url, path=dest_path)
                os.fsync(f.fileno())
        faults.fire("storage.fetch_object.before_rename", url=url, path=dest_path)
        os.replace(tmp, dest_path)
    except BaseException:
        # a failed stream must not leak a partial multi-GB temp
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(dest_path)
    return n


def delete_object(url: str) -> None:
    """Best-effort delete of a cold object (after tier.download)."""
    try:
        _status, r = _open(url, method="DELETE", timeout=60)
        r.close()
    except OSError:
        pass

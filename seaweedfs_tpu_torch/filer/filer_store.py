"""FilerStore SPI + embedded backends.

Port of seaweedfs_tpu/filer/filer_store.py, whole (reference
weed/filer/filerstore.go: insert/update/find/delete/list + KV): sqlite
(the reference's abstract_sql schema shape: directory + name + meta blob)
and an in-memory dict store. A row holds the same protobuf bytes as in
the JAX package, so a sqlite file written by either package reads in the
other.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator, Optional, Protocol

from .entry import Entry


class FilerStoreError(Exception):
    pass


class NotFound(FilerStoreError):
    pass


class FilerStore(Protocol):
    def insert(self, entry: Entry) -> None: ...
    def update(self, entry: Entry) -> None: ...
    def find(self, directory: str, name: str) -> Entry: ...
    def delete(self, directory: str, name: str) -> None: ...
    def delete_folder_children(self, directory: str) -> None: ...
    def list(
        self, directory: str, start_from: str = "", limit: int = 1024,
        prefix: str = "",
    ) -> Iterator[Entry]: ...
    def kv_put(self, key: bytes, value: bytes) -> None: ...
    def kv_get(self, key: bytes) -> Optional[bytes]: ...
    def kv_delete(self, key: bytes) -> None: ...
    def kv_put_if_absent(self, key: bytes, value: bytes) -> bytes: ...
    def close(self) -> None: ...


class MemoryStore:
    """Dict-backed store for tests and ephemeral filers."""

    def __init__(self):
        self._dirs: dict[str, dict[str, bytes]] = {}
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert(self, entry: Entry) -> None:
        with self._lock:
            self._dirs.setdefault(entry.directory, {})[entry.name] = entry.to_bytes()

    update = insert

    def find(self, directory: str, name: str) -> Entry:
        with self._lock:
            raw = self._dirs.get(directory, {}).get(name)
        if raw is None:
            raise NotFound(f"{directory}/{name}")
        return Entry.from_bytes(directory, raw)

    def delete(self, directory: str, name: str) -> None:
        with self._lock:
            self._dirs.get(directory, {}).pop(name, None)

    def delete_folder_children(self, directory: str) -> None:
        with self._lock:
            prefix = directory if directory.endswith("/") else directory + "/"
            for d in [d for d in self._dirs if d == directory or d.startswith(prefix)]:
                del self._dirs[d]

    def list(self, directory, start_from="", limit=1024, prefix=""):
        with self._lock:
            names = sorted(self._dirs.get(directory, {}))
        n = 0
        for name in names:
            if name <= start_from if start_from else False:
                continue
            if prefix and not name.startswith(prefix):
                continue
            if n >= limit:
                return
            yield self.find(directory, name)
            n += 1

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_delete(self, key: bytes) -> None:
        with self._lock:
            self._kv.pop(key, None)

    def kv_put_if_absent(self, key: bytes, value: bytes) -> bytes:
        """Atomic create-if-absent; returns the value that WON (the
        existing one, or `value` if the key was unset)."""
        with self._lock:
            return self._kv.setdefault(key, value)

    def close(self) -> None:
        pass


# Imported AFTER NotFound is defined: abstract_sql_store imports it
# back from this module (deliberate one-way-at-runtime cycle).
from .abstract_sql_store import AbstractSqlStore  # noqa: E402


class SqliteStore(AbstractSqlStore):
    """SQLite through the abstract-SQL template (reference
    weed/filer/sqlite riding weed/filer/abstract_sql): one row per
    entry keyed (directory, name), meta = protobuf blob. Any other
    PEP-249 driver is the same subclass shape with its dialect."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self.path = path

        def connect() -> sqlite3.Connection:
            con = sqlite3.connect(path, timeout=30)
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            return con

        super().__init__(connect)

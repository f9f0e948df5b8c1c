"""TUS 1.0 resumable uploads over the filer.

Port of seaweedfs_tpu/filer/tus.py, whole (reference
weed/server/filer_server_tus_*.go: creation, patch, head, termination).
Upload state survives filer restarts: each session is a filer entry at
/.tus/<id> whose extended attrs carry {target, length, offset}; every
PATCH body lands as a chunked part file under /.tus/<id>.parts/, and
completion SPLICES the part chunk lists into the target entry (no data
re-copy).
"""

from __future__ import annotations

import json
import threading
import uuid

from .entry import Entry, new_entry
from .filer import Filer, FilerError
from .filer_store import NotFound

TUS_ROOT = "/.tus"
TUS_VERSION = "1.0.0"
TUS_EXTENSIONS = "creation,termination"


class TusError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(message)


class TusManager:
    def __init__(self, filer: Filer):
        self.filer = filer
        # serializes PATCH application per manager: a retried duplicate
        # final PATCH must not double-run completion (which would GC
        # the chunks the first completion's target references)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ state

    def _session_path(self, upload_id: str) -> str:
        if "/" in upload_id or upload_id.startswith("."):
            raise TusError(404, "bad upload id")
        return f"{TUS_ROOT}/{upload_id}"

    def _load(self, upload_id: str) -> tuple[Entry, dict]:
        try:
            entry = self.filer.find_entry(self._session_path(upload_id))
        except NotFound:
            raise TusError(404, "unknown upload") from None
        try:
            state = json.loads(entry.extended.get("tus", b"{}"))
        except ValueError:
            raise TusError(500, "corrupt upload state") from None
        if "offset" not in state or "length" not in state:
            # an entry under /.tus that is not a session (e.g. the
            # .parts directory) must 404, not KeyError the handler
            raise TusError(404, "not an upload session")
        return entry, state

    # ------------------------------------------------------- operations

    def create(self, target_path: str, length: int) -> str:
        if length < 0:
            raise TusError(400, "Upload-Length required")
        try:
            existing = self.filer.find_entry(target_path)
            if existing.is_directory:
                # refuse now, not at the final PATCH: a doomed upload
                # should fail before any bytes move
                raise TusError(409, f"{target_path} is a directory")
        except NotFound:
            pass
        upload_id = uuid.uuid4().hex
        entry = new_entry(self._session_path(upload_id), mode=0o600)
        entry.extended["tus"] = json.dumps(
            {"target": target_path, "length": length, "offset": 0}
        ).encode()
        self.filer.create_entry(entry)
        return upload_id

    def head(self, upload_id: str) -> dict:
        _entry, state = self._load(upload_id)
        return state

    def patch(self, upload_id: str, offset: int, data: bytes) -> int:
        """Returns the new offset; completes the upload when the final
        byte lands. Serialized: concurrent duplicate PATCHes (client
        retries) must not double-complete."""
        with self._lock:
            _entry, state = self._load(upload_id)
            if offset != state["offset"]:
                raise TusError(409, f"offset mismatch (have {state['offset']})")
            if offset + len(data) > state["length"]:
                raise TusError(413, "body exceeds Upload-Length")
            new_offset = offset + len(data)
            if data:
                # parts are forced to chunked storage: completion
                # splices chunk lists, which inlined content lacks
                self.filer.write_file(
                    f"{self._session_path(upload_id)}.parts/{offset:020d}", data, inline=False)
            if new_offset == state["length"]:
                # complete FIRST; only then persist/advance — a failed
                # completion leaves the offset at the previous value so
                # the client's retry re-lands the final part
                state["offset"] = new_offset
                self._complete(upload_id, state)
            elif data:
                state["offset"] = new_offset
                self._store_state(upload_id, state)
            return new_offset

    def terminate(self, upload_id: str) -> None:
        self._load(upload_id)  # 404 if unknown
        self.filer.delete_entry(f"{self._session_path(upload_id)}.parts", recursive=True)
        self.filer.delete_entry(self._session_path(upload_id))

    # ---------------------------------------------------------- helpers

    def _store_state(self, upload_id: str, state: dict) -> None:
        def mutate(entry: Entry) -> None:
            entry.extended["tus"] = json.dumps(state).encode()

        self.filer.mutate_entry(self._session_path(upload_id), mutate)

    def _complete(self, upload_id: str, state: dict) -> None:
        parts_dir = f"{self._session_path(upload_id)}.parts"
        combined = []
        pos = 0
        for part in self.filer.list_entries(parts_dir, limit=1_000_000):
            for c in self.filer.resolve_chunks(part):
                nc = type(c)()
                nc.CopyFrom(c)
                nc.offset = pos + c.offset
                combined.append(nc)
            pos += part.file_size
        if pos != state["length"]:
            raise TusError(500, "parts do not sum to Upload-Length")
        target = new_entry(state["target"], mode=0o644)
        target.chunks = combined
        target.attr.file_size = pos
        old = None
        try:
            old = self.filer.find_entry(state["target"])
        except NotFound:
            pass
        self.filer.create_entry(target)
        if old is not None:
            self.filer._release_entry_chunks(old)
        # drop part ENTRIES but keep their chunks: the target owns them now
        for part in list(self.filer.list_entries(parts_dir, limit=1_000_000)):
            self.filer.delete_entry(part.full_path, gc_chunks=False)
        try:
            self.filer.delete_entry(parts_dir)
        except FilerError:
            pass
        self.filer.delete_entry(self._session_path(upload_id))

"""Filer entry model: a path in the namespace plus attributes and the
chunk list that backs file content.

Port of seaweedfs_tpu/filer/entry.py, whole: an entry encodes to the same
protobuf bytes in both packages (reference weed/filer/entry.go +
entry_codec.go, protobuf-encoded into the KV store).
"""

from __future__ import annotations

import stat
import time
from dataclasses import dataclass, field
from typing import Optional

from ..pb import filer_pb2 as fpb


def now_ns() -> int:
    return time.time_ns()


@dataclass
class Entry:
    directory: str  # parent dir, "/" rooted, no trailing slash (except root)
    name: str
    is_directory: bool = False
    chunks: list[fpb.FileChunk] = field(default_factory=list)
    attr: fpb.Attr = field(default_factory=fpb.Attr)
    extended: dict[str, bytes] = field(default_factory=dict)
    content: bytes = b""  # small-file inlining
    # hardlinks (reference filer_hardlink.go): entries sharing one
    # chunk list carry the same id; the live-name count lives in the
    # store's KV so chunk GC runs only when the last name goes
    hard_link_id: bytes = b""
    hard_link_counter: int = 0

    @property
    def full_path(self) -> str:
        if self.directory == "/":
            return "/" + self.name
        return f"{self.directory}/{self.name}"

    @property
    def file_size(self) -> int:
        if self.content:
            return len(self.content)
        if self.attr.file_size:
            return self.attr.file_size
        return max((c.offset + c.size for c in self.chunks), default=0)

    def mode(self) -> int:
        m = self.attr.file_mode
        if self.is_directory and not stat.S_ISDIR(m):
            m |= stat.S_IFDIR
        return m

    # ---- codec ----

    def to_proto(self) -> fpb.Entry:
        e = fpb.Entry(
            name=self.name,
            is_directory=self.is_directory,
            chunks=self.chunks,
            content=self.content,
            hard_link_id=self.hard_link_id,
            hard_link_counter=self.hard_link_counter,
        )
        e.attributes.CopyFrom(self.attr)
        for k, v in self.extended.items():
            e.extended[k] = v
        return e

    def to_bytes(self) -> bytes:
        return self.to_proto().SerializeToString()

    @classmethod
    def from_proto(cls, directory: str, p: fpb.Entry) -> "Entry":
        e = cls(
            directory=directory,
            name=p.name,
            is_directory=p.is_directory,
            chunks=list(p.chunks),
            content=p.content,
            hard_link_id=p.hard_link_id,
            hard_link_counter=p.hard_link_counter,
        )
        e.attr.CopyFrom(p.attributes)
        e.extended = dict(p.extended)
        return e

    @classmethod
    def from_bytes(cls, directory: str, raw: bytes) -> "Entry":
        return cls.from_proto(directory, fpb.Entry.FromString(raw))


def new_entry(
    full_path: str,
    is_directory: bool = False,
    mode: int = 0o644,
    mime: str = "",
) -> Entry:
    directory, _, name = full_path.rstrip("/").rpartition("/")
    e = Entry(directory=directory or "/", name=name, is_directory=is_directory)
    now = int(time.time())
    e.attr.mtime = now
    e.attr.crtime = now
    e.attr.file_mode = mode | (stat.S_IFDIR if is_directory else stat.S_IFREG)
    if mime:
        e.attr.mime = mime
    return e


def split_path(full_path: str) -> tuple[str, str]:
    full_path = normalize_path(full_path)
    if full_path == "/":
        return "/", ""
    directory, _, name = full_path.rpartition("/")
    return directory or "/", name


def normalize_path(p: str) -> str:
    if not p.startswith("/"):
        p = "/" + p
    while "//" in p:
        p = p.replace("//", "/")
    if len(p) > 1 and p.endswith("/"):
        p = p[:-1]
    return p

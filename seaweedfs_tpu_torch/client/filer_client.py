"""Thin filer HTTP helpers shared by every component that walks the
namespace (the shell's fs.* commands).

Port of seaweedfs_tpu/client/filer_client.py (reference weed/filer_client:
the minimal accessor package gateways use), over `http.client` through
`utils/urls.connection` (https with the process's client context where
the cluster speaks it), since the card's host has no `requests`. The
pages and answers are the JAX client's. Where the two differ, on purpose:
the JAX `FilerListingError` subclasses `requests.RequestException`, so
callers with transient-retry wrappers treat listing failures as
retryable; the port's subclasses `OSError`, the base class of the
connection errors `http.client` raises, which such wrappers catch as
well. The JAX functions' `session` (a `requests.Session`) is not taken:
each listing keeps one connection alive across its pages.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Iterator

from ..utils import urls
from ..utils.urls import service_url


class FilerListingError(OSError):
    """A listing that failed: missing, not a directory, or an error
    status. An OSError, so retry wrappers treat it as transient."""


def filer_url(filer: str, path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    return service_url(filer, urllib.parse.quote(path))


def list_dir(filer: str, path: str, strict: bool = False) -> Iterator[dict]:
    """Paginated directory listing (the filer caps pages at 1024).

    strict=True raises FilerListingError when the path is missing or not
    a directory: walkers that report success must not silently skip."""
    url = filer_url(filer, path)
    target = urllib.parse.urlsplit(url).path
    conn = urls.connection(url, 30)
    last = ""
    try:
        while True:
            query = urllib.parse.urlencode({"limit": "1024", "lastFileName": last})
            conn.request("GET", f"{target}?{query}")
            r = conn.getresponse()
            body = r.read()
            if r.status == 404:
                if strict:
                    raise FilerListingError(f"{path}: not found")
                return
            if r.status != 200:
                raise FilerListingError(f"{path}: HTTP {r.status}")
            if r.getheader("X-Filer-Listing") != "true":
                if strict:
                    raise FilerListingError(f"{path}: not a directory")
                return
            page = json.loads(body)
            entries = page.get("Entries", [])
            yield from entries
            if not page.get("ShouldDisplayLoadMore") or not entries:
                return
            last = entries[-1]["FullPath"].rsplit("/", 1)[-1]
    finally:
        conn.close()


def walk(filer: str, root: str, strict: bool = False) -> Iterator[dict]:
    """Depth-first recursive walk yielding every entry under root."""
    stack = [root]
    first = True
    while stack:
        d = stack.pop()
        for e in list_dir(filer, d, strict=strict and first):
            yield e
            if e["IsDirectory"]:
                stack.append(e["FullPath"])
        first = False

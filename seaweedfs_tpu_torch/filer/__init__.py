"""Filer: POSIX-ish metadata namespace over the blob store (layer 5).

Port of seaweedfs_tpu/filer: the core (entries, chunks, manifests, the
three stores, POSIX locks, the meta log, `Filer`), its gRPC service, the
MetaAggregator, TUS uploads (tus.py), the lock ring (lock_ring.py) and
the webhook notifier (notification.py), with the JAX export list. The
HTTP server over it is server/filer_server.py.
"""

from .chunks import ChunkView, read_chunk_views, total_size, visible_intervals
from .entry import Entry, new_entry, normalize_path, split_path
from .filer import DEFAULT_CHUNK_SIZE, Filer, FilerError
from .filer_store import FilerStore, MemoryStore, NotFound, SqliteStore
from .abstract_sql_store import (
    MYSQL_DIALECT,
    POSTGRES_DIALECT,
    AbstractSqlStore,
    SqlDialect,
)
from .sstable_store import SSTableStore

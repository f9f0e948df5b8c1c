"""Generic DB-API FilerStore: any driver drops in via a dialect.

Port of seaweedfs_tpu/filer/abstract_sql_store.py, whole (reference
weed/filer/abstract_sql/abstract_sql_store.go): one SQL shape (directory +
name + meta blob, plus a KV table) shared by the mysql/postgres/sqlite
backends, each contributing only its dialect quirks. The dialect is a
small declarative object: paramstyle + upsert syntax + table DDL; the
store body is written once against it. ``SqliteStore`` in filer_store.py
is the concrete instance; anything with a PEP-249 connection factory is a
~10-line subclass away.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from .entry import Entry
from .filer_store import NotFound


@dataclass
class SqlDialect:
    """Driver quirks. `paramstyle`: qmark (?), format (%s), numbered
    ($1...), or named (:p0...). `upsert`: statement template with
    {table}; must insert-or-replace on the (directory, name) / (k)
    primary key."""

    paramstyle: str = "qmark"
    upsert_meta: str = (
        "INSERT OR REPLACE INTO {table} (directory, name, meta) "
        "VALUES (?,?,?)"
    )
    upsert_kv: str = "INSERT OR REPLACE INTO kv (k, v) VALUES (?,?)"
    insert_ignore_kv: str = "INSERT OR IGNORE INTO kv (k, v) VALUES (?,?)"
    ddl: tuple = (
        "CREATE TABLE IF NOT EXISTS {table} ("
        " directory TEXT NOT NULL,"
        " name TEXT NOT NULL,"
        " meta BLOB,"
        " PRIMARY KEY (directory, name))",
        "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)",
    )
    # escape char for LIKE is unused: prefix ranges use >= / < bounds
    pragmas: tuple = ()


POSTGRES_DIALECT = SqlDialect(
    # psycopg2 / pg8000 are DB-API 'format' drivers (%s placeholders);
    # $N is the raw PG wire syntax, which PEP-249 drivers do not take
    paramstyle="format",
    upsert_meta=(
        "INSERT INTO {table} (directory, name, meta) VALUES (?,?,?) "
        "ON CONFLICT (directory, name) DO UPDATE SET meta = EXCLUDED.meta"
    ),
    upsert_kv=(
        "INSERT INTO kv (k, v) VALUES (?,?) "
        "ON CONFLICT (k) DO UPDATE SET v = EXCLUDED.v"
    ),
    insert_ignore_kv=(
        "INSERT INTO kv (k, v) VALUES (?,?) ON CONFLICT (k) DO NOTHING"
    ),
    ddl=(
        "CREATE TABLE IF NOT EXISTS {table} ("
        " directory TEXT NOT NULL,"
        " name TEXT NOT NULL,"
        " meta BYTEA,"
        " PRIMARY KEY (directory, name))",
        "CREATE TABLE IF NOT EXISTS kv (k BYTEA PRIMARY KEY, v BYTEA)",
    ),
)

MYSQL_DIALECT = SqlDialect(
    paramstyle="format",
    upsert_meta=(
        "REPLACE INTO {table} (directory, name, meta) VALUES (?,?,?)"
    ),
    upsert_kv="REPLACE INTO kv (k, v) VALUES (?,?)",
    insert_ignore_kv="INSERT IGNORE INTO kv (k, v) VALUES (?,?)",
    ddl=(
        "CREATE TABLE IF NOT EXISTS {table} ("
        " directory VARCHAR(512) NOT NULL,"
        " name VARCHAR(255) NOT NULL,"
        " meta LONGBLOB,"
        " PRIMARY KEY (directory, name))",
        "CREATE TABLE IF NOT EXISTS kv ("
        " k VARBINARY(512) PRIMARY KEY, v LONGBLOB)",
    ),
)


class AbstractSqlStore:
    """FilerStore written once against SqlDialect + a PEP-249
    connection factory. Connections are per-thread (most drivers are
    not thread-safe at the connection level)."""

    HIGH = "\U0010ffff"  # above any valid name character

    def __init__(
        self,
        connect: Callable[[], object],
        dialect: SqlDialect | None = None,
        table: str = "filemeta",
    ):
        self.connect = connect
        self.dialect = dialect or SqlDialect()
        self.table = table
        self._local = threading.local()
        con = self._con()
        cur = con.cursor()
        for stmt in self.dialect.ddl:
            cur.execute(stmt.format(table=self.table))
        for stmt in self.dialect.pragmas:
            cur.execute(stmt)
        con.commit()

    # ------------------------------------------------------- plumbing

    def _con(self):
        con = getattr(self._local, "con", None)
        if con is None:
            con = self.connect()
            self._local.con = con
        return con

    def _sql(self, q: str) -> str:
        """Adapt the canonical qmark text to the driver's paramstyle."""
        style = self.dialect.paramstyle
        if style == "qmark":
            return q
        if style == "format":
            return q.replace("?", "%s")
        if style == "numbered":
            out, i = [], 0
            for ch in q:
                if ch == "?":
                    i += 1
                    out.append(f"${i}")
                else:
                    out.append(ch)
            return "".join(out)
        if style == "named":
            out, i = [], 0
            for ch in q:
                if ch == "?":
                    out.append(f":p{i}")
                    i += 1
                else:
                    out.append(ch)
            return "".join(out)
        raise ValueError(f"unknown paramstyle {style!r}")

    def _params(self, params: tuple):
        if self.dialect.paramstyle == "named":
            return {f"p{i}": v for i, v in enumerate(params)}
        return params

    def _exec(self, con, q: str, params: tuple = ()):
        cur = con.cursor()
        cur.execute(self._sql(q), self._params(params))
        return cur

    # ------------------------------------------------- FilerStore SPI

    def insert(self, entry: Entry) -> None:
        con = self._con()
        self._exec(
            con,
            self.dialect.upsert_meta.format(table=self.table),
            (entry.directory, entry.name, entry.to_bytes()),
        )
        con.commit()

    update = insert

    def find(self, directory: str, name: str) -> Entry:
        row = self._exec(
            self._con(),
            f"SELECT meta FROM {self.table} WHERE directory=? AND name=?",
            (directory, name),
        ).fetchone()
        if row is None:
            raise NotFound(f"{directory}/{name}")
        return Entry.from_bytes(directory, row[0])

    def delete(self, directory: str, name: str) -> None:
        con = self._con()
        self._exec(
            con,
            f"DELETE FROM {self.table} WHERE directory=? AND name=?",
            (directory, name),
        )
        con.commit()

    def delete_folder_children(self, directory: str) -> None:
        con = self._con()
        prefix = directory if directory.endswith("/") else directory + "/"
        self._exec(
            con,
            f"DELETE FROM {self.table} WHERE directory=? "
            "OR (directory>=? AND directory<?)",
            (directory, prefix, prefix + self.HIGH),
        )
        con.commit()

    def list(
        self,
        directory: str,
        start_from: str = "",
        limit: int = 1024,
        prefix: str = "",
    ) -> Iterator[Entry]:
        # prefix as a half-open range: LIKE is case-insensitive for
        # ASCII in some drivers and treats %/_ as wildcards
        q = (
            f"SELECT name, meta FROM {self.table} "
            "WHERE directory=? AND name>?"
        )
        params: list = [directory, start_from]
        if prefix:
            q += " AND name>=? AND name<?"
            params += [prefix, prefix + self.HIGH]
        q += " ORDER BY name LIMIT ?"
        params.append(limit)
        for _name, meta in self._exec(self._con(), q, tuple(params)):
            yield Entry.from_bytes(directory, meta)

    def kv_put(self, key: bytes, value: bytes) -> None:
        con = self._con()
        self._exec(con, self.dialect.upsert_kv, (key, value))
        con.commit()

    def kv_get(self, key: bytes) -> Optional[bytes]:
        row = self._exec(
            self._con(), "SELECT v FROM kv WHERE k=?", (key,)
        ).fetchone()
        return row[0] if row else None

    def kv_delete(self, key: bytes) -> None:
        con = self._con()
        self._exec(con, "DELETE FROM kv WHERE k=?", (key,))
        con.commit()

    def kv_put_if_absent(self, key: bytes, value: bytes) -> bytes:
        con = self._con()
        self._exec(con, self.dialect.insert_ignore_kv, (key, value))
        con.commit()
        row = self._exec(
            con, "SELECT v FROM kv WHERE k=?", (key,)
        ).fetchone()
        return row[0] if row else value

    def close(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None

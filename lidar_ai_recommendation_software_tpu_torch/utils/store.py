"""Results persistence.

One store API covering both persistence stacks of the reference:
  - utils/database.py (PostgreSQL): events -> analyses -> density_results /
    flow_results / recommendations / reports (schema assumed pre-created
    there; here the DDL is explicit).
  - windows_implementation/core/database_manager.py (SQLite): projects ->
    datasets (point BLOBs) -> analyses -> reports with FK cascade
    (database_manager.py:50-122).

Backends: SQLite (always available) and PostgreSQL (used when psycopg2 is
importable and a DSN is supplied — gated import, zero hard dependency).
Arrays are stored as compressed .npz blobs (the reference stores raw
np.save bytes, database_manager.py:339-347); JSON results use a
numpy-aware encoder (database_manager.py:501-510 semantics).
"""

from __future__ import annotations

import datetime as _dt
import io
import json
import sqlite3
from typing import Any, Dict, List, Optional

import numpy as np

_SCHEMA = """
CREATE TABLE IF NOT EXISTS projects (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    description TEXT DEFAULT '',
    created_at TEXT NOT NULL,
    modified_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS datasets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    project_id INTEGER REFERENCES projects(id) ON DELETE CASCADE,
    name TEXT NOT NULL,
    point_count INTEGER NOT NULL,
    points BLOB NOT NULL,
    metadata TEXT DEFAULT '{}',
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS events (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    venue TEXT DEFAULT '',
    event_date TEXT DEFAULT '',
    description TEXT DEFAULT '',
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS analyses (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    event_id INTEGER REFERENCES events(id) ON DELETE CASCADE,
    dataset_id INTEGER REFERENCES datasets(id) ON DELETE CASCADE,
    name TEXT DEFAULT '',
    point_summary TEXT DEFAULT '{}',
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS density_results (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    analysis_id INTEGER REFERENCES analyses(id) ON DELETE CASCADE,
    results TEXT NOT NULL,
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS flow_results (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    analysis_id INTEGER REFERENCES analyses(id) ON DELETE CASCADE,
    results TEXT NOT NULL,
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS recommendations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    analysis_id INTEGER REFERENCES analyses(id) ON DELETE CASCADE,
    results TEXT NOT NULL,
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS reports (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    analysis_id INTEGER REFERENCES analyses(id) ON DELETE CASCADE,
    title TEXT DEFAULT '',
    html TEXT NOT NULL,
    created_at TEXT NOT NULL
);
"""


class _NumpyJSON(json.JSONEncoder):
    """numpy -> JSON (database_manager.py:501-510 semantics)."""

    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.bool_,)):
            return bool(o)
        return super().default(o)


def _dumps(obj) -> str:
    return json.dumps(obj, cls=_NumpyJSON)


def _now() -> str:
    return _dt.datetime.now().isoformat(timespec="seconds")


def _pack_points(points: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, points=np.asarray(points, np.float32))
    return buf.getvalue()


def _unpack_points(blob: bytes) -> np.ndarray:
    with np.load(io.BytesIO(blob)) as z:
        return np.asarray(z["points"], np.float64)


class ResultsStore:
    """SQLite-backed store (default). Thread-unsafe like sqlite itself;
    one store per process/path."""

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.execute("PRAGMA foreign_keys = ON")
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def _exec(self, sql: str, args: tuple = ()):
        """Single chokepoint for SQL so alternate backends can translate
        placeholders/DDL by overriding this method."""
        return self.conn.execute(sql, args)

    def _insert(self, sql: str, args: tuple = ()) -> int:
        """INSERT returning the new row id (dialect hook: sqlite
        lastrowid; PostgreSQL RETURNING id)."""
        cur = self._exec(sql, args)
        self.conn.commit()
        return cur.lastrowid

    # -- projects / datasets (database_manager.py API surface) --

    def create_project(self, name: str, description: str = "") -> int:
        return self._insert(
            "INSERT INTO projects (name, description, created_at, "
            "modified_at) VALUES (?,?,?,?)",
            (name, description, _now(), _now()))

    def get_project(self, project_id: int) -> Optional[Dict]:
        row = self._exec(
            "SELECT id, name, description, created_at, modified_at "
            "FROM projects WHERE id=?", (project_id,)).fetchone()
        if not row:
            return None
        keys = ("id", "name", "description", "created_at", "modified_at")
        return dict(zip(keys, row))

    def list_projects(self) -> List[Dict]:
        rows = self._exec(
            "SELECT id, name, description, created_at, modified_at "
            "FROM projects ORDER BY id").fetchall()
        keys = ("id", "name", "description", "created_at", "modified_at")
        return [dict(zip(keys, r)) for r in rows]

    def delete_project(self, project_id: int) -> None:
        self._exec("DELETE FROM projects WHERE id=?", (project_id,))
        self.conn.commit()

    def touch_project(self, project_id: int) -> None:
        self._exec("UPDATE projects SET modified_at=? WHERE id=?",
                          (_now(), project_id))
        self.conn.commit()

    def insert_dataset(self, project_id: Optional[int], name: str,
                       points: np.ndarray,
                       metadata: Optional[Dict] = None) -> int:
        return self._insert(
            "INSERT INTO datasets (project_id, name, point_count, points, "
            "metadata, created_at) VALUES (?,?,?,?,?,?)",
            (project_id, name, len(points), _pack_points(points),
             _dumps(metadata or {}), _now()))

    def get_dataset(self, dataset_id: int):
        row = self._exec(
            "SELECT name, point_count, points, metadata FROM datasets "
            "WHERE id=?", (dataset_id,)).fetchone()
        if not row:
            return None
        return {"name": row[0], "point_count": row[1],
                "points": _unpack_points(row[2]),
                "metadata": json.loads(row[3])}

    def list_datasets(self, project_id: Optional[int] = None) -> List[Dict]:
        q = ("SELECT id, project_id, name, point_count, created_at "
             "FROM datasets")
        args = ()
        if project_id is not None:
            q += " WHERE project_id=?"
            args = (project_id,)
        rows = self._exec(q + " ORDER BY id", args).fetchall()
        keys = ("id", "project_id", "name", "point_count", "created_at")
        return [dict(zip(keys, r)) for r in rows]

    # -- events / analyses (utils/database.py API surface) --

    def create_event(self, name: str, venue: str = "",
                     event_date: str = "", description: str = "") -> int:
        return self._insert(
            "INSERT INTO events (name, venue, event_date, description, "
            "created_at) VALUES (?,?,?,?,?)",
            (name, venue, event_date, description, _now()))

    def list_events(self) -> List[Dict]:
        rows = self._exec(
            "SELECT id, name, venue, event_date, description, created_at "
            "FROM events ORDER BY id").fetchall()
        keys = ("id", "name", "venue", "event_date", "description",
                "created_at")
        return [dict(zip(keys, r)) for r in rows]

    def create_analysis(self, event_id: Optional[int] = None,
                        dataset_id: Optional[int] = None, name: str = "",
                        point_summary: Optional[Dict] = None) -> int:
        return self._insert(
            "INSERT INTO analyses (event_id, dataset_id, name, "
            "point_summary, created_at) VALUES (?,?,?,?,?)",
            (event_id, dataset_id, name, _dumps(point_summary or {}),
             _now()))

    def _save_results(self, table: str, analysis_id: int, results) -> int:
        return self._insert(
            f"INSERT INTO {table} (analysis_id, results, created_at) "
            "VALUES (?,?,?)", (analysis_id, _dumps(results), _now()))

    def save_density_results(self, analysis_id: int, results) -> int:
        return self._save_results("density_results", analysis_id, results)

    def save_flow_results(self, analysis_id: int, results) -> int:
        return self._save_results("flow_results", analysis_id, results)

    def save_recommendations(self, analysis_id: int, results) -> int:
        return self._save_results("recommendations", analysis_id, results)

    def _get_results(self, table: str, analysis_id: int):
        row = self._exec(
            f"SELECT results FROM {table} WHERE analysis_id=? "
            "ORDER BY id DESC LIMIT 1", (analysis_id,)).fetchone()
        return json.loads(row[0]) if row else None

    def get_density_results(self, analysis_id: int):
        return self._get_results("density_results", analysis_id)

    def get_flow_results(self, analysis_id: int):
        return self._get_results("flow_results", analysis_id)

    def get_recommendations(self, analysis_id: int):
        return self._get_results("recommendations", analysis_id)

    def save_report(self, analysis_id: int, html: str,
                    title: str = "") -> int:
        return self._insert(
            "INSERT INTO reports (analysis_id, title, html, created_at) "
            "VALUES (?,?,?,?)", (analysis_id, title, html, _now()))

    def get_report(self, report_id: int) -> Optional[Dict]:
        row = self._exec(
            "SELECT id, analysis_id, title, html, created_at FROM reports "
            "WHERE id=?", (report_id,)).fetchone()
        if not row:
            return None
        keys = ("id", "analysis_id", "title", "html", "created_at")
        return dict(zip(keys, row))

    def list_reports(self) -> List[Dict]:
        rows = self._exec(
            "SELECT id, analysis_id, title, created_at FROM reports "
            "ORDER BY id").fetchall()
        keys = ("id", "analysis_id", "title", "created_at")
        return [dict(zip(keys, r)) for r in rows]

    def analyses_for_event(self, event_id: int) -> List[Dict]:
        """Analyses joined with presence of results, mirroring the 2-way
        LEFT JOIN view (utils/database.py:276-287)."""
        rows = self._exec(
            "SELECT a.id, a.name, a.created_at, "
            "  (SELECT COUNT(*) FROM density_results d "
            "     WHERE d.analysis_id = a.id) > 0, "
            "  (SELECT COUNT(*) FROM flow_results f "
            "     WHERE f.analysis_id = a.id) > 0 "
            "FROM analyses a WHERE a.event_id=? ORDER BY a.id",
            (event_id,)).fetchall()
        keys = ("id", "name", "created_at", "has_density", "has_flow")
        return [dict(zip(keys, r)) for r in rows]

    def close(self):
        self.conn.close()


def translate_placeholders(sql: str) -> str:
    """sqlite '?' -> psycopg2 '%s', skipping any '?' inside single-quoted
    string literals (the naive str.replace would corrupt e.g.
    ``INSERT ... VALUES ('what?')``). Single quotes escape by doubling
    per SQL; '%' is doubled outside literals so psycopg2's printf-style
    parameter parsing never misreads a literal percent."""
    out = []
    in_str = False
    i = 0
    while i < len(sql):
        ch = sql[i]
        if in_str:
            out.append(ch)
            if ch == "'":
                if i + 1 < len(sql) and sql[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            out.append(ch)
        elif ch == "?":
            out.append("%s")
        elif ch == "%":
            out.append("%%")
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def open_store(dsn: Optional[str] = None) -> ResultsStore:
    """Open the best available backend: a PostgreSQL DSN (postgres://...)
    when psycopg2 is importable, else SQLite (path or :memory:)."""
    if dsn and dsn.startswith(("postgres://", "postgresql://")):
        try:
            import psycopg2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "PostgreSQL DSN given but psycopg2 is not installed; "
                "use a SQLite path instead") from e
        return PostgresStore(dsn)
    return ResultsStore(dsn or ":memory:")


def postgres_ddl() -> str:
    """The shared schema in PostgreSQL dialect (utils/database.py of the
    reference assumes pre-created tables, database.py:7-33; here the DDL
    is explicit so a fresh database bootstraps itself)."""
    return (_SCHEMA
            .replace("INTEGER PRIMARY KEY AUTOINCREMENT",
                     "SERIAL PRIMARY KEY")
            .replace("BLOB", "BYTEA"))


class PostgresStore(ResultsStore):
    """psycopg2 backend with the same schema; translated placeholders.

    All query logic is inherited — only ``_exec`` (placeholder dialect)
    and connection bootstrap differ. Every method here is executed by
    tests/test_store_postgres.py against a strict fake DBAPI driver that
    asserts the dialect contract (only %s placeholders, INSERT ...
    RETURNING id, doubled %%); the live-server integration test
    (tests/test_utils.py::TestPostgresStore) runs wherever
    LIDAR_PG_DSN/DATABASE_URL points at a reachable PostgreSQL."""

    def __init__(self, dsn: str):
        import psycopg2
        self.conn = psycopg2.connect(dsn)
        self.conn.autocommit = True
        with self.conn.cursor() as cur:
            cur.execute(postgres_ddl())

    def _exec(self, sql: str, args: tuple = ()):
        cur = self.conn.cursor()
        cur.execute(translate_placeholders(sql), args)
        return cur

    def _insert(self, sql: str, args: tuple = ()) -> int:
        """psycopg2 has no lastrowid for SERIAL keys; RETURNING id."""
        cur = self._exec(sql + " RETURNING id", args)
        return cur.fetchone()[0]

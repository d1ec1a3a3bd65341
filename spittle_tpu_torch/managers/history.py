"""Transcription history: SQLite + recordings on disk + retention.

Port of spittle_tpu/managers/history.py.

Behavior-parity rebuild of `src-tauri/src/managers/
history.rs`: the transcription_history schema with its three migrations
tracked via PRAGMA user_version (:21-35), legacy `_sqlx_migrations`
conversion (:131-186), per-transcription WAV save (:190-225), retention
policies Never / count-limit / 3d / 2w / 3m (:238-347), and
history-updated events.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from spittle_tpu_torch.audio.wav import save_wav_file
from spittle_tpu_torch.config.settings import RecordingRetentionPeriod
from spittle_tpu_torch.events import EventBus, HISTORY_UPDATED

MIGRATIONS = [
    """CREATE TABLE IF NOT EXISTS transcription_history (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        file_name TEXT NOT NULL,
        timestamp INTEGER NOT NULL,
        saved BOOLEAN NOT NULL DEFAULT 0,
        title TEXT NOT NULL,
        transcription_text TEXT NOT NULL
    );""",
    "ALTER TABLE transcription_history ADD COLUMN post_processed_text TEXT;",
    "ALTER TABLE transcription_history ADD COLUMN post_process_prompt TEXT;",
]

RETENTION_SECONDS = {
    RecordingRetentionPeriod.DAYS3: 3 * 86400,
    RecordingRetentionPeriod.WEEKS2: 14 * 86400,
    RecordingRetentionPeriod.MONTHS3: 90 * 86400,
}


@dataclass
class HistoryEntry:
    id: int
    file_name: str
    timestamp: int
    saved: bool
    title: str
    transcription_text: str
    post_processed_text: Optional[str] = None
    post_process_prompt: Optional[str] = None


class HistoryManager:
    def __init__(
        self,
        data_dir: str,
        events: Optional[EventBus] = None,
        retention_getter: Optional[Callable[[], RecordingRetentionPeriod]] = None,
        history_limit_getter: Optional[Callable[[], int]] = None,
        db_path: Optional[str] = None,
    ):
        self.recordings_dir = os.path.join(data_dir, "recordings")
        os.makedirs(self.recordings_dir, exist_ok=True)
        self.db_path = db_path or os.path.join(data_dir, "history.db")
        self.events = events or EventBus()
        self._retention = retention_getter or (
            lambda: RecordingRetentionPeriod.PRESERVE_LIMIT
        )
        self._limit = history_limit_getter or (lambda: 5)
        self._lock = threading.Lock()
        self._init_database()

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.db_path)
        conn.row_factory = sqlite3.Row
        return conn

    def _init_database(self) -> None:
        with self._lock, self._connect() as conn:
            self._migrate_from_legacy_tracking(conn)
            version = conn.execute("PRAGMA user_version").fetchone()[0]
            for i, sql in enumerate(MIGRATIONS[version:], start=version):
                conn.executescript(sql)
                conn.execute(f"PRAGMA user_version = {i + 1}")
            conn.commit()

    def _migrate_from_legacy_tracking(self, conn: sqlite3.Connection) -> None:
        """Convert legacy `_sqlx_migrations` tracking into user_version
        (history.rs:131-186)."""
        row = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name='_sqlx_migrations'"
        ).fetchone()
        if row is None:
            return
        applied = conn.execute(
            "SELECT COUNT(*) FROM _sqlx_migrations"
        ).fetchone()[0]
        version = conn.execute("PRAGMA user_version").fetchone()[0]
        if version == 0 and applied > 0:
            conn.execute(f"PRAGMA user_version = {min(applied, len(MIGRATIONS))}")
        conn.execute("DROP TABLE _sqlx_migrations")

    # -- writes ----------------------------------------------------------

    def save_transcription(
        self,
        samples: Optional[np.ndarray],
        title: str,
        transcription_text: str,
        post_processed_text: Optional[str] = None,
        post_process_prompt: Optional[str] = None,
        timestamp: Optional[int] = None,
    ) -> int:
        """Persist a WAV (when samples given) + row; applies retention."""
        ts = int(timestamp if timestamp is not None else time.time())
        file_name = f"rec_{ts}_{int(time.monotonic() * 1000) % 100000}.wav"
        if samples is not None and len(samples):
            save_wav_file(os.path.join(self.recordings_dir, file_name), samples)
        else:
            file_name = ""
        with self._lock, self._connect() as conn:
            cur = conn.execute(
                "INSERT INTO transcription_history "
                "(file_name, timestamp, saved, title, transcription_text, "
                "post_processed_text, post_process_prompt) "
                "VALUES (?, ?, 0, ?, ?, ?, ?)",
                (file_name, ts, title, transcription_text,
                 post_processed_text, post_process_prompt),
            )
            entry_id = cur.lastrowid
            conn.commit()
        self.apply_retention()
        self.events.emit(HISTORY_UPDATED, {"id": entry_id})
        return entry_id

    def toggle_saved_status(self, entry_id: int) -> bool:
        with self._lock, self._connect() as conn:
            row = conn.execute(
                "SELECT saved FROM transcription_history WHERE id = ?",
                (entry_id,),
            ).fetchone()
            if row is None:
                return False
            new_val = 0 if row["saved"] else 1
            conn.execute(
                "UPDATE transcription_history SET saved = ? WHERE id = ?",
                (new_val, entry_id),
            )
            conn.commit()
        self.events.emit(HISTORY_UPDATED, {"id": entry_id})
        return bool(new_val)

    def delete_entry(self, entry_id: int) -> None:
        with self._lock, self._connect() as conn:
            row = conn.execute(
                "SELECT file_name FROM transcription_history WHERE id = ?",
                (entry_id,),
            ).fetchone()
            if row and row["file_name"]:
                path = os.path.join(self.recordings_dir, row["file_name"])
                if os.path.exists(path):
                    os.remove(path)
            conn.execute(
                "DELETE FROM transcription_history WHERE id = ?", (entry_id,)
            )
            conn.commit()
        self.events.emit(HISTORY_UPDATED, {"id": entry_id})

    # -- reads -----------------------------------------------------------

    def get_history_entries(self, limit: Optional[int] = None) -> List[HistoryEntry]:
        with self._lock, self._connect() as conn:
            sql = (
                "SELECT * FROM transcription_history ORDER BY timestamp DESC"
            )
            if limit:
                sql += f" LIMIT {int(limit)}"
            rows = conn.execute(sql).fetchall()
        return [
            HistoryEntry(
                id=r["id"], file_name=r["file_name"], timestamp=r["timestamp"],
                saved=bool(r["saved"]), title=r["title"],
                transcription_text=r["transcription_text"],
                post_processed_text=r["post_processed_text"],
                post_process_prompt=r["post_process_prompt"],
            )
            for r in rows
        ]

    def recording_path(self, entry: HistoryEntry) -> Optional[str]:
        if not entry.file_name:
            return None
        return os.path.join(self.recordings_dir, entry.file_name)

    # -- retention -------------------------------------------------------

    def apply_retention(self) -> int:
        """Delete unsaved entries per the retention policy; returns count.

        Never: keep nothing (delete all unsaved immediately);
        PreserveLimit: keep the newest `history_limit` unsaved entries;
        time-based: delete unsaved entries older than the cutoff
        (history.rs:238-347). Saved entries are always kept."""
        period = self._retention()
        deleted = 0
        with self._lock, self._connect() as conn:
            if period is RecordingRetentionPeriod.NEVER:
                rows = conn.execute(
                    "SELECT id, file_name FROM transcription_history "
                    "WHERE saved = 0"
                ).fetchall()
            elif period is RecordingRetentionPeriod.PRESERVE_LIMIT:
                limit = max(self._limit(), 0)
                rows = conn.execute(
                    "SELECT id, file_name FROM transcription_history "
                    "WHERE saved = 0 ORDER BY timestamp DESC "
                    f"LIMIT -1 OFFSET {limit}"
                ).fetchall()
            else:
                cutoff = int(time.time()) - RETENTION_SECONDS[period]
                rows = conn.execute(
                    "SELECT id, file_name FROM transcription_history "
                    "WHERE saved = 0 AND timestamp < ?",
                    (cutoff,),
                ).fetchall()
            for r in rows:
                if r["file_name"]:
                    path = os.path.join(self.recordings_dir, r["file_name"])
                    if os.path.exists(path):
                        os.remove(path)
                conn.execute(
                    "DELETE FROM transcription_history WHERE id = ?", (r["id"],)
                )
                deleted += 1
            conn.commit()
        return deleted

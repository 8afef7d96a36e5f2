"""SQLite-backed user/upload store (≙ legacy ``src/auth.py:10-187``, unused
by the reference's app but part of its surface).

users(id, email UNIQUE, password_hash) and uploads(id, user_id, filename,
verdict, confidence, created_at) tables; password hashing matches the
reference's SHA-256 (accepted on verify) but new writes use salted PBKDF2
via ``serve.auth``'s helpers.

A copy of ``deepfake_video_detection_tpu/serve/auth_sqlite.py`` kept in the
port: the same schema and hashes, so either package opens the other's
database.
"""

from __future__ import annotations

import hashlib
import os
import sqlite3
import time
from typing import Any, Dict, List, Optional

from deepfake_video_detection_tpu_torch.serve.auth import _hash_password, _verify_password


class SQLiteAuth:
    def __init__(self, db_path: str = "data/app/auth.db"):
        d = os.path.dirname(db_path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.db_path = db_path
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS users (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                email TEXT UNIQUE NOT NULL,
                password_hash TEXT NOT NULL,
                created_at REAL NOT NULL)""")
            c.execute("""CREATE TABLE IF NOT EXISTS uploads (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                user_id INTEGER NOT NULL REFERENCES users(id),
                filename TEXT NOT NULL,
                verdict TEXT,
                confidence REAL,
                created_at REAL NOT NULL)""")

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.db_path)
        conn.row_factory = sqlite3.Row
        return conn

    # -- users ---------------------------------------------------------------

    def create_user(self, email: str, password: str) -> Optional[int]:
        try:
            with self._conn() as c:
                cur = c.execute(
                    "INSERT INTO users (email, password_hash, created_at) "
                    "VALUES (?, ?, ?)",
                    (email.strip().lower(), _hash_password(password),
                     time.time()))
                return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def verify_user(self, email: str, password: str) -> Optional[int]:
        with self._conn() as c:
            row = c.execute("SELECT id, password_hash FROM users WHERE email=?",
                            (email.strip().lower(),)).fetchone()
        if row is None:
            return None
        stored = row["password_hash"]
        # accept legacy bare-sha256 rows (reference format) and pbkdf2
        if _verify_password(password, stored) or \
                stored == hashlib.sha256(password.encode()).hexdigest():
            return int(row["id"])
        return None

    # -- uploads -------------------------------------------------------------

    def add_upload(self, user_id: int, filename: str,
                   verdict: Optional[str] = None,
                   confidence: Optional[float] = None) -> int:
        with self._conn() as c:
            cur = c.execute(
                "INSERT INTO uploads (user_id, filename, verdict, confidence, "
                "created_at) VALUES (?, ?, ?, ?, ?)",
                (user_id, filename, verdict, confidence, time.time()))
            return cur.lastrowid

    def update_upload(self, upload_id: int, verdict: str,
                      confidence: float) -> None:
        with self._conn() as c:
            c.execute("UPDATE uploads SET verdict=?, confidence=? WHERE id=?",
                      (verdict, confidence, upload_id))

    def list_uploads(self, user_id: int) -> List[Dict[str, Any]]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT * FROM uploads WHERE user_id=? ORDER BY created_at",
                (user_id,)).fetchall()
        return [dict(r) for r in rows]

    def delete_upload(self, upload_id: int) -> None:
        with self._conn() as c:
            c.execute("DELETE FROM uploads WHERE id=?", (upload_id,))

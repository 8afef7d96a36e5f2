"""Auth + per-user storage for the web app.

A copy of ``deepfake_video_detection_tpu/serve/auth.py`` kept in the port.
The on-disk formats are the JAX package's (``users.json``, ``uploads.json``,
``secrets.json``, the PBKDF2 hashes, the signed session token), so a data
directory and a session cookie of either package's app serve the other.

Capability parity with the reference's auth stack (``app.py:1008-1120,
2504-2621, 2880-2918``): Firebase Identity Toolkit signup/login via REST
(gated on ``FIREBASE_API_KEY``; dormant in a zero-egress image) with a local
``users.json`` fallback, per-user uploads DB (local JSON standing in for the
Firebase RTDB), and per-user secrets (Gemini key, phone) in ``secrets.json``.

Deliberate improvement over the reference: local passwords are stored as
salted PBKDF2-SHA256, not plaintext (``app.py:2541-2563`` stores plaintext).
Legacy plaintext entries are still accepted and upgraded on first login.

Sessions: with ``FLASK_SECRET`` (or ``SECRET_KEY``) set, tokens are
stateless HMAC-signed ``s.<email-b64>.<expiry>.<sig>`` values — like the
reference's Flask signed-cookie sessions (``app.py:84``), they survive
server restarts and need no server-side store. Without a secret, sessions
fall back to in-memory random tokens (logged out on restart). Lifetime:
``SESSION_TTL_SECONDS`` (default 31 days, Flask's permanent-session
default).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets as _secrets
import threading
import urllib.request
from typing import Any, Dict, List, Optional

from deepfake_video_detection_tpu_torch.utils.config import env_str

_LOCK = threading.Lock()


def _read_json(path: str, default):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def _write_json(path: str, data) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
    os.replace(tmp, path)


def _signing_key() -> Optional[bytes]:
    s = env_str("FLASK_SECRET") or env_str("SECRET_KEY") or ""
    return s.encode() if s else None


def _sign(key: bytes, payload: str) -> str:
    return hmac.new(key, payload.encode(), hashlib.sha256).hexdigest()[:32]


def _b64u(s: str) -> str:
    import base64

    return base64.urlsafe_b64encode(s.encode()).decode().rstrip("=")


def _b64u_decode(b: str) -> str:
    import base64

    return base64.urlsafe_b64decode(b + "=" * (-len(b) % 4)).decode()


def _hash_password(password: str, salt: Optional[str] = None) -> str:
    salt = salt or _secrets.token_hex(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), bytes.fromhex(salt),
                                 100_000).hex()
    return f"pbkdf2${salt}${digest}"


def _verify_password(password: str, stored: str) -> bool:
    if stored.startswith("pbkdf2$"):
        _, salt, digest = stored.split("$", 2)
        want = _hash_password(password, salt).split("$", 2)[2]
        return hmac.compare_digest(want, digest)
    # legacy plaintext or bare sha256
    if hmac.compare_digest(stored, password):
        return True
    return hmac.compare_digest(stored,
                               hashlib.sha256(password.encode()).hexdigest())


class AuthStore:
    def __init__(self, data_dir: str = "data/app"):
        self.data_dir = data_dir
        self.users_path = os.path.join(data_dir, "users.json")
        self.uploads_path = os.path.join(data_dir, "uploads.json")
        self.secrets_path = os.path.join(data_dir, "secrets.json")
        self.sessions: Dict[str, str] = {}  # token → email
        self.fb_uids: Dict[str, str] = {}   # email → Firebase localId
        # injectable for tests: (urllib.request.Request, timeout) → response
        self._http = urllib.request.urlopen

    # -- firebase RTDB upload mirror (``app.py:815-831, 2880-2918``) ---------

    def _rtdb_base(self) -> str:
        return (env_str("FIREBASE_DATABASE_URL") or "").rstrip("/")

    def _rtdb_request(self, method: str, path: str,
                      data=None) -> Optional[Any]:
        """GET/PUT ``<base>/<path>.json`` — the RTDB REST convention the
        reference uses (``_rtdb_get/_rtdb_put``). Returns parsed JSON for
        GET, None for writes. Raises on HTTP errors like the reference."""
        url = f"{self._rtdb_base()}/{path}.json"
        body = None if data is None else json.dumps(data).encode()
        req = urllib.request.Request(
            url, data=body, method=method,
            headers={"Content-Type": "application/json"})
        with self._http(req, timeout=15) as r:
            raw = r.read()
        return json.loads(raw.decode()) if method == "GET" and raw else None

    # -- firebase REST (gated) ------------------------------------------------

    def _firebase_request(self, endpoint: str, email: str,
                          password: str) -> Optional[Dict[str, Any]]:
        """≙ ``_firebase_request`` (``app.py:1021-1039``)."""
        api_key = env_str("FIREBASE_API_KEY")
        if not api_key:
            return None
        # base override: tests point this at a loopback mock server so the
        # LIVE request path (request formation, response parsing, error
        # fallback) is exercised without network (tests/test_aux.py)
        base = (env_str("FIREBASE_IDENTITY_BASE")
                or "https://identitytoolkit.googleapis.com/v1")
        url = f"{base}/accounts:{endpoint}?key={api_key}"
        body = json.dumps({"email": email, "password": password,
                           "returnSecureToken": True}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=15) as r:
                return json.loads(r.read().decode())
        except Exception:
            return None

    # -- signup / login -------------------------------------------------------

    def signup(self, email: str, password: str) -> Optional[str]:
        """Returns a session token, or None on failure."""
        email = email.strip().lower()
        if not email or not password:
            return None
        fb = self._firebase_request("signUp", email, password)
        if fb is None:
            with _LOCK:
                users = _read_json(self.users_path, {})
                if email in users:
                    return None
                users[email] = {"password": _hash_password(password)}
                _write_json(self.users_path, users)
        elif fb.get("localId"):
            self.fb_uids[email] = fb["localId"]
        return self._new_session(email)

    def login(self, email: str, password: str) -> Optional[str]:
        email = email.strip().lower()
        fb = self._firebase_request("signInWithPassword", email, password)
        if fb is not None and "idToken" in fb:
            if fb.get("localId"):
                self.fb_uids[email] = fb["localId"]
            return self._new_session(email)
        with _LOCK:
            users = _read_json(self.users_path, {})
            rec = users.get(email)
            if rec is None:
                return None
            stored = rec["password"] if isinstance(rec, dict) else str(rec)
            if not _verify_password(password, stored):
                return None
            if not stored.startswith("pbkdf2$"):  # upgrade legacy entries
                users[email] = {"password": _hash_password(password)}
                _write_json(self.users_path, users)
        return self._new_session(email)

    def _new_session(self, email: str) -> str:
        key = _signing_key()
        if key:
            import time
            ttl = int(env_str("SESSION_TTL_SECONDS") or 31 * 24 * 3600)
            b = _b64u(email)
            payload = f"{b}.{int(time.time()) + ttl}"
            return f"s.{payload}.{_sign(key, payload)}"
        token = _secrets.token_urlsafe(32)
        self.sessions[token] = email
        return token

    def user_for_token(self, token: Optional[str]) -> Optional[str]:
        if not token:
            return None
        if token.startswith("s.") and token.count(".") == 3:
            import time
            key = _signing_key()
            if not key:
                return None
            _, b, exp, sig = token.split(".")
            payload = f"{b}.{exp}"
            if not hmac.compare_digest(sig, _sign(key, payload)):
                return None
            try:
                if int(exp) < time.time():
                    return None
                return _b64u_decode(b)
            except (ValueError, UnicodeDecodeError):
                return None
        return self.sessions.get(token)

    def logout(self, token: Optional[str]) -> None:
        # signed tokens are stateless — logout is the cookie removal the
        # app performs, exactly like the reference's Flask session.clear()
        if token:
            self.sessions.pop(token, None)

    # -- uploads DB: Firebase RTDB when configured + logged in via Firebase,
    # local JSON otherwise — mirrors ``_load/_save_uploads_db``
    # (``app.py:2880-2918``: RTDB layout ``uploads/<uid>/<id>``, every
    # failure falls back to the local file).

    def list_uploads(self, email: str) -> List[Dict[str, Any]]:
        local = _read_json(self.uploads_path, {}).get(email, [])
        uid = self.fb_uids.get(email)
        if uid and self._rtdb_base():
            try:
                data = self._rtdb_request("GET", f"uploads/{uid}")
            except Exception:
                return local  # fall back to local, like the reference
            if data is None or isinstance(data, dict):
                # merge both directions: a record whose PUT failed (or with
                # id=None) lives only in the local mirror and must not vanish
                # once RTDB reads recover; a record uploaded from another
                # device lives only remotely. Remote copy wins on conflict,
                # local insertion order is kept, remote-only records append.
                remote = {str(k): v for k, v in (data or {}).items()}
                merged = []
                for rec in local:
                    rid = rec.get("id")
                    merged.append(remote.pop(str(rid), rec)
                                  if rid is not None else rec)
                merged.extend(remote.values())
                return merged
        return local

    def add_upload(self, email: str, record: Dict[str, Any]) -> None:
        # local mirror is ALWAYS written: a transient RTDB read failure later
        # must not make the user's history (and result pages) disappear
        with _LOCK:
            db = _read_json(self.uploads_path, {})
            db.setdefault(email, []).append(record)
            _write_json(self.uploads_path, db)
        uid = self.fb_uids.get(email)
        if uid and self._rtdb_base() and record.get("id") is not None:
            try:
                self._rtdb_request("PUT", f"uploads/{uid}/{record['id']}",
                                   record)
            except Exception:
                pass  # remote mirror is best-effort, like the reference

    def get_upload(self, email: str, upload_id: str) -> Optional[Dict[str, Any]]:
        for rec in self.list_uploads(email):
            if rec.get("id") == upload_id:
                return rec
        return None

    # -- per-user secrets ------------------------------------------------------

    def get_secrets(self, email: str) -> Dict[str, Any]:
        return _read_json(self.secrets_path, {}).get(email, {})

    def set_secrets(self, email: str, values: Dict[str, Any]) -> None:
        with _LOCK:
            db = _read_json(self.secrets_path, {})
            db.setdefault(email, {}).update(values)
            _write_json(self.secrets_path, db)

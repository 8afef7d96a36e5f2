"""Background job manager + server-side results cache.

A copy of ``deepfake_video_detection_tpu/serve/jobs.py`` kept in the port
(standard library only).

Capability parity with the reference's job machinery (``app.py:121-322``):
``_UI_JOBS`` dict + worker pool with job lifecycle queued→running→done/error,
TTL cleanup, and a results cache keyed by uuid stored in the session cookie
(TTL 30 min, cap 100). Differences by design: this version is actually
thread-safe (one lock per structure) — the reference relied on
``workers=1`` to avoid races (SURVEY.md §5.2); we default to a small pool
since device steps are serialized inside the predictor anyway.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from deepfake_video_detection_tpu_torch.utils.config import env_int


class JobManager:
    def __init__(self, workers: Optional[int] = None,
                 job_ttl_s: Optional[float] = None):
        self.workers = workers if workers is not None else env_int("UI_BG_WORKERS", 1)
        self.job_ttl_s = job_ttl_s if job_ttl_s is not None \
            else env_int("UI_JOB_TTL_SECONDS", 3600)
        self._pool = ThreadPoolExecutor(max_workers=max(1, self.workers))
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[], Any]) -> str:
        job_id = uuid.uuid4().hex
        with self._lock:
            self._cleanup_locked()
            self._jobs[job_id] = {"status": "queued", "created": time.time(),
                                  "result": None, "error": None}

        def run():
            with self._lock:
                job = self._jobs.get(job_id)
                if job is None:
                    return
                job["status"] = "running"
            try:
                result = fn()
                with self._lock:
                    job = self._jobs.get(job_id)
                    if job is not None:
                        job["result"] = result
                        job["status"] = "done"
            except Exception as e:
                with self._lock:
                    job = self._jobs.get(job_id)
                    if job is not None:
                        job["error"] = str(e)
                        job["status"] = "error"

        self._pool.submit(run)
        return job_id

    def status(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            return dict(job)

    def _cleanup_locked(self) -> None:
        now = time.time()
        dead = [k for k, v in self._jobs.items()
                if now - v["created"] > self.job_ttl_s]
        for k in dead:
            del self._jobs[k]

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


class ResultsCache:
    """TTL'd uuid-keyed result store (≙ ``_ui_cache_set/get``,
    ``app.py:293-322``)."""

    def __init__(self, ttl_s: Optional[float] = None,
                 max_items: Optional[int] = None):
        self.ttl_s = ttl_s if ttl_s is not None \
            else env_int("UI_RESULTS_TTL_SECONDS", 1800)
        self.max_items = max_items if max_items is not None \
            else env_int("UI_RESULTS_MAX_ITEMS", 100)
        self._store: Dict[str, Any] = {}
        self._times: Dict[str, float] = {}
        self._lock = threading.Lock()

    def put(self, value: Any, key: Optional[str] = None) -> str:
        key = key or uuid.uuid4().hex
        with self._lock:
            now = time.time()
            expired = [k for k, t in self._times.items()
                       if now - t > self.ttl_s]
            for k in expired:
                self._store.pop(k, None)
                self._times.pop(k, None)
            while len(self._store) >= self.max_items:
                oldest = min(self._times, key=self._times.get)
                self._store.pop(oldest, None)
                self._times.pop(oldest, None)
            self._store[key] = value
            self._times[key] = now
        return key

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            t = self._times.get(key)
            if t is None or time.time() - t > self.ttl_s:
                self._store.pop(key, None)
                self._times.pop(key, None)
                return None
            return self._store[key]

"""Web serving app — framework-free WSGI (stdlib only).

Capability parity with the reference's Flask app (``app.py``, 3291 LoC;
route table in SURVEY.md §2.5 and reproduced below). Flask is not a baked-in
dependency of this image, so the app is a small WSGI router; it runs under
any WSGI server or the threaded stdlib server in ``main()``.

Routes (≙ ``app.py:2481-3259``):
  GET  /                    landing page
  GET/POST /login /signup   auth (Firebase REST gated → local users.json)
  GET  /dashboard           upload history + chat
  GET  /ui                  upload form
  GET  /about, /health
  POST /ui/predict          synchronous multi-file predict
  POST /predict             compat alias
  GET/POST /results         async job flow (POST spawns job → processing page
                            polling /api/ui-job/<id> → GET renders results)
  GET  /ui/results          compat alias of GET /results
  GET  /api/ui-job/<id>     job status JSON
  GET  /logout
  GET  /api/uploads         per-user upload history JSON
  POST /api/upload          upload + predict + record history
  POST /api/chat            authed chat;  POST /api/chat-public  public chat
  POST /api/gemini-report-public   English report for a result payload
  GET/POST /api/chat-config /api/agent-config   per-user config
  GET  /result/<id>, /api/result/<id>
  GET  /api/metrics         per-epoch metrics recomputed from preds CSVs
  POST /api/load-model      load a checkpoint by path
  POST /api/predict         API predict (multipart or path)
  GET  /api/model-info      loader stats + device
  GET  /api/checkpoints     ranked loadable checkpoints (dashboard dropdown)

Startup autoload mirrors ``_attempt_autoload`` (``app.py:643-675``); disable
with ``--no-autoload`` / ``NO_AUTOLOAD=1``.

Counterpart of ``deepfake_video_detection_tpu/serve/app.py``: the same
routes in the same order, JSON keys, pages and environment variables, over
the port's ``Predictor`` and loader. The app runs its models on ``device``
(``App(device=...)``, ``--device``; CUDA unless the caller names another
device, and asking for CUDA without a card raises: nothing falls back to the
CPU). On the card an upload runs the fused-normalize kernel (K1) once, and a
ViT-B/16 checkpoint the flash forward (K2) in every block, and with
``explain`` the flash backward (K4) too; a request that fails comes back as
the Predictor's ``{"error": ...}`` dict, as in the JAX package.
``/api/model-info`` reports the device type (``"cuda"`` or ``"cpu"``) of the
loaded predictor, or the app's when none is loaded. ``/api/load-model``
closes the replaced Predictor after the swap.

``_startup_hardening`` caps the BLAS thread variables as the JAX package
does. torch reads ``OMP_NUM_THREADS`` when it is imported, so the cap does
not reach torch's intra-op pool once torch is imported, which ``main`` has
done by then; the caps still bind the host libraries that read them later.

WSGI callable: ``deepfake_video_detection_tpu_torch.serve.app:create_app``
(a factory: ``create_app()`` returns the callable ``App``); or run
``python -m deepfake_video_detection_tpu_torch.serve.app``.
"""

from __future__ import annotations

import argparse
import csv
import glob as _glob
import json
import logging
import os
import re
import threading
import time
import uuid
from http import cookies as _cookies
from socketserver import ThreadingMixIn
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIServer, make_server

from deepfake_video_detection_tpu_torch.agents.active_learning import ActiveLearner
from deepfake_video_detection_tpu_torch.agents.enhanced import EnhancedDecisionAgent
from deepfake_video_detection_tpu_torch.agents.system import (
    ActionAgent, DecisionAgent, MonitoringAgent)
from deepfake_video_detection_tpu_torch.agents.telemetry import TelemetryLogger
from deepfake_video_detection_tpu_torch.serve import chat as chat_mod
from deepfake_video_detection_tpu_torch.serve import loader as loader_mod
from deepfake_video_detection_tpu_torch.serve import templates as T
from deepfake_video_detection_tpu_torch.serve.auth import AuthStore
from deepfake_video_detection_tpu_torch.serve.jobs import JobManager, ResultsCache
from deepfake_video_detection_tpu_torch.serve.predict import (
    Predictor, simple_english_justification_200_words, simple_english_message)
from deepfake_video_detection_tpu_torch.utils.config import env_bool, env_int, env_str
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# tiny WSGI toolkit
# ---------------------------------------------------------------------------


class PayloadTooLarge(Exception):
    """Request body exceeds MAX_UPLOAD_MB — mapped to HTTP 413."""


class Request:
    def __init__(self, environ: Dict[str, Any]):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = {k: v[0] for k, v in
                      parse_qs(environ.get("QUERY_STRING", "")).items()}
        self._body: Optional[bytes] = None
        raw = environ.get("HTTP_COOKIE", "")
        jar = _cookies.SimpleCookie()
        try:
            jar.load(raw)
        except _cookies.CookieError:
            pass
        self.cookies = {k: m.value for k, m in jar.items()}

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = self.check_content_length()
            self._body = self.environ["wsgi.input"].read(length) if length else b""
        return self._body

    def check_content_length(self) -> int:
        """Bound request bodies BEFORE buffering: an attacker-controlled
        CONTENT_LENGTH must not be able to OOM the serving host (hardening
        beyond the reference, which buffers unbounded). Called eagerly per
        request in ``App.__call__`` and again lazily from ``body``."""
        try:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        max_bytes = int(float(os.environ.get("MAX_UPLOAD_MB", 500)) * 1e6)
        if length > max_bytes:
            raise PayloadTooLarge(
                f"request body {length} bytes exceeds "
                f"MAX_UPLOAD_MB={max_bytes // 10**6}")
        return length

    def json(self) -> Dict[str, Any]:
        try:
            return json.loads(self.body.decode() or "{}")
        except ValueError:
            return {}

    def form(self) -> Dict[str, str]:
        ctype = self.environ.get("CONTENT_TYPE", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            return {k: v[0] for k, v in parse_qs(self.body.decode()).items()}
        return {}

    def _multipart_parts(self) -> List[Tuple[str, bytes]]:
        """Raw multipart parts as (headers_text, content). Minimal parser —
        the stdlib dropped ``cgi`` in 3.13, so we split on the boundary.
        Exactly ONE delimiting CRLF is removed on each side of a part:
        ``strip(b"\\r\\n")`` would eat trailing 0x0D/0x0A bytes that are
        legitimately part of an uploaded binary file."""
        ctype = self.environ.get("CONTENT_TYPE", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not ctype.startswith("multipart/form-data") or not m:
            return []
        boundary = ("--" + m.group(1)).encode()
        out = []
        for part in self.body.split(boundary):
            if not part or part.startswith(b"--"):  # preamble / terminator
                continue
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if b"\r\n\r\n" not in part:
                continue
            head, content = part.split(b"\r\n\r\n", 1)
            out.append((head.decode(errors="replace"), content))
        return out

    def files(self) -> List[Tuple[str, str, bytes]]:
        """Multipart files as (field, filename, content)."""
        out = []
        for headers, content in self._multipart_parts():
            fm = re.search(r'name="([^"]*)"', headers)
            fn = re.search(r'filename="([^"]*)"', headers)
            if fm and fn and fn.group(1):
                out.append((fm.group(1), fn.group(1), content))
        return out

    def form_fields(self) -> Dict[str, str]:
        """Non-file fields of a multipart body."""
        if not self.environ.get("CONTENT_TYPE", "").startswith(
                "multipart/form-data"):
            return self.form()
        out: Dict[str, str] = {}
        for headers, content in self._multipart_parts():
            fm = re.search(r'name="([^"]*)"', headers)
            fn = re.search(r'filename="', headers)
            if fm and not fn:
                out[fm.group(1)] = content.decode(errors="replace")
        return out


class Response:
    def __init__(self, body: str | bytes = "", status: int = 200,
                 content_type: str = "text/html; charset=utf-8",
                 headers: Optional[List[Tuple[str, str]]] = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.headers = [("Content-Type", content_type),
                        ("Cache-Control", "no-store")] + (headers or [])

    @classmethod
    def json(cls, data: Any, status: int = 200,
             headers: Optional[List[Tuple[str, str]]] = None) -> "Response":
        return cls(json.dumps(data, default=str), status,
                   "application/json", headers)

    @classmethod
    def redirect(cls, location: str,
                 headers: Optional[List[Tuple[str, str]]] = None) -> "Response":
        return cls("", 302, headers=[("Location", location)] + (headers or []))


_STATUS = {200: "200 OK", 302: "302 Found", 400: "400 Bad Request",
           401: "401 Unauthorized", 404: "404 Not Found",
           405: "405 Method Not Allowed",
           413: "413 Payload Too Large",
           500: "500 Internal Server Error"}


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def secure_filename(name: str) -> str:
    name = os.path.basename(name.replace("\\", "/"))
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    return name or "upload"


def validate_phone(phone: str) -> bool:
    """E.164-like: optional leading +, 8-15 digits (≙ ``app.py:1093-1100``)."""
    return bool(phone) and re.fullmatch(r"\+?\d{8,15}", phone) is not None


def redact_phone(phone: str) -> Optional[str]:
    if not phone:
        return None
    return f"***{phone[-4:]}" if len(phone) >= 4 else "***"


class App:
    def __init__(self, autoload: bool = True, upload_dir: str = "uploads",
                 data_dir: str = "data/app", log_root: str = "logs",
                 checkpoints_root: str = "checkpoints", device: Any = "cuda"):
        self.device = resolve_device(device)
        self.upload_dir = upload_dir
        self.checkpoints_root = checkpoints_root
        os.makedirs(upload_dir, exist_ok=True)
        self.auth = AuthStore(data_dir)
        self.jobs = JobManager()
        self.cache = ResultsCache()
        self.telemetry = TelemetryLogger(os.path.join(log_root, "agent_actions",
                                                      "telemetry.log"))
        self.enhanced_agent = EnhancedDecisionAgent()
        self.enhanced_agent.telemetry = self.telemetry
        self.enhanced_agent.active_learner = ActiveLearner(
            os.path.join(data_dir, "active_queue.jsonl"),
            os.path.join(data_dir, "active_labels.jsonl"),
            telemetry=self.telemetry)
        self.decision_agent = DecisionAgent()
        self.monitoring_agent = MonitoringAgent(
            os.path.join(log_root, "agent_monitoring"))
        # CRITICAL alerts notify the requesting user's phone when one is
        # configured (≙ WebActionAgent, ``app.py:1116-1137``); the phone is
        # carried per request in a thread-local so concurrent requests
        # (and background job workers) never see each other's numbers.
        self._agent_ctx = threading.local()
        self.action_agent = ActionAgent(os.path.join(log_root, "agent_actions"),
                                        notify_fn=self._phone_notify)
        self.predictor: Optional[Predictor] = None
        self.last_results: Dict[str, Dict[str, Any]] = {}  # per-user last result
        self.agent_config: Dict[str, Any] = {"enabled": True}

        if autoload and not env_bool("NO_AUTOLOAD"):
            loaded = loader_mod.attempt_autoload(checkpoints_root, self.device)
            if loaded:
                model, variables, stats = loaded
                self.predictor = Predictor(model, variables,
                                           stats["model_type"],
                                           checkpoint_path=stats["path"],
                                           enhanced_agent=self.enhanced_agent,
                                           device=self.device)
                logger.info("autoloaded %s (%s)", stats["path"],
                            stats["model_type"])

        self.routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._install_routes()

    # -- plumbing --------------------------------------------------------------

    def route(self, method: str, pattern: str):
        rx = re.compile("^" + pattern + "$")

        def deco(fn):
            self.routes.append((method, rx, fn))
            return fn

        return deco

    def __call__(self, environ, start_response):
        req = Request(environ)
        try:
            req.check_content_length()
            resp = self._dispatch(req)
        except PayloadTooLarge as e:
            resp = Response.json({"error": str(e)}, 413)
        except Exception as e:
            logger.exception("unhandled error")
            resp = Response.json({"error": str(e)}, 500)
        start_response(_STATUS.get(resp.status, f"{resp.status} Status"),
                       resp.headers + [("Content-Length", str(len(resp.body)))])
        return [resp.body]

    def _dispatch(self, req: Request) -> Response:
        allowed = []
        for method, rx, fn in self.routes:
            m = rx.match(req.path)
            if m:
                if method == req.method:
                    return fn(req, **m.groupdict())
                allowed.append(method)
        if allowed:
            return Response("method not allowed", 405)
        return Response(T._page("Not found",
                                '<div class="card"><h2>404</h2></div>'), 404)

    def _user(self, req: Request) -> Optional[str]:
        return self.auth.user_for_token(req.cookies.get("session"))

    # -- inference helpers ------------------------------------------------------

    def _phone_notify(self, result) -> Optional[str]:
        """CRITICAL-alert hook (≙ ``WebActionAgent._notify_admin``,
        ``app.py:1121-1133``): log a phone notification for the requesting
        user when a valid number is configured; None falls back to the
        ActionAgent's default admin log."""
        phone = getattr(self._agent_ctx, "phone", None)
        if not (phone and validate_phone(phone)):
            return None
        path = os.path.join(self.action_agent.output_dir,
                            "notifications.jsonl")
        entry = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                 "phone": phone,
                 "message": (f"CRITICAL deepfake alert for {result.video_id} "
                             f"({result.confidence:.1%}): "
                             f"{result.explanation}")}
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(entry) + "\n")
        return f"Notification logged for {phone}"

    def _resolve_notify_phone(self, user: Optional[str]) -> Optional[str]:
        return self.auth.get_secrets(user).get("phone") if user else None

    def _process_saved_files(self, saved: List[Tuple[str, str]],
                             user: Optional[str]) -> List[Dict[str, Any]]:
        """≙ ``_ui_process_saved_files`` (``app.py:164``): predict each file,
        run the web agent pipeline, build message + 200-word justification."""
        # runs on request AND job-worker threads: resolve the notification
        # phone from the requesting user's secrets here, where both paths
        # converge; ALWAYS clear it on exit so a pooled/reused thread never
        # leaks one user's number into another request's alerts
        self._agent_ctx.phone = self._resolve_notify_phone(user)
        try:
            return self._process_saved_files_inner(saved, user)
        finally:
            self._agent_ctx.phone = None

    def _process_saved_files_inner(self, saved: List[Tuple[str, str]],
                                   user: Optional[str]) -> List[Dict[str, Any]]:
        items = []
        for filename, path in saved:
            if self.predictor is None:
                result: Dict[str, Any] = {"error": "Model not loaded. Please "
                                          "load a checkpoint first."}
            else:
                result = self.predictor.predict_video(path)
            item = {
                "filename": filename,
                "result": result,
                "message": simple_english_message(result, filename),
                "justification":
                    simple_english_justification_200_words(result, filename)
                    if env_bool("UI_ENABLE_JUSTIFICATION", True) else "",
            }
            if (self.agent_config.get("enabled", True)
                    and env_bool("UI_ENABLE_AGENT", True)
                    and not result.get("error")):
                try:
                    decision = self.decision_agent.process({
                        "video_id": filename,
                        "probs": [result.get("prob_real") or 0.0,
                                  result.get("prob_fake") or 0.0],
                        "pred_class": result.get("pred_class"),
                        "confidence": result.get("confidence"),
                        "frame_scores": None,
                    })
                    self.monitoring_agent.process(decision)
                    self.action_agent.process(decision)
                    item["agent"] = {"alert_level": decision.alert_level.name,
                                     "explanation": decision.explanation}
                except Exception:
                    pass
            if user:
                self.last_results[user] = result
            self.last_results["__public__"] = result
            items.append(item)
        return items

    def _save_uploads(self, req: Request) -> List[Tuple[str, str]]:
        saved = []
        for field, filename, content in req.files():
            if field not in ("videos", "video", "file", "files"):
                continue
            fname = secure_filename(filename)
            path = os.path.join(self.upload_dir, f"{uuid.uuid4().hex}_{fname}")
            with open(path, "wb") as f:
                f.write(content)
            saved.append((fname, path))
        return saved

    # -- routes ------------------------------------------------------------------

    def _install_routes(self) -> None:
        app = self

        @self.route("GET", r"/")
        def index(req):
            return Response(T.index_page(app._user(req)))

        @self.route("GET", r"/about")
        def about(req):
            return Response(T.about_page(app._user(req)))

        @self.route("GET", r"/health")
        def health(req):
            return Response.json({"status": "ok",
                                  "model_loaded": app.predictor is not None})

        @self.route("GET", r"/ui")
        def ui(req):
            return Response(T.ui_page(app._user(req)))

        @self.route("GET", r"/dashboard")
        def dashboard(req):
            user = app._user(req)
            uploads = app.auth.list_uploads(user) if user else []
            return Response(T.dashboard_page(user, uploads))

        # ---- auth ----

        @self.route("GET", r"/login")
        def login_get(req):
            return Response(T.login_page(app._user(req)))

        @self.route("POST", r"/login")
        def login_post(req):
            form = req.form()
            token = app.auth.login(form.get("email", ""), form.get("password", ""))
            if token is None:
                return Response(T.login_page(None, "Invalid email or password"))
            return Response.redirect(
                "/dashboard", [("Set-Cookie",
                                f"session={token}; Path=/; HttpOnly")])

        @self.route("GET", r"/signup")
        def signup_get(req):
            return Response(T.signup_page(app._user(req)))

        @self.route("POST", r"/signup")
        def signup_post(req):
            form = req.form()
            token = app.auth.signup(form.get("email", ""), form.get("password", ""))
            if token is None:
                return Response(T.signup_page(None, "Could not create account "
                                              "(already exists?)"))
            return Response.redirect(
                "/dashboard", [("Set-Cookie",
                                f"session={token}; Path=/; HttpOnly")])

        @self.route("GET", r"/logout")
        def logout(req):
            app.auth.logout(req.cookies.get("session"))
            return Response.redirect(
                "/", [("Set-Cookie", "session=; Path=/; Max-Age=0")])

        # ---- sync predict ----

        def _sync_predict(req):
            saved = app._save_uploads(req)
            if not saved:
                return Response.json({"error": "no files uploaded"}, 400)
            items = app._process_saved_files(saved, app._user(req))
            key = app.cache.put(items)
            return Response(T.results_page(items, app._user(req)),
                            headers=[("Set-Cookie",
                                      f"ui_results={key}; Path=/")])

        self.route("POST", r"/ui/predict")(_sync_predict)
        self.route("POST", r"/predict")(_sync_predict)

        # ---- async job flow ----

        @self.route("POST", r"/results")
        def results_post(req):
            saved = app._save_uploads(req)
            if not saved:
                return Response(T.ui_page(app._user(req)))
            user = app._user(req)
            job_id = app.jobs.submit(
                lambda: app.cache.put(
                    app._process_saved_files(saved, user), key=None))
            return Response.redirect(f"/results?job={job_id}")

        @self.route("GET", r"/results")
        def results_get(req):
            user = app._user(req)
            job_id = req.query.get("job")
            if job_id:
                st = app.jobs.status(job_id)
                if st is None:
                    return Response(T.results_page([], user))
                if st["status"] in ("queued", "running"):
                    return Response(T.processing_page(job_id, user))
                if st["status"] == "error":
                    return Response(T.results_page(
                        [{"filename": "upload",
                          "result": {"error": st["error"]}}], user))
                items = app.cache.get(st["result"]) or []
                return Response(T.results_page(items, user))
            key = req.cookies.get("ui_results")
            items = app.cache.get(key) if key else None
            return Response(T.results_page(items or [], user))

        @self.route("GET", r"/ui/results")
        def ui_results(req):
            return results_get(req)

        @self.route("GET", r"/api/ui-job/(?P<job_id>[0-9a-f]+)")
        def ui_job(req, job_id):
            st = app.jobs.status(job_id)
            if st is None:
                return Response.json({"status": "expired",
                                      "error": "job expired — upload again"}, 404)
            return Response.json({"status": st["status"], "error": st["error"]})

        # ---- uploads API ----

        @self.route("POST", r"/api/upload")
        def api_upload(req):
            user = app._user(req)
            if not user:
                return Response.json({"error": "login required"}, 401)
            saved = app._save_uploads(req)
            if not saved:
                return Response.json({"error": "no file"}, 400)
            items = app._process_saved_files(saved, user)
            out = []
            for item in items:
                rec = {
                    "id": uuid.uuid4().hex,
                    "filename": item["filename"],
                    "verdict": item["result"].get("prediction", "error"),
                    "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "result": item["result"],
                    "message": item["message"],
                    "justification": item["justification"],
                }
                app.auth.add_upload(user, rec)
                out.append({k: rec[k] for k in ("id", "filename", "verdict")})
            return Response.json({"uploads": out})

        @self.route("GET", r"/api/uploads")
        def api_uploads(req):
            user = app._user(req)
            if not user:
                return Response.json({"error": "login required"}, 401)
            ups = [{k: u.get(k) for k in ("id", "filename", "verdict", "ts")}
                   for u in app.auth.list_uploads(user)]
            return Response.json({"uploads": ups})

        @self.route("GET", r"/result/(?P<rid>[0-9a-f]+)")
        def result_html(req, rid):
            user = app._user(req)
            rec = app.auth.get_upload(user, rid) if user else None
            if rec is None:
                return Response(T._page("Not found",
                                        '<div class="card">Result not found.'
                                        '</div>'), 404)
            return Response(T.result_page(user, rec))

        @self.route("GET", r"/api/result/(?P<rid>[0-9a-f]+)")
        def result_json(req, rid):
            user = app._user(req)
            rec = app.auth.get_upload(user, rid) if user else None
            if rec is None:
                return Response.json({"error": "not found"}, 404)
            return Response.json(rec)

        # ---- chat ----

        @self.route("POST", r"/api/chat")
        def api_chat(req):
            user = app._user(req)
            if not user:
                return Response.json({"error": "login required"}, 401)
            message = req.json().get("message", "")
            secrets = app.auth.get_secrets(user)
            reply = chat_mod.generate_chat_reply_gemini(
                message, app.last_results.get(user),
                api_key=secrets.get("gemini_api_key"))
            return Response.json({"reply": reply})

        @self.route("POST", r"/api/chat-public")
        def api_chat_public(req):
            message = req.json().get("message", "")
            reply = chat_mod.generate_chat_reply(
                message, app.last_results.get("__public__"),
                loader_mod.LAST_LOAD_STATS or None)
            return Response.json({"reply": reply})

        @self.route("POST", r"/api/gemini-report-public")
        def api_report(req):
            data = req.json()
            result = data.get("result") or app.last_results.get("__public__")
            if not result:
                return Response.json({"error": "no result available"}, 400)
            report = chat_mod.gemini_generate_english_report(
                result, data.get("filename", ""))
            return Response.json({"report": report})

        @self.route("GET", r"/api/chat-config")
        def chat_config_get(req):
            user = app._user(req)
            if not user:
                return Response.json({"error": "login required"}, 401)
            s = app.auth.get_secrets(user)
            return Response.json({"has_gemini_key": bool(s.get("gemini_api_key")),
                                  "phone": s.get("phone", "")})

        @self.route("POST", r"/api/chat-config")
        def chat_config_post(req):
            user = app._user(req)
            if not user:
                return Response.json({"error": "login required"}, 401)
            data = req.json()
            values = {k: v for k, v in data.items()
                      if k in ("gemini_api_key", "phone")}
            app.auth.set_secrets(user, values)
            return Response.json({"ok": True})

        @self.route("GET", r"/api/agent-config")
        def agent_config_get(req):
            # reference contract (``app.py:3063-3068``): logged-in users
            # also see their notification-phone status, redacted
            out = dict(app.agent_config)
            user = app._user(req)
            if user:
                phone = app.auth.get_secrets(user).get("phone") or ""
                out.update({"success": True, "configured": bool(phone),
                            "redacted_phone": redact_phone(phone)})
            return Response.json(out)

        @self.route("POST", r"/api/agent-config")
        def agent_config_post(req):
            data = req.json()
            phone = user = None
            if "notification_phone" in data:
                # ≙ ``app.py:3070-3081``: validated, stored per user.
                # Validate BEFORE applying anything so a bad request is
                # all-or-nothing; str() coerces a JSON-number phone.
                user = app._user(req)
                if not user:
                    return Response.json(
                        {"success": False, "error": "Not authenticated"}, 401)
                phone = str(data.get("notification_phone") or "").strip()
                if not validate_phone(phone):
                    return Response.json(
                        {"success": False,
                         "error": "Invalid phone number. Use digits with "
                                  "optional leading + (8-15 digits)."}, 400)
            if "enabled" in data:
                app.agent_config["enabled"] = bool(data["enabled"])
            for k in ("decision_threshold", "abstain_uncertainty_threshold",
                      "min_agreement_to_act", "uncertainty_penalty"):
                if k in data:
                    try:
                        setattr(app.enhanced_agent, k, float(data[k]))
                        app.agent_config[k] = float(data[k])
                    except (TypeError, ValueError):
                        pass
            out = dict(app.agent_config)
            if phone is not None:
                app.auth.set_secrets(user, {"phone": phone})
                out.update({"success": True,
                            "message": "Notification phone saved"})
            return Response.json(out)

        # ---- model / metrics API ----

        @self.route("GET", r"/api/metrics")
        def api_metrics(req):
            return Response.json(get_training_metrics(app.checkpoints_root))

        @self.route("GET", r"/api/model-info")
        def model_info(req):
            device = getattr(app.predictor, "device", app.device).type
            info = {
                "loaded": app.predictor is not None,
                "model_type": getattr(app.predictor, "model_type", None),
                "checkpoint": getattr(app.predictor, "checkpoint_path", None),
                "device": device,
                "load_stats": loader_mod.LAST_LOAD_STATS,
            }
            mb = getattr(app.predictor, "_batcher", None)
            if mb is not None:
                info["microbatch"] = {
                    "batches_run": mb.batches_run,
                    "items_run": mb.items_run,
                    "mean_batch": round(mb.items_run / mb.batches_run, 2)
                    if mb.batches_run else None,
                }
            return Response.json(info)

        @self.route("GET", r"/api/checkpoints")
        def api_checkpoints(req):
            # Ranked loadable checkpoints for the dashboard's model panel
            # dropdown (the reference's app.js reads a #checkpoint-select it
            # never populates, static/js/app.js:190 — here the list is
            # served, ranked by the autoload score).
            paths = loader_mod.rank_checkpoints_for_autoload(
                app.checkpoints_root)
            current = getattr(app.predictor, "checkpoint_path", None)
            return Response.json({"checkpoints": paths, "current": current})

        @self.route("POST", r"/api/load-model")
        def api_load_model(req):
            data = req.json()
            path = data.get("path") or data.get("checkpoint")
            if not path:
                return Response.json({"error": "checkpoint path not found"}, 400)
            # Unauthenticated route: confine loadable paths to the checkpoints
            # tree so it cannot be used to deserialise arbitrary server files
            # (the reference accepts any path, app.py:3175 — deliberately
            # diverge; opt back in with ALLOW_ANY_MODEL_PATH=1). Confinement
            # runs BEFORE the existence check so the route is not a
            # filesystem path-existence oracle for the rest of the disk.
            if os.environ.get("ALLOW_ANY_MODEL_PATH", "0").lower() not in (
                    "1", "true", "yes"):
                root = os.path.realpath(app.checkpoints_root)
                real = os.path.realpath(path)
                if os.path.commonpath([root, real]) != root:
                    return Response.json(
                        {"error": "checkpoint path outside the checkpoints "
                                  "root (set ALLOW_ANY_MODEL_PATH=1 to "
                                  "permit)"}, 403)
            if not os.path.exists(path):
                return Response.json({"error": "checkpoint path not found"}, 400)
            try:
                model, variables, stats = loader_mod.load_model(
                    path, data.get("model_type"), app.device)
            except ValueError as e:
                return Response.json({"error": str(e)}, 400)
            old = app.predictor
            app.predictor = Predictor(model, variables, stats["model_type"],
                                      checkpoint_path=path,
                                      enhanced_agent=app.enhanced_agent,
                                      device=app.device)
            # release the replaced predictor's batcher worker thread
            if old is not None:
                old.close()
            return Response.json({"ok": True, "stats": stats})

        @self.route("POST", r"/api/predict")
        def api_predict(req):
            if app.predictor is None:
                return Response.json({"error": "Model not loaded"}, 400)
            ctype = req.environ.get("CONTENT_TYPE", "")
            def truthy(v) -> bool:
                return str(v or "").strip().lower() in ("1", "true", "yes", "on")

            if ctype.startswith("multipart/"):
                saved = app._save_uploads(req)
                if not saved:
                    return Response.json({"error": "no file"}, 400)
                explain = truthy(req.query.get("explain")) or \
                    truthy(req.form_fields().get("explain"))
                result = app.predictor.predict_video(saved[0][1],
                                                     explain=explain)
                app.last_results["__public__"] = result
                return Response.json(result)
            data = req.json()
            path = data.get("path")
            if not path or not os.path.exists(path):
                return Response.json({"error": "provide a file upload or a "
                                      "valid 'path'"}, 400)
            explain = truthy(req.query.get("explain")) or \
                truthy(data.get("explain"))
            result = app.predictor.predict_video(path, explain=explain)
            if env_bool("API_ENABLE_AGENT", True) and not result.get("error"):
                try:
                    decision = app.decision_agent.process({
                        "video_id": os.path.basename(path),
                        "probs": [result.get("prob_real") or 0.0,
                                  result.get("prob_fake") or 0.0],
                        "pred_class": result.get("pred_class"),
                        "confidence": result.get("confidence"),
                        "frame_scores": None})
                    app.monitoring_agent.process(decision)
                    app.action_agent.process(decision)
                    result["agent"] = {
                        "alert_level": decision.alert_level.name,
                        "explanation": decision.explanation}
                except Exception:
                    pass
            app.last_results["__public__"] = result
            return Response.json(result)


def get_training_metrics(root: str = "checkpoints") -> Dict[str, Any]:
    """Per-epoch metrics recomputed from ``preds_epoch_N.csv`` files
    (≙ ``get_training_metrics``, ``app.py:1287-1325``)."""
    from deepfake_video_detection_tpu_torch.evals.metrics import binary_metrics, roc_auc

    epochs: List[Dict[str, Any]] = []
    for path in sorted(_glob.glob(os.path.join(root, "**", "preds_epoch_*.csv"),
                                  recursive=True)):
        m = re.search(r"preds_epoch_(\d+)\.csv$", path)
        if not m:
            continue
        labels, preds, probs = [], [], []
        try:
            with open(path, newline="") as f:
                for row in csv.DictReader(f):
                    labels.append(int(float(row["label"])))
                    preds.append(int(float(row["pred"])))
                    probs.append(float(row.get("prob_fake", 0.5)))
        except (OSError, KeyError, ValueError):
            continue
        if not labels:
            continue
        import numpy as np

        la, pa = np.asarray(labels), np.asarray(preds)
        stats = binary_metrics(la, pa)
        stats["auc"] = roc_auc(la, np.asarray(probs))
        # 2x2 confusion matrix [[TN, FP], [FN, TP]] + sample count, consumed
        # by the dashboard's per-epoch confusion grid and metrics table
        # (≙ renderConfusionMatrices/renderMetricsTable,
        # static/js/app.js:115-153)
        stats["confusion_matrix"] = [
            [int(np.sum((la == 0) & (pa == 0))),
             int(np.sum((la == 0) & (pa == 1)))],
            [int(np.sum((la == 1) & (pa == 0))),
             int(np.sum((la == 1) & (pa == 1)))]]
        stats["total_samples"] = int(la.size)
        epochs.append({"epoch": int(m.group(1)), **stats})
    epochs.sort(key=lambda e: e["epoch"])
    return {"epochs": epochs}


def create_app(autoload: bool = True, **kwargs) -> App:
    """The WSGI callable: ``App(autoload=autoload, **kwargs)``."""
    return App(autoload=autoload, **kwargs)


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """The stdlib WSGI server, one daemon thread a request. Its listen
    backlog is 32, where the JAX package's server keeps socketserver's 5:
    with more clients connecting at once than that, the kernel drops the
    overflow's SYNs and each waits out TCP's one-second retransmission
    (8 concurrent uploads made 7.1 clips/s against 16.1 at 32 on an H100
    80GB HBM3 at 700 W, ``chip_smoke.py``'s ``web_app`` phase)."""
    daemon_threads = True
    request_queue_size = 32


def _startup_hardening() -> None:
    """≙ the reference's import-time hardening (``app.py:5-14, 102-109``):
    crash tracebacks via faulthandler and BLAS thread caps so host math
    libraries don't oversubscribe the decode workers' cores."""
    import faulthandler

    faulthandler.enable()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None) -> int:
    _startup_hardening()
    ap = argparse.ArgumentParser(description="Deepfake detection web app")
    ap.add_argument("--host", default=env_str("HOST", "0.0.0.0"))
    ap.add_argument("--port", type=int, default=env_int("PORT", 5000))
    ap.add_argument("--debug", action="store_true",
                    default=env_bool("DEBUG"))
    ap.add_argument("--no-autoload", dest="no_autoload", action="store_true",
                    default=env_bool("NO_AUTOLOAD"))
    ap.add_argument("--device", default="cuda",
                    help="device the models run on (cuda, or cpu without a card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    app = create_app(autoload=not args.no_autoload, device=args.device)

    with make_server(args.host, args.port, app,
                     server_class=ThreadingWSGIServer) as httpd:
        logger.info("serving on %s:%d (model_loaded=%s)", args.host,
                    args.port, app.predictor is not None)
        httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

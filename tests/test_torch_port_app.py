"""The port's web app (``serve/app.py`` and the modules under it) against the
JAX package's, on the CPU.

Both apps are driven through their WSGI callables with the same requests.
The served set-up is ``tests/test_serve.py``'s: ``FACE_SIZE=32``,
``FACE_DETECTOR=center``, ``DETECT_ABSTAIN_CONF=0.0``, a ``CNNLSTMHybrid``
checkpoint saved by the JAX package's ``save_checkpoint`` (weights from
``random_variables``, so no JAX init compile) and a 12-frame clip written by
its ``encode_video``; ``SERVE_WARMUP=0`` (the legacy path has one forward
shape, which the first request builds). Pages, auth, chat and report texts,
the small routes and the agents' files must be equal byte for byte;
``prob_fake`` within 5e-4; the legacy ``DeepfakeDetector`` within 5e-4 on
``cnn_lstm`` and on ``vit_gcn`` over ViT-Tiny with two blocks. The live
Gemini and Firebase paths run against a loopback server, and both packages
must send it the same requests. The port's app runs on ``device="cpu"``.
"""

import contextlib
import hashlib
import http.server
import io
import json
import os
import threading
import time
from datetime import datetime
from unittest import mock

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX side runs on the CPU: tests/conftest.py)
import torch

from deepfake_video_detection_tpu.agents.active_learning import ActiveLearner as JaxLearner
from deepfake_video_detection_tpu.agents.telemetry import TelemetryLogger as JaxTelemetry
from deepfake_video_detection_tpu.checkpoint.store import save_checkpoint
from deepfake_video_detection_tpu.data.faces import FaceExtractor as JaxExtractor
from deepfake_video_detection_tpu.data.video import encode_video
from deepfake_video_detection_tpu.models.cnn_lstm import CNNLSTMHybrid as JaxCNNLSTM
from deepfake_video_detection_tpu.serve import app as jax_app
from deepfake_video_detection_tpu.serve import auth as jax_auth
from deepfake_video_detection_tpu.serve import chat as jax_chat
from deepfake_video_detection_tpu.serve import loader as jax_loader
from deepfake_video_detection_tpu.serve import templates as jax_templates
from deepfake_video_detection_tpu.serve.auth_sqlite import SQLiteAuth as JaxSQLite
from deepfake_video_detection_tpu.serve.detector import DeepfakeDetector as JaxDetector
from deepfake_video_detection_tpu.serve.detector import generate_explanation as jax_explanation
from deepfake_video_detection_tpu.utils import profiling as jax_profiling
from deepfake_video_detection_tpu_torch.agents import ActiveLearner, TelemetryLogger
from deepfake_video_detection_tpu_torch.agents.system import AlertLevel, PredictionResult
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.serve import app as port_app
from deepfake_video_detection_tpu_torch.serve import auth as port_auth
from deepfake_video_detection_tpu_torch.serve import chat as port_chat
from deepfake_video_detection_tpu_torch.serve import loader as port_loader
from deepfake_video_detection_tpu_torch.serve import templates as port_templates
from deepfake_video_detection_tpu_torch.serve.auth_sqlite import SQLiteAuth
from deepfake_video_detection_tpu_torch.serve.detector import DeepfakeDetector
from deepfake_video_detection_tpu_torch.serve.detector import generate_explanation
from deepfake_video_detection_tpu_torch.utils import profiling

from test_torch_port_convnets import random_variables

PROB_ATOL = 5e-4
SIZE = 32
SERVED_ENV = {"FACE_SIZE": str(SIZE), "DETECT_ABSTAIN_CONF": "0.0", "FACE_DETECTOR": "center",
              "SERVE_WARMUP": "0"}
FORM = "application/x-www-form-urlencoded"
JSON = "application/json"
RESULT = {"prediction": "Deepfake", "verdict_yes_no": "Yes", "pred_class": 1,
          "confidence": 0.87, "prob_fake": 0.87, "prob_real": 0.13, "num_faces": 4,
          "threshold": 0.5, "frame_scores": [0.1, 0.6, 0.2, 0.1],
          "description": "Detected indicators of synthetic manipulation in facial frames."}


# -- the WSGI helpers of tests/test_serve.py ---------------------------------


def call(app, method, path, body=b"", content_type="", cookies=None, query=""):
    environ = {
        "REQUEST_METHOD": method,
        "PATH_INFO": path,
        "QUERY_STRING": query,
        "CONTENT_LENGTH": str(len(body)),
        "CONTENT_TYPE": content_type,
        "wsgi.input": io.BytesIO(body),
    }
    if cookies:
        environ["HTTP_COOKIE"] = "; ".join(f"{k}={v}" for k, v in cookies.items())
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])
        captured["headers"] = headers

    chunks = app(environ, start_response)
    body_out = b"".join(chunks)
    return captured["status"], dict(captured["headers"]), body_out


def multipart(field, filename, content):
    boundary = "testboundary123"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="{filename}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n").encode()
    body += content + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def both(apps, *args, **kwargs):
    """The same request through the JAX app and the port's app."""
    return [call(a, *args, **kwargs) for a in apps]


def _cookie(headers):
    return headers["Set-Cookie"].split(";")[0].split("=", 1)[1]


def _make_apps(root, shared_data=False):
    """A JAX app and a port app over ``root``: their own upload and log
    directories, one data directory when ``shared_data``, one checkpoints
    root."""
    out = []
    for tag, mod, extra in (("jax", jax_app, {}), ("port", port_app, {"device": "cpu"})):
        out.append(mod.App(autoload=False, upload_dir=str(root / f"{tag}_uploads"),
                           data_dir=str(root / ("data" if shared_data else f"{tag}_data")),
                           log_root=str(root / f"{tag}_logs"),
                           checkpoints_root=str(root / "ckpts"), **extra))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SERVED_ENV.items():
            mp.setenv(k, v)
        for k in ("GEMINI_API_KEY", "GOOGLE_API_KEY", "FIREBASE_API_KEY",
                  "FIREBASE_DATABASE_URL", "FLASK_SECRET", "SECRET_KEY", "NO_AUTOLOAD",
                  "ALLOW_ANY_MODEL_PATH", "MAX_UPLOAD_MB"):
            mp.delenv(k, raising=False)
        ckpt = root / "ckpts" / "checkpoint_best.npz"
        save_checkpoint(str(ckpt), random_variables(JaxCNNLSTM(), 0),
                        meta={"model_config": {"model_type": "cnn_lstm"}})
        vid = root / "clip.avi"
        frames = np.stack([np.full((48, 48, 3), 30 * (i % 8), np.uint8) for i in range(12)])
        encode_video(str(vid), frames, fps=8)
        apps = _make_apps(root)
        for app in apps:
            status, _, body = call(app, "POST", "/api/load-model",
                                   json.dumps({"path": str(ckpt)}).encode(), JSON)
            assert status == 200, body
        yield apps, str(ckpt), str(vid)
        apps[1].predictor.close()


@pytest.fixture
def clean_env(monkeypatch):
    for k, v in SERVED_ENV.items():
        monkeypatch.setenv(k, v)
    for k in ("GEMINI_API_KEY", "GOOGLE_API_KEY", "FIREBASE_API_KEY", "FIREBASE_DATABASE_URL",
              "FIREBASE_IDENTITY_BASE", "FLASK_SECRET", "SECRET_KEY", "MAX_UPLOAD_MB",
              "ALLOW_ANY_MODEL_PATH"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["/", "/about", "/ui", "/login", "/signup", "/dashboard",
                                  "/results", "/ui/results", "/definitely-missing"])
def test_pages_are_byte_equal(served, clean_env, path):
    apps, _, _ = served
    (js, jh, jb), (ps, ph, pb) = both(apps, "GET", path)
    assert js == ps and jb == pb and jh == ph
    assert ps == (404 if path == "/definitely-missing" else 200)


def test_templates_render_byte_equal():
    items = [{"filename": "x.avi", "result": RESULT, "message": "m",
              "justification": "j " * 10,
              "agent": {"alert_level": "HIGH", "explanation": "e"}},
             {"filename": "y.avi", "result": {"error": "No faces detected in video"}}]
    windows = dict(RESULT, windows={"count": 2, "prob_fake": [0.2, 0.9],
                                    "deciding_window": 1})
    rec = {"id": "ab", "filename": "x.avi", "verdict": "Deepfake", "ts": "t",
           "result": RESULT, "message": "m", "justification": "j"}
    for user in (None, "u@example.com"):
        for name, args in (("index_page", (user,)), ("about_page", (user,)),
                           ("ui_page", (user,)), ("login_page", (user, "bad")),
                           ("signup_page", (user, "bad")),
                           ("processing_page", ("deadbeef", user)),
                           ("results_page", (items, user)),
                           ("results_page", ([{"filename": "w", "result": windows}], user)),
                           ("dashboard_page", (user, [rec])),
                           ("result_page", (user, rec))):
            assert getattr(port_templates, name)(*args) == \
                getattr(jax_templates, name)(*args), (name, user)


# ---------------------------------------------------------------------------
# auth across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_data_dir_and_cookie_serve_the_other_package(tmp_path, clean_env, first):
    clean_env.setenv("FLASK_SECRET", "a-shared-secret")
    jax_a, port_a = _make_apps(tmp_path, shared_data=True)
    writer, reader = (jax_a, port_a) if first == "jax" else (port_a, jax_a)
    form = b"email=User%40Example.com&password=hunter22"
    status, headers, _ = call(writer, "POST", "/signup", form, FORM)
    assert status == 302
    token = _cookie(headers)
    # the cookie minted by one package verifies in the other
    for app in (writer, reader):
        status, _, body = call(app, "GET", "/api/uploads", cookies={"session": token})
        assert status == 200 and json.loads(body) == {"uploads": []}
    # the other package reads the users file: duplicate signup fails, login works
    status, _, body = call(reader, "POST", "/signup", form, FORM)
    assert b"Could not create account" in body
    status, _, body = call(reader, "POST", "/login",
                           b"email=user%40example.com&password=wrong", FORM)
    assert b"Invalid" in body
    status, headers, _ = call(reader, "POST", "/login", form, FORM)
    assert status == 302
    token2 = _cookie(headers)
    assert token2.startswith("s.")
    # a result stored by one package renders the same page in both
    rec = {"id": "abc123", "filename": "x.avi", "verdict": "Deepfake", "ts": "t",
           "result": RESULT, "message": "m", "justification": "j"}
    writer.auth.add_upload("user@example.com", rec)
    (js, _, jb), (ps, _, pb) = both((jax_a, port_a), "GET", "/result/abc123",
                                    cookies={"session": token2})
    assert js == ps == 200 and jb == pb
    (js, _, jb), (ps, _, pb) = both((jax_a, port_a), "GET", "/api/result/abc123",
                                    cookies={"session": token2})
    assert js == ps == 200 and jb == pb and json.loads(pb)["result"] == RESULT
    (js, _, jb), (ps, _, pb) = both((jax_a, port_a), "GET", "/dashboard",
                                    cookies={"session": token})
    assert jb == pb and b"x.avi" in pb
    # the on-disk formats: users.json with a PBKDF2 hash, secrets.json
    users = json.load(open(tmp_path / "data" / "users.json"))
    assert users["user@example.com"]["password"].startswith("pbkdf2$")
    call(reader, "POST", "/api/chat-config", json.dumps({"phone": "+15551234567"}).encode(),
         JSON, cookies={"session": token})
    for app in (writer, reader):
        status, _, body = call(app, "GET", "/api/chat-config", cookies={"session": token})
        assert json.loads(body) == {"has_gemini_key": False, "phone": "+15551234567"}


def test_password_hashes_and_tokens_match_jax(clean_env):
    stored = jax_auth._hash_password("pw", "00" * 16)
    assert port_auth._hash_password("pw", "00" * 16) == stored
    for ours, theirs in ((port_auth, jax_auth), (jax_auth, port_auth)):
        assert ours._verify_password("pw", theirs._hash_password("pw"))
        assert not ours._verify_password("nope", theirs._hash_password("pw"))
    assert port_auth._verify_password("pw", hashlib.sha256(b"pw").hexdigest())
    clean_env.setenv("FLASK_SECRET", "k")
    for ours, theirs in ((port_auth, jax_auth), (jax_auth, port_auth)):
        a, b = ours.AuthStore("unused"), theirs.AuthStore("unused")
        assert b.user_for_token(a._new_session("u@x.com")) == "u@x.com"
        token = a._new_session("u@x.com")
        assert b.user_for_token(token.rsplit(".", 1)[0] + "." + "0" * 32) is None
        assert b.user_for_token("s.dQ.1.deadbeef") is None


@pytest.mark.parametrize("first", ["jax", "port"])
def test_sqlite_store_is_shared(tmp_path, first):
    path = str(tmp_path / "auth.db")
    a, b = (JaxSQLite(path), SQLiteAuth(path)) if first == "jax" else \
        (SQLiteAuth(path), JaxSQLite(path))
    uid = a.create_user("A@b.c", "secret")
    assert b.create_user("a@b.c", "other") is None
    assert b.verify_user("a@b.c", "secret") == uid and b.verify_user("a@b.c", "x") is None
    up = b.add_upload(uid, "clip.mp4")
    a.update_upload(up, "Real", 0.93)
    assert a.list_uploads(uid) == b.list_uploads(uid)
    assert b.list_uploads(uid)[0]["verdict"] == "Real"
    b.delete_upload(up)
    assert a.list_uploads(uid) == []


# ---------------------------------------------------------------------------
# load and predict
# ---------------------------------------------------------------------------


def _same_prediction(ours, ref):
    assert "error" not in ours and "error" not in ref, (ours, ref)
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        if key in ("prob_fake", "prob_real", "confidence"):
            assert ours[key] == pytest.approx(want, abs=PROB_ATOL), key
        elif key == "agent":
            assert ours[key]["alert_level"] == want["alert_level"]
        else:
            assert ours[key] == want, key


def test_load_model_and_predict_match_jax(served, clean_env):
    apps, ckpt, vid = served
    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/load-model",
                                    json.dumps({"path": ckpt}).encode(), JSON)
    assert js == ps == 200
    jstats, pstats = json.loads(jb)["stats"], json.loads(pb)["stats"]
    assert sorted(jstats) == sorted(pstats)
    for k in ("model_type", "path", "match_ratio"):
        assert jstats[k] == pstats[k], k
    assert pstats["model_type"] == "cnn_lstm" and pstats["match_ratio"] >= 0.99

    (_, _, jb), (_, _, pb) = both(apps, "GET", "/api/model-info")
    jinfo, pinfo = json.loads(jb), json.loads(pb)
    assert sorted(jinfo) == sorted(pinfo)
    assert pinfo["device"] == "cpu" == jinfo["device"]
    for k in ("loaded", "model_type", "checkpoint"):
        assert pinfo[k] == jinfo[k], k
    (_, _, jb), (_, _, pb) = both(apps, "GET", "/api/checkpoints")
    assert jb == pb and json.loads(pb) == {"checkpoints": [ckpt], "current": ckpt}

    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/predict",
                                    json.dumps({"path": vid}).encode(), JSON)
    assert js == ps == 200
    ours, ref = json.loads(pb), json.loads(jb)
    _same_prediction(ours, ref)
    assert "agent" in ours and ours["num_faces"] >= 1

    body, ct = multipart("video", "clip.avi", open(vid, "rb").read())
    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/predict", body, ct)
    assert js == ps == 200
    _same_prediction(json.loads(pb), json.loads(jb))
    assert json.loads(pb)["prob_fake"] == pytest.approx(ours["prob_fake"], abs=1e-6)

    # explain on a legacy model is a no-op in both
    (_, _, jb), (_, _, pb) = both(apps, "POST", "/api/predict",
                                  json.dumps({"path": vid, "explain": 1}).encode(), JSON)
    assert "saliency" not in json.loads(pb)
    _same_prediction(json.loads(pb), json.loads(jb))

    # no model, no upload, a bad path: the same answers
    for args in (("POST", "/api/predict", json.dumps({"path": "/nope.avi"}).encode(), JSON),
                 ("POST", "/api/load-model", b"{}", JSON),
                 ("POST", "/api/load-model",
                  json.dumps({"path": os.path.join(os.path.dirname(ckpt), "x.npz")}).encode(),
                  JSON)):
        (js, _, jb), (ps, _, pb) = both(apps, *args)
        assert js == ps == 400 and jb == pb


def test_model_swap_closes_the_replaced_predictor(served, clean_env):
    apps, ckpt, _ = served
    papp = apps[1]
    old = papp.predictor
    closed = []
    old.close = lambda: closed.append(True)
    status, _, _ = call(papp, "POST", "/api/load-model", json.dumps({"path": ckpt}).encode(),
                        JSON)
    assert status == 200 and closed == [True] and papp.predictor is not old
    assert papp.predictor.device.type == "cpu"


def test_async_results_flow_matches_jax(served, clean_env):
    apps, _, vid = served
    body, ct = multipart("videos", "clip_fake.avi", open(vid, "rb").read())
    items = []
    for app in apps:
        status, headers, _ = call(app, "POST", "/results", body, ct)
        assert status == 302
        job_id = headers["Location"].split("job=")[1]
        for _ in range(300):
            status, _, out = call(app, "GET", f"/api/ui-job/{job_id}")
            st = json.loads(out)["status"]
            if st not in ("queued", "running"):
                break
            time.sleep(0.05)
        assert st == "done", out
        status, _, page = call(app, "GET", "/results", query=f"job={job_id}")
        assert status == 200 and b"clip_fake.avi" in page and b"Verdict" in page
        items.append(app.cache.get(app.jobs.status(job_id)["result"]))
    (jitem,), (pitem,) = items
    assert pitem["filename"] == jitem["filename"] == "clip_fake.avi"
    _same_prediction(pitem["result"], jitem["result"])
    assert pitem["agent"]["alert_level"] == jitem["agent"]["alert_level"]
    assert pitem["message"] == jitem["message"]
    assert len(pitem["justification"].split()) == 200
    (js, _, jb), (ps, _, pb) = both(apps, "GET", "/api/ui-job/deadbeef")
    assert js == ps == 404 and jb == pb
    # the synchronous route gives the same verdict
    (js, jh, _), (ps, ph, page) = both(apps, "POST", "/ui/predict", body, ct)
    assert js == ps == 200 and b"clip_fake.avi" in page
    assert ph["Set-Cookie"].startswith("ui_results=")


# ---------------------------------------------------------------------------
# chat and report
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _loopback_server(responder):
    """A JSON HTTP server on 127.0.0.1 (``tests/test_aux.py``'s): ``responder
    (method, path, body) -> (status, payload)``; yields (base URL, calls)."""
    calls = []

    class H(http.server.BaseHTTPRequestHandler):
        def _handle(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            calls.append((self.command, self.path, body))
            status, payload = responder(self.command, self.path, body)
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = do_PUT = _handle

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", calls
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


MESSAGES = ["", "hello", "how does it work?", "what model is loaded?", "why this verdict?",
            "what is the threshold?", "what's the weather in Paris?", "tell me about ai",
            "what accuracy does it reach?"]


def _chat_pair(tmp_path, monkeypatch):
    apps = _make_apps(tmp_path)
    stats = {"model_type": "cnn_lstm", "backbones": None, "match_ratio": 1.0}
    monkeypatch.setattr(jax_loader, "LAST_LOAD_STATS", dict(stats))
    monkeypatch.setattr(port_loader, "LAST_LOAD_STATS", dict(stats))
    tokens = []
    for app in apps:
        _, headers, _ = call(app, "POST", "/signup", b"email=c%40x.com&password=pw", FORM)
        tokens.append(_cookie(headers))
        app.last_results["c@x.com"] = app.last_results["__public__"] = dict(RESULT)
    return apps, tokens


def test_offline_chat_and_report_are_byte_equal(tmp_path, clean_env):
    apps, tokens = _chat_pair(tmp_path, clean_env)
    for msg in MESSAGES:
        payload = json.dumps({"message": msg}).encode()
        outs = [call(app, "POST", "/api/chat", payload, JSON, cookies={"session": tok})
                for app, tok in zip(apps, tokens)]
        assert outs[0][0] == outs[1][0] == 200 and outs[0][2] == outs[1][2], msg
        (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/chat-public", payload, JSON)
        assert js == ps == 200 and jb == pb, msg
    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/chat", b'{"message": "hi"}', JSON)
    assert js == ps == 401 and jb == pb
    for payload in ({}, {"result": dict(RESULT, prediction="Real", pred_class=0),
                         "filename": "a.mp4"}):
        (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/gemini-report-public",
                                        json.dumps(payload).encode(), JSON)
        assert js == ps == 200 and jb == pb
        assert len(json.loads(pb)["report"].split()) == 200
    for app in apps:
        app.last_results.pop("__public__")
    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/gemini-report-public", b"{}", JSON)
    assert js == ps == 400 and jb == pb


def test_live_gemini_requests_match_jax(tmp_path, clean_env):
    apps, tokens = _chat_pair(tmp_path, clean_env)

    def ok(method, path, body):
        return 200, {"candidates": [{"content": {"parts": [{"text": "LIVE REPLY"}]}}]}

    with _loopback_server(ok) as (base, calls):
        for mod in (jax_chat, port_chat):
            clean_env.setattr(mod, "_GEMINI_URL", base + "/gen?key={key}")
        for app, tok in zip(apps, tokens):
            call(app, "POST", "/api/chat-config", b'{"gemini_api_key": "K"}', JSON,
                 cookies={"session": tok})
            status, _, body = call(app, "POST", "/api/chat",
                                   b'{"message": "why was my video flagged as fake?"}',
                                   JSON, cookies={"session": tok})
            assert json.loads(body) == {"reply": "LIVE REPLY"}
            # off topic: answered locally, the API is not called
            call(app, "POST", "/api/chat", b'{"message": "weather?"}', JSON,
                 cookies={"session": tok})
        clean_env.setenv("GEMINI_API_KEY", "G")
        for app in apps:
            status, _, body = call(app, "POST", "/api/gemini-report-public",
                                   b'{"filename": "a.mp4"}', JSON)
            assert json.loads(body) == {"report": "LIVE REPLY"}
    assert len(calls) == 4
    assert calls[0] == calls[1] and calls[2] == calls[3]
    assert "key=K" in calls[0][1] and "key=G" in calls[2][1]

    def err(method, path, body):
        return 500, {"error": "boom"}

    with _loopback_server(err) as (base, calls):
        for mod in (jax_chat, port_chat):
            clean_env.setattr(mod, "_GEMINI_URL", base + "/gen?key={key}")
        (_, _, jb), (_, _, pb) = both(apps, "POST", "/api/gemini-report-public",
                                      b'{"filename": "a.mp4"}', JSON)
        assert jb == pb and len(json.loads(pb)["report"].split()) == 200
    assert len(calls) == 2 and calls[0] == calls[1]


def test_live_firebase_requests_match_jax(tmp_path, clean_env):
    accounts = {}

    def fb(method, path, body):
        req = json.loads(body)
        if "accounts:signUp" in path:
            accounts[req["email"]] = req["password"]
            return 200, {"localId": "uid-42", "idToken": "tok1"}
        if accounts.get(req["email"]) == req["password"]:
            return 200, {"localId": "uid-42", "idToken": "tok2"}
        return 400, {"error": {"message": "INVALID_PASSWORD"}}

    apps = _make_apps(tmp_path)
    with _loopback_server(fb) as (base, calls):
        clean_env.setenv("FIREBASE_API_KEY", "fbkey")
        clean_env.setenv("FIREBASE_IDENTITY_BASE", base)
        for app in apps:
            accounts.clear()
            outs = [call(app, "POST", "/signup", b"email=F%40x.com&password=pw1", FORM),
                    call(app, "POST", "/login", b"email=f%40x.com&password=pw1", FORM),
                    call(app, "POST", "/login", b"email=f%40x.com&password=bad", FORM)]
            assert [o[0] for o in outs] == [302, 302, 200]
            assert app.auth.fb_uids == {"f@x.com": "uid-42"}
    assert len(calls) == 6 and calls[:3] == calls[3:]
    assert "accounts:signUp?key=fbkey" in calls[0][1]

    store = {}

    def rtdb(method, path, body):
        if method == "PUT":
            store[path] = json.loads(body)
            return 200, store[path]
        return 200, {rec["id"]: rec for rec in store.values()}

    listed = []
    with _loopback_server(rtdb) as (base, calls):
        clean_env.setenv("FIREBASE_DATABASE_URL", base)
        for app in apps:
            store.clear()
            app.auth.add_upload("f@x.com", {"id": "up1", "filename": "a.mp4"})
            store["/uploads/uid-42/up9.json"] = {"id": "up9", "filename": "b.mp4"}
            listed.append(app.auth.list_uploads("f@x.com"))
    assert listed[0] == listed[1] and {r["id"] for r in listed[1]} == {"up1", "up9"}
    assert calls[:2] == calls[2:]


# ---------------------------------------------------------------------------
# the small routes
# ---------------------------------------------------------------------------


def test_agent_config_and_notification_phone_match_jax(tmp_path, clean_env):
    apps = _make_apps(tmp_path)
    tokens = []
    for app in apps:
        _, headers, _ = call(app, "POST", "/signup", b"email=p%40x.com&password=pw", FORM)
        tokens.append(_cookie(headers))
    steps = [({"enabled": False, "decision_threshold": 0.42}, False),
             ({"notification_phone": "+15551234567"}, False),
             ({"notification_phone": "nope"}, True),
             ({"notification_phone": "+15551234567"}, True),
             ({"notification_phone": 15551234567}, True),
             ({"notification_phone": "+15551234567", "decision_threshold": 0.61}, True),
             ({"enabled": True, "decision_threshold": "x"}, True),
             ({"decision_threshold": 0.5}, True)]
    for data, authed in steps:
        outs = [call(app, "POST", "/api/agent-config", json.dumps(data).encode(), JSON,
                     cookies={"session": tok} if authed else None)
                for app, tok in zip(apps, tokens)]
        assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2], data
        outs = [call(app, "GET", "/api/agent-config",
                     cookies={"session": tok} if authed else None)
                for app, tok in zip(apps, tokens)]
        assert outs[0][2] == outs[1][2], data
    assert json.loads(outs[1][2])["redacted_phone"] == "***4567"
    assert apps[1].enhanced_agent.decision_threshold == 0.5

    # a CRITICAL alert with the requesting user's phone in the request's
    # context logs a phone notification; the context is cleared after
    papp = apps[1]
    papp._agent_ctx.phone = papp._resolve_notify_phone("p@x.com")
    critical = PredictionResult(video_id="clip.avi", is_fake=True, confidence=0.99,
                                alert_level=AlertLevel.CRITICAL, frame_scores=np.ones(4),
                                timestamp=datetime.now(), explanation="very fake")
    summary = papp.action_agent.process(critical)
    assert any("Notification logged for +15551234567" in a for a in summary["actions_taken"])
    papp._process_saved_files([], "p@x.com")
    assert getattr(papp._agent_ctx, "phone", None) is None
    summary = papp.action_agent.process(critical)
    assert any("admin notified" in a for a in summary["actions_taken"])


class _CriticalPredictor:
    """Stands in for the Predictor: every clip is a confident fake."""
    device = torch.device("cpu")

    def predict_video(self, path, explain=False):
        time.sleep(0.001)
        return {"prediction": "Deepfake", "pred_class": 1, "confidence": 0.99,
                "prob_fake": 0.99, "prob_real": 0.01, "num_faces": 4}


def test_concurrent_requests_keep_their_own_phone(tmp_path, clean_env):
    """Request and job threads share one Predictor and one ActionAgent: each
    CRITICAL notification carries the phone of the user whose upload raised
    it, under a short switch interval with more threads than cores."""
    import sys

    papp = _make_apps(tmp_path)[1]
    papp.predictor = _CriticalPredictor()
    n = 2 * (os.cpu_count() or 2) + 2
    users = {f"u{i}@x.com": f"+1555000{i:04d}" for i in range(n)}
    for user, phone in users.items():
        papp.auth.set_secrets(user, {"phone": phone})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(i, user):
            papp._process_saved_files([(f"clip_{i}.mp4", "unused")] * 3, user)

        threads = [threading.Thread(target=run, args=(i, u)) for i, u in enumerate(users)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    path = os.path.join(papp.action_agent.output_dir, "notifications.jsonl")
    entries = [json.loads(line) for line in open(path)]
    assert len(entries) == 3 * n
    for e in entries:
        i = int(e["message"].split("clip_")[1].split(".mp4")[0])
        assert e["phone"] == users[f"u{i}@x.com"], e


def test_load_model_path_restriction_matches_jax(served, clean_env, tmp_path):
    apps, _, _ = served
    outside = tmp_path / "evil.npz"
    np.savez(str(outside), x=np.zeros(3))
    for path in (str(outside), str(tmp_path / "nope.npz")):
        (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/load-model",
                                        json.dumps({"path": path}).encode(), JSON)
        assert js == ps == 403 and jb == pb and b"checkpoints root" in pb


def test_payload_too_large_and_multipart_fuzz_match_jax(served, clean_env):
    apps, _, _ = served
    clean_env.setenv("MAX_UPLOAD_MB", "1")
    body, ct = multipart("video", "big.avi", b"x" * 16)
    outs = []
    for app in apps:
        environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/api/predict",
                   "QUERY_STRING": "", "CONTENT_LENGTH": str(2_000_000),
                   "CONTENT_TYPE": ct, "wsgi.input": io.BytesIO(body)}
        captured = {}
        out = b"".join(app(environ, lambda s, h: captured.update(status=s)))
        outs.append((captured["status"], out))
    assert outs[0] == outs[1] and outs[1][0].startswith("413") and b"MAX_UPLOAD_MB" in outs[1][1]
    clean_env.delenv("MAX_UPLOAD_MB")
    cases = [
        (b"--wrong\r\ngarbage", "multipart/form-data; boundary=testboundary123"),
        (b"\xff\xfe\x00\x01" * 64, "multipart/form-data; boundary=zzz"),
        (b"--b\r\nContent-Disposition: form-data; name=\"video\"\r\n\r\ndata"
         b"\r\n--b--\r\n", "multipart/form-data; boundary=b"),
        (b"no body at all", "multipart/form-data"),
    ]
    for raw, ctype in cases:
        for path in ("/predict", "/api/predict", "/api/upload", "/results"):
            (js, _, jb), (ps, _, pb) = both(apps, "POST", path, raw, ctype)
            assert js == ps and jb == pb, (path, raw[:20])
            assert ps in (200, 400, 401)
    (js, _, _), (ps, _, _) = both(apps, "DELETE", "/api/predict")
    assert js == ps == 405


def test_multipart_preserves_trailing_newline_bytes():
    content = b"\r\nMOOV\x00\x01\r\r\n\n\r\n"
    body, ct = multipart("video", "clip.mp4", content)
    for mod in (jax_app, port_app):
        req = mod.Request({"REQUEST_METHOD": "POST", "PATH_INFO": "/api/predict",
                           "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
                           "CONTENT_TYPE": ct, "wsgi.input": io.BytesIO(body)})
        assert req.files() == [("video", "clip.mp4", content)]


@pytest.mark.parametrize("text", ["clip.mp4", "../../etc/passwd", "a b\\c.avi", "", "ü.mov",
                                  "+15551234567", "12345678", "1234567", "1" * 16, "+1-555",
                                  "abc"])
def test_helpers_match_jax(text):
    assert port_app.secure_filename(text) == jax_app.secure_filename(text)
    assert port_app.validate_phone(text) == jax_app.validate_phone(text)
    assert port_app.redact_phone(text) == jax_app.redact_phone(text)


def test_training_metrics_match_jax(tmp_path, served, clean_env):
    d = tmp_path / "ck" / "run"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for epoch in (2, 0, 1):
        with open(d / f"preds_epoch_{epoch}.csv", "w") as f:
            f.write("path,label,pred,prob_fake\n")
            for i in range(20):
                p = float(rng.uniform())
                f.write(f"v{i},{i % 2},{int(p > 0.5)},{p}\n")
    (d / "preds_epoch_x.csv").write_text("junk\n")
    ours = port_app.get_training_metrics(str(tmp_path / "ck"))
    ref = jax_app.get_training_metrics(str(tmp_path / "ck"))
    assert [e["epoch"] for e in ours["epochs"]] == [0, 1, 2]
    assert json.dumps(ours) == json.dumps(ref)
    apps, _, _ = served
    (_, _, jb), (_, _, pb) = both(apps, "GET", "/api/metrics")
    assert jb == pb


def test_health_and_uploads_routes_match_jax(served, clean_env):
    apps, _, vid = served
    (_, _, jb), (_, _, pb) = both(apps, "GET", "/health")
    assert jb == pb == b'{"status": "ok", "model_loaded": true}'
    body, ct = multipart("video", "clip.avi", open(vid, "rb").read())
    (js, _, jb), (ps, _, pb) = both(apps, "POST", "/api/upload", body, ct)
    assert js == ps == 401 and jb == pb
    outs = []
    for app in apps:
        _, headers, _ = call(app, "POST", "/signup", b"email=up%40x.com&password=pw", FORM)
        token = _cookie(headers)
        status, _, out = call(app, "POST", "/api/upload", body, ct, cookies={"session": token})
        assert status == 200
        (rec,) = json.loads(out)["uploads"]
        status, _, out = call(app, "GET", f"/api/result/{rec['id']}",
                              cookies={"session": token})
        outs.append(json.loads(out))
        status, _, page = call(app, "GET", f"/result/{rec['id']}", cookies={"session": token})
        assert status == 200 and b"clip.avi" in page
        (listed,) = json.loads(call(app, "GET", "/api/uploads",
                                    cookies={"session": token})[2])["uploads"]
        assert sorted(listed) == ["filename", "id", "ts", "verdict"]
    assert sorted(outs[0]) == sorted(outs[1]) and outs[0]["verdict"] == outs[1]["verdict"]
    _same_prediction(outs[1]["result"], outs[0]["result"])


# ---------------------------------------------------------------------------
# agents, the legacy detector and profiling
# ---------------------------------------------------------------------------


def _learner_files(tmp_path, learner_cls, telemetry_cls):
    tel = telemetry_cls(str(tmp_path / "logs" / "telemetry.log"))
    al = learner_cls(str(tmp_path / "q" / "q.jsonl"), str(tmp_path / "l.jsonl"),
                     retrain_threshold=2, telemetry=tel)
    for i, vid in enumerate("abcd"):
        al.queue_for_label({"video_id": vid, "confidence": 0.01 * i, "ensemble_prob": 0.5,
                            "uncertainty": 0.7, "note": "ü", "arr": np.float32(0.5)})
    labels = {"a": 1, "c": 0}
    n = al.process_queue_with_label_provider(labels.get)
    n2 = al.process_queue_with_label_provider(lambda vid: None)
    tel.log_event({"event": "custom", "ts": 3.0, "x": [1, 2]})
    return ((n, n2, al.labeled_count(), al.should_retrain()),
            {p: open(tmp_path / p, "rb").read()
             for p in ("q/q.jsonl", "l.jsonl", "logs/telemetry.log")})


def test_active_learner_and_telemetry_files_are_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    ours = _learner_files(tmp_path / "port", ActiveLearner, TelemetryLogger)
    ref = _learner_files(tmp_path / "jax", JaxLearner, JaxTelemetry)
    assert ours == ref and ours[0] == (2, 0, 2, True)


def test_active_learner_export_is_byte_equal(tmp_path):
    vids = tmp_path / "uploads"
    vids.mkdir()
    rng = np.random.default_rng(0)
    for name in ("clip_f.avi", "clip_r.avi"):
        encode_video(str(vids / name), rng.integers(0, 255, (12, 64, 64, 3)).astype(np.uint8),
                     fps=10)
    outs = []
    for tag, cls, ex in (("jax", JaxLearner, JaxExtractor(detector="center", face_size=SIZE)),
                         ("port", ActiveLearner,
                          FaceExtractor(detector="center", face_size=SIZE, device="cpu"))):
        al = cls(str(tmp_path / tag / "q.jsonl"), str(tmp_path / tag / "l.jsonl"))
        for vid in ("clip_f.avi", "clip_r.avi", "gone.avi", str(vids / "clip_r.avi")):
            al.queue_for_label({"video_id": vid, "confidence": 0.1})
        al.process_queue_with_label_provider(lambda v: int("clip_f" in v))
        counts = al.export_labeled_dataset(str(tmp_path / tag / "out"), videos_dir=str(vids),
                                           extractor=ex, num_frames=4)
        out = tmp_path / tag / "out"
        outs.append((counts, {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}))
    assert outs[0] == outs[1]
    assert outs[1][0] == {"exported": 3, "skipped": 1} and len(outs[1][1]) == 3


@pytest.fixture(scope="module")
def detector_clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("det") / "v.avi"
    rng = np.random.default_rng(3)
    encode_video(str(path), rng.integers(0, 255, (8, 64, 64, 3)).astype(np.uint8), fps=6)
    return str(path)


@pytest.mark.parametrize("family", ["cnn_lstm", "vit_gcn"])
def test_deepfake_detector_matches_jax(detector_clip, family):
    from test_torch_port_legacy import _cnn_lstm_pair, _graph_pair

    jm, v, pm = _cnn_lstm_pair(seed=2) if family == "cnn_lstm" else _graph_pair(192, seed=2)
    ref = JaxDetector(jm, v, model_type=family,
                      extractor=JaxExtractor(detector="center", face_size=SIZE)).detect(
        detector_clip)
    det = DeepfakeDetector(pm, None, model_type=family, device="cpu",
                           extractor=FaceExtractor(detector="center", face_size=SIZE,
                                                   device="cpu"))
    ours = det.detect(detector_clip)
    assert det.device.type == "cpu" and not pm.training
    assert sorted(ours) == sorted(ref)
    assert ours["num_faces"] == ref["num_faces"] >= 2
    assert ours["confidence"] == pytest.approx(ref["confidence"], abs=PROB_ATOL)
    assert abs(ref["confidence"] - 0.5) > PROB_ATOL and ours["is_fake"] == ref["is_fake"]
    assert ours["explanation"] == generate_explanation(ours["is_fake"], ours["confidence"],
                                                    ours["num_faces"])
    # a clip that cannot be read: no faces, zeros through the model
    missing = os.path.join(os.path.dirname(detector_clip), "missing.avi")
    assert det.detect(missing)["num_faces"] == 0


@pytest.mark.parametrize("args", [(1, 0.93, 4), (0, 0.07, 0), (1, 0.5, 10), (0, 0.49951, 1)])
def test_explanation_text_matches_jax(args):
    assert generate_explanation(*args) == jax_explanation(*args)


def test_stage_timer_and_trace(tmp_path, monkeypatch):
    # the JAX package's StageTimer and the port's spans over the same ticks:
    # the port keeps every span, not the last three
    ticks = iter(np.arange(0.0, 100.0, 0.0125).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = jax_profiling.StageTimer(window=3)
    ns = iter(range(0, 10 ** 11, 12_500_000))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ns))
    profiling.clear()
    with profiling.recording():
        for stage in (timer.stage, profiling.annotate):
            for _ in range(5):
                for name in ("decode", "detect", "forward"):
                    with stage(name):
                        pass
            with pytest.raises(ValueError):
                with stage("fails"):
                    raise ValueError
    monkeypatch.undo()
    theirs, ours = timer.summary(), profiling.summary()
    profiling.clear()
    assert set(ours) == set(theirs) == {"decode", "detect", "forward", "fails"}
    for name, s in theirs.items():
        for key in ("p50_ms", "max_ms"):
            assert ours[name][key] == pytest.approx(s[key]), (name, key)
    assert theirs["decode"]["count"] == 3 and ours["decode"]["count"] == 5
    assert ours["fails"]["count"] == 1 and ours["decode"]["p95_ms"] == 12.5

    # trace: a TensorBoard trace with the annotated region; a no-op without a directory
    monkeypatch.delenv("DFDT_PROFILE_DIR", raising=False)
    with profiling.trace(None), profiling.annotate("nothing"):
        torch.ones(2).sum()
    for where in ("arg", "env"):
        out = tmp_path / where
        if where == "env":
            monkeypatch.setenv("DFDT_PROFILE_DIR", str(out))
        with profiling.trace(str(out) if where == "arg" else None):
            with profiling.annotate("dfdt_stage"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        (name,) = os.listdir(out)
        assert name.endswith(".pt.trace.json")
        assert "dfdt_stage" in (out / name).read_text()


def test_app_asks_for_the_card_by_default(tmp_path):
    kw = dict(autoload=False, upload_dir=str(tmp_path / "u"), data_dir=str(tmp_path / "d"),
              log_root=str(tmp_path / "l"), checkpoints_root=str(tmp_path / "c"))
    if torch.cuda.is_available():
        assert port_app.App(**kw).device.type == "cuda"
        return
    for make in (lambda: port_app.App(device="cuda", **kw), lambda: port_app.App(**kw),
                 lambda: port_app.create_app(**kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with mock.patch.dict(os.environ), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        port_app.main(["--no-autoload", "--port", "0"])      # the thread caps stay inside
    app = port_app.create_app(device="cpu", **kw)
    status, _, body = call(app, "GET", "/api/model-info")
    assert json.loads(body)["device"] == "cpu" and json.loads(body)["loaded"] is False


def test_server_listen_backlog_repairs_the_reference():
    """The JAX app's server keeps socketserver's listen backlog of 5; the
    port's is 32, so 8 clients connecting at once, before the server accepts
    any, all connect at once (none waits out a dropped SYN) and each gets
    its answer."""
    import socket
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    seen = {}

    class Stop(Exception):
        pass

    def capture(host, port, app, server_class=None, **kw):
        seen["server_class"] = server_class
        raise Stop

    with mock.patch.object(jax_app, "_startup_hardening"), \
            mock.patch.object(jax_app, "create_app", return_value=None), \
            mock.patch("wsgiref.simple_server.make_server", capture), \
            pytest.raises(Stop):
        jax_app.main(["--no-autoload", "--port", "0"])
    assert seen["server_class"].request_queue_size == 5
    assert port_app.ThreadingWSGIServer.request_queue_size == 32

    def hello(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [environ["PATH_INFO"].encode()]

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    server = make_server("127.0.0.1", 0, hello, server_class=port_app.ThreadingWSGIServer,
                         handler_class=Quiet)
    port = server.server_address[1]
    socks = []
    try:
        for i in range(8):          # queued in the backlog: nothing accepts yet
            s = socket.create_connection(("127.0.0.1", port), timeout=0.5)
            s.sendall(f"GET /{i} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
            socks.append(s)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        for i, s in enumerate(socks):
            s.settimeout(10)
            data = b""
            while chunk := s.recv(4096):
                data += chunk
            assert data.startswith(b"HTTP/1.0 200") and data.endswith(f"/{i}".encode()), data
    finally:
        for s in socks:
            s.close()
        server.shutdown()
        server.server_close()

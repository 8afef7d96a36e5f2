"""HTML templates for the web UI, rendered server-side with str.format.

Covers the reference's template surface (SURVEY.md §2.5: ``ui.html``,
``dashboard.html``, ``result.html``, ``ui_results.html``,
``ui_processing.html``, ``login/signup/about``) as compact framework-free
pages: multi-file upload posting to ``/results``, a processing page polling
``/api/ui-job/<id>`` every 1.5 s, a results page with the typed justification,
a dashboard with upload history + chat, and auth forms. Styling is a single
embedded stylesheet (the reference ships ~630 lines of CSS + a canvas
starfield; the equivalent visual chrome here is minimal by design).

A copy of ``deepfake_video_detection_tpu/serve/templates.py`` kept in the
port: for the same inputs every page renders the same bytes.
"""

from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional

_STYLE = """
:root { color-scheme: dark; }
* { box-sizing: border-box; }
body { margin: 0; font-family: system-ui, sans-serif; background: #0b0f1a;
       color: #e6e9f0; min-height: 100vh; }
a { color: #7aa2ff; text-decoration: none; }
nav { display: flex; gap: 1rem; padding: 1rem 2rem; background: #101627;
      align-items: center; }
nav .brand { font-weight: 700; color: #fff; margin-right: auto; }
main { max-width: 880px; margin: 2rem auto; padding: 0 1rem; }
.card { background: #131a2e; border: 1px solid #232d4a; border-radius: 12px;
        padding: 1.5rem; margin-bottom: 1.25rem; }
h1, h2 { margin-top: 0; }
input, button, textarea { font: inherit; border-radius: 8px; }
input[type=text], input[type=email], input[type=password], textarea {
  width: 100%; padding: .6rem .8rem; background: #0d1322; color: #e6e9f0;
  border: 1px solid #2c365e; }
button { background: #3b5bdb; color: #fff; border: 0; padding: .65rem 1.4rem;
         cursor: pointer; }
button:hover { background: #4c6ef5; }
.verdict-fake { color: #ff6b6b; font-weight: 700; }
.verdict-real { color: #51cf66; font-weight: 700; }
.verdict-unsure { color: #fcc419; font-weight: 700; }
table { width: 100%; border-collapse: collapse; }
td, th { padding: .45rem .6rem; border-bottom: 1px solid #232d4a;
         text-align: left; }
.muted { color: #8b93a7; font-size: .9rem; }
pre { white-space: pre-wrap; }
.result-head { display: flex; align-items: center; gap: 1rem; }
.gauge { flex: none; }
.probbar { display: flex; height: 1.25rem; border-radius: 6px;
           overflow: hidden; font-size: .72rem; line-height: 1.25rem;
           max-width: 420px; }
.pb-real { background: #2c6e49; color: #d6f5e3; padding-left: .4rem;
           white-space: nowrap; overflow: hidden; }
.pb-fake { background: #9e2b25; color: #ffd9d6; padding-left: .4rem;
           white-space: nowrap; overflow: hidden; }
.chat-log { max-height: 280px; overflow-y: auto; }
.chat-msg-user { color: #7aa2ff; }
.chat-msg-bot { color: #d3d7e3; }
.dropzone { border: 2px dashed #2c365e; border-radius: 12px; padding: 2.2rem;
            text-align: center; cursor: pointer; margin-bottom: 1rem; }
.dropzone.drag { border-color: #4c6ef5; background: #101937; }
.legend-item { cursor: pointer; user-select: none; }
.legend-item.off { opacity: 0.35; }
.tabbar { display: flex; gap: .5rem; margin-bottom: 1.25rem; }
.tab-btn { background: #131a2e; color: #8b93a7; border: 1px solid #232d4a; }
.tab-btn.active { background: #3b5bdb; color: #fff; border-color: #3b5bdb; }
.tab-content { display: none; }
.tab-content.active { display: block; }
.alert { display: none; padding: .7rem 1rem; border-radius: 8px;
         margin-bottom: 1rem; }
.alert-error { background: #3b1420; color: #ff8787; border: 1px solid #9e2b25; }
.alert-success { background: #11301f; color: #8ce99a; border: 1px solid #2c6e49; }
.progress-track { height: 8px; background: #0d1322; border-radius: 4px;
                  overflow: hidden; margin: .6rem 0; }
.progress-fill { height: 100%; width: 0; background: #4c6ef5;
                 transition: width .3s; }
.cm-grid { display: flex; flex-wrap: wrap; gap: 1rem; }
.cm { background: #0d1322; border: 1px solid #232d4a; border-radius: 8px;
      padding: .6rem .8rem; }
.cm table { width: auto; }
.cm td, .cm th { border: 1px solid #232d4a; text-align: center;
                 padding: .3rem .7rem; }
.cm .cm-head { color: #8b93a7; font-size: .8rem; }
.info-item { padding: .3rem 0; }
.info-item .label { color: #8b93a7; margin-right: .5rem; }
.chat-launcher { position: fixed; right: 1.2rem; bottom: 1.2rem;
                 border-radius: 999px; padding: .7rem 1.2rem; z-index: 10;
                 box-shadow: 0 4px 18px #0008; }
.chat-panel { display: none; position: fixed; right: 1.2rem; bottom: 4.4rem;
              width: min(22rem, calc(100vw - 2.4rem)); background: #131a2e;
              border: 1px solid #232d4a; border-radius: 12px; z-index: 10;
              box-shadow: 0 8px 30px #000a; }
.chat-panel.open { display: block; }
.chat-head { display: flex; align-items: center; gap: .5rem;
             padding: .6rem .9rem; border-bottom: 1px solid #232d4a; }
.chat-head .title { font-weight: 700; margin-right: auto; }
.chat-head button { background: none; padding: .1rem .4rem; color: #8b93a7; }
.chat-body { padding: .6rem .9rem; }
.chat-foot { display: flex; gap: .5rem; padding: .6rem .9rem;
             border-top: 1px solid #232d4a; }
"""


# canvas starfield backdrop ≙ the reference's ``static/js/space.js``
# (155 LoC drifting-stars canvas behind the chrome pages); dependency-free
# and honors prefers-reduced-motion.
_STARFIELD = """
<canvas id="space" style="position:fixed;inset:0;z-index:-1"></canvas>
<script>
(function () {
  const c = document.getElementById('space'), x = c.getContext('2d');
  let stars = [];
  function seed() {
    c.width = innerWidth; c.height = innerHeight;
    stars = Array.from({length: Math.min(180, c.width >> 3)}, () => ({
      x: Math.random() * c.width, y: Math.random() * c.height,
      z: 0.2 + Math.random() * 0.8, r: 0.4 + Math.random() * 1.3}));
  }
  function tick() {
    x.clearRect(0, 0, c.width, c.height);
    for (const s of stars) {
      s.y += s.z * 0.25;
      if (s.y > c.height) { s.y = 0; s.x = Math.random() * c.width; }
      x.globalAlpha = 0.35 + 0.5 * s.z;
      x.fillStyle = '#9db4ff';
      x.beginPath(); x.arc(s.x, s.y, s.r, 0, 7); x.fill();
    }
    requestAnimationFrame(tick);
  }
  function still() {  // one static frame for prefers-reduced-motion
    x.globalAlpha = 0.6; x.fillStyle = '#9db4ff';
    for (const s of stars) { x.beginPath(); x.arc(s.x, s.y, s.r, 0, 7); x.fill(); }
  }
  addEventListener('resize', seed);
  seed();
  matchMedia('(prefers-reduced-motion: reduce)').matches ? still() : tick();
})();
</script>"""


def _page(title: str, body: str, user: Optional[str] = None,
          extra_head: str = "", starfield: bool = False) -> str:
    user_nav = (f'<span class="muted">{html.escape(user)}</span> '
                f'<a href="/logout">Logout</a>' if user else
                '<a href="/login">Login</a> <a href="/signup">Sign up</a>')
    backdrop = _STARFIELD if starfield else ""
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)} · Deepfake Video Detection</title>
<style>{_STYLE}</style>{extra_head}</head>
<body>{backdrop}
<nav><a class="brand" href="/">Deepfake Detector</a>
<a href="/ui">Analyze</a><a href="/dashboard">Dashboard</a>
<a href="/about">About</a>{user_nav}</nav>
<main>{body}</main>
</body></html>"""


def index_page(user: Optional[str]) -> str:
    return _page("Home", """
<div class="card"><h1>Deepfake Video Detection</h1>
<p>TPU-accelerated detector: upload a video and get a real/fake verdict with
calibrated confidence, frame-level attention scores, and a plain-English
explanation.</p>
<p><a href="/ui"><button>Analyze a video</button></a></p></div>""", user,
                 starfield=True)


# Educational chrome ≙ the reference's ``ui.html`` info sections
# (:502-598: Understanding Deepfakes / Detection Challenges / Key Detection
# Methods card grids); content written for this framework.
_INFO_SECTIONS = """
<div class="card"><h2>Understanding deepfakes</h2>
<p>Deepfakes swap or re-animate a face with a generative model. The seams
are subtle — slightly wrong blinking, lighting that disagrees with the
scene, compression artifacts that cluster around the blended region — and
they get harder to spot every year.</p></div>
<div class="card"><h2>Why detection is hard</h2>
<table>
<tr><td><b>Video quality</b></td><td>Re-compression and low resolution
destroy many of the tell-tale artifacts detectors rely on.</td></tr>
<tr><td><b>Generator evolution</b></td><td>Every new generation of forgery
models removes the artifacts the last generation of detectors learned.</td></tr>
<tr><td><b>Speed vs accuracy</b></td><td>Scanning every frame of every
upload at full resolution is expensive; sampling must not miss the
manipulated segment.</td></tr>
<tr><td><b>Diverse artifacts</b></td><td>Face swaps, re-enactment, and
full-frame synthesis each leave different fingerprints.</td></tr>
</table></div>
<div class="card"><h2>How this detector works</h2>
<table>
<tr><td><b>Facial analysis</b></td><td>Faces are detected and cropped per
frame (MTCNN cascade with a Haar fallback), so the model sees the region
where manipulation happens.</td></tr>
<tr><td><b>Frequency cues</b></td><td>Training augmentation includes
DCT-domain JPEG simulation, forcing the backbone to rely on cues that
survive compression.</td></tr>
<tr><td><b>Temporal coherence</b></td><td>A temporal attention head fuses
evidence across sampled frames and reports which frames drove the
verdict.</td></tr>
<tr><td><b>Ensembles &amp; calibration</b></td><td>Multiple backbones can
vote, and a threshold sweep from training calibrates the final real/fake
decision with an abstention band.</td></tr>
</table></div>"""


def about_page(user: Optional[str]) -> str:
    return _page("About", """
<div class="card"><h2>About</h2>
<p>This service samples frames from an uploaded video, crops the faces, and
runs them through a convolutional backbone compiled for TPUs. A temporal
attention head fuses per-frame evidence into a single verdict, thresholded by
a calibration sweep from training. An agent layer adds uncertainty-aware
alerts, abstention, and monitoring.</p></div>""" + _INFO_SECTIONS, user,
                 starfield=True)


def ui_page(user: Optional[str]) -> str:
    # drag-drop zone ≙ the reference's app.js upload area
    # (static/js/app.js:21-153: drop → POST /api/predict → inline verdict)
    return _page("Analyze", """
<div class="card"><h2>Analyze videos</h2>
<div class="dropzone" id="dz">Drag &amp; drop a video here<br>
<span class="muted">or click to choose — analyzed instantly via the API</span>
<input type="file" id="dzfile" accept="video/*" style="display:none"></div>
<p class="muted"><label><input type="checkbox" id="dzexplain"> show where the
detector looks (saliency heat maps; one extra backward pass)</label></p>
<div id="dzout"></div>
<hr style="border-color:#232d4a">
<form action="/results" method="post" enctype="multipart/form-data">
<p><input type="file" name="videos" accept="video/*" multiple required></p>
<p><button type="submit">Upload &amp; analyze (background job)</button></p>
</form>
<p class="muted">The form path runs as a background job with a progress
page and full 200-word report; the drop zone calls /api/predict
synchronously.</p></div>
<script>
const dz = document.getElementById('dz');
const dzfile = document.getElementById('dzfile');
dz.addEventListener('click', () => dzfile.click());
dz.addEventListener('dragover', e => { e.preventDefault(); dz.classList.add('drag'); });
dz.addEventListener('dragleave', () => dz.classList.remove('drag'));
dz.addEventListener('drop', e => {
  e.preventDefault(); dz.classList.remove('drag');
  if (e.dataTransfer.files.length) analyze(e.dataTransfer.files[0]);
});
dzfile.addEventListener('change', () => {
  if (dzfile.files.length) analyze(dzfile.files[0]);
});
// build result DOM with text nodes only — file names, error strings and
// model output never flow through innerHTML (same rule as the chat panel)
function msgP(cls, text) {
  const p = document.createElement('p');
  if (cls) p.className = cls;
  p.textContent = text;
  return p;
}
// saliency heat-map row: one small canvas per analyzed frame, red = where
// the detector's fake evidence concentrates (result.saliency from
// /api/predict?explain=1)
function heatRow(sal) {
  const wrap = document.createElement('div');
  const cap = msgP('muted', 'Detector attention per frame (red = evidence):');
  wrap.append(cap);
  const [gh, gw] = sal.grid;
  for (const frame of sal.frames) {
    const c = document.createElement('canvas');
    c.width = gw; c.height = gh;
    c.style.width = '72px'; c.style.height = '72px';
    c.style.imageRendering = 'pixelated';
    c.style.margin = '0 4px 4px 0';
    c.style.border = '1px solid #232d4a';
    const ctx = c.getContext('2d');
    const img = ctx.createImageData(gw, gh);
    for (let i = 0; i < gh * gw; i++) {
      const v = Math.max(0, Math.min(1, frame[i] || 0));
      img.data[4 * i] = Math.round(30 + 225 * v);       // R
      img.data[4 * i + 1] = Math.round(34 * (1 - v));   // G
      img.data[4 * i + 2] = Math.round(58 * (1 - v));   // B
      img.data[4 * i + 3] = 255;
    }
    ctx.putImageData(img, 0, 0);
    wrap.append(c);
  }
  return wrap;
}
async function analyze(file) {
  const out = document.getElementById('dzout');
  out.replaceChildren(msgP('muted', 'Analyzing ' + file.name + '…'));
  const fd = new FormData();
  fd.append('video', file);
  const explain = document.getElementById('dzexplain').checked;
  try {
    const r = await fetch('/api/predict' + (explain ? '?explain=1' : ''),
                          {method: 'POST', body: fd});
    const j = await r.json();
    if (j.error) { out.replaceChildren(msgP('verdict-unsure', j.error)); return; }
    const cls = j.prediction === 'Deepfake' ? 'verdict-fake'
              : j.prediction === 'Real' ? 'verdict-real' : 'verdict-unsure';
    const conf = typeof j.confidence === 'number'
               ? (j.confidence * 100).toFixed(1) + '%' : '–';
    const pf = typeof j.prob_fake === 'number'
             ? (j.prob_fake * 100).toFixed(1) + '%' : '–';
    const p = document.createElement('p');
    p.append(file.name + ': ');
    const verdict = document.createElement('span');
    verdict.className = cls; verdict.textContent = j.prediction;
    const meta = document.createElement('span');
    meta.className = 'muted';
    meta.textContent = ' confidence ' + conf + ' · fake prob ' + pf +
      ' · faces ' + (j.num_faces ?? '–');
    p.append(verdict, meta);
    const det = document.createElement('details');
    const sum = document.createElement('summary');
    sum.textContent = 'Details';
    const pre = document.createElement('pre');
    pre.textContent = JSON.stringify(j, null, 2);
    det.append(sum, pre);
    if (j.saliency && j.saliency.frames) out.replaceChildren(p, heatRow(j.saliency), det);
    else out.replaceChildren(p, det);
  } catch (err) { out.replaceChildren(msgP('verdict-unsure', String(err))); }
}
</script>""" + _INFO_SECTIONS, user)


def processing_page(job_id: str, user: Optional[str]) -> str:
    body = f"""
<div class="card"><h2>Analyzing…</h2>
<p id="status">Your videos are being processed.</p></div>
<script>
async function poll() {{
  const r = await fetch('/api/ui-job/{html.escape(job_id)}');
  const j = await r.json();
  if (j.status === 'done') window.location = '/results?job={html.escape(job_id)}';
  else if (j.status === 'error')
    document.getElementById('status').textContent = 'Error: ' + j.error;
  else setTimeout(poll, 1500);
}}
poll();
</script>"""
    return _page("Processing", body, user)


def _verdict_span(result: Dict[str, Any]) -> str:
    v = result.get("prediction", "Uncertain")
    cls = {"Deepfake": "verdict-fake", "Real": "verdict-real"}.get(v, "verdict-unsure")
    return f'<span class="{cls}">{html.escape(str(v))}</span>'


def _windows_strip(w) -> str:
    """Per-window fake-prob bar strip for long-video scans
    (SERVE_WINDOWS > 1, docs/serving.md)."""
    if not isinstance(w, dict) or not w.get("prob_fake"):
        return ""
    probs = w["prob_fake"]
    n = len(probs)
    bw = max(8, min(48, 360 // max(n, 1)))
    bars = []
    for i, p in enumerate(probs):
        h = max(2, int(round(float(p) * 48)))
        color = "#d9534f" if i == w.get("deciding_window") else "#8884"
        bars.append(
            f'<rect x="{i * (bw + 3)}" y="{50 - h}" width="{bw}" '
            f'height="{h}" fill="{color}"><title>window {i}: '
            f'{float(p) * 100:.1f}% fake</title></rect>')
    svg = (f'<svg width="{n * (bw + 3)}" height="52" role="img" '
           f'aria-label="per-window fake probability">{"".join(bars)}'
           "</svg>")
    return (f'<p class="muted">Timeline scan ({n} windows, verdict from '
            f"window {w.get('deciding_window')}):</p>{svg}")


def _frame_strip(result: Dict[str, Any]) -> str:
    """Per-frame temporal-attention strip: which of the sampled frames the
    detector weighted when deciding (``frame_scores`` — the temporal
    attention softmax, serve/predict.py). Explains the verdict at frame
    granularity; the reference exposes nothing equivalent."""
    scores = result.get("frame_scores")
    if not isinstance(scores, list) or not scores:
        return ""
    try:
        vals = [max(0.0, float(s)) for s in scores]
    except (TypeError, ValueError):
        return ""
    top = max(vals) or 1.0
    n = len(vals)
    bw = max(10, min(44, 360 // n))
    bars = []
    for i, v in enumerate(vals):
        h = max(2, int(round(v / top * 40)))
        hot = "#d9534f" if v == top else "#5b76c7"
        bars.append(
            f'<rect x="{i * (bw + 3)}" y="{42 - h}" width="{bw}" '
            f'height="{h}" fill="{hot}" rx="2"><title>frame {i}: attention '
            f'{v * 100:.1f}%</title></rect>')
    svg = (f'<svg width="{n * (bw + 3)}" height="44" role="img" '
           f'aria-label="per-frame attention weights">{"".join(bars)}</svg>')
    return ('<p class="muted">Frame attention (which sampled frames drove '
            f"the verdict):</p>{svg}")


def _confidence_gauge(conf, prediction: str) -> str:
    """SVG donut gauge for the decision confidence (≙ the reference
    result page's visual verdict chrome, ``templates/result.html``)."""
    if not isinstance(conf, float):
        return ""
    pct = max(0.0, min(1.0, conf))
    r, c = 26, 32
    circ = 2 * 3.14159 * r
    color = {"Deepfake": "#d9534f", "Real": "#3c9a5f"}.get(prediction,
                                                           "#d0a537")
    return (
        f'<svg width="64" height="64" viewBox="0 0 64 64" role="img" '
        f'aria-label="confidence {pct * 100:.0f}%" class="gauge">'
        f'<circle cx="{c}" cy="{c}" r="{r}" fill="none" stroke="#8883" '
        f'stroke-width="7"/>'
        f'<circle cx="{c}" cy="{c}" r="{r}" fill="none" stroke="{color}" '
        f'stroke-width="7" stroke-linecap="round" '
        f'stroke-dasharray="{circ * pct:.1f} {circ:.1f}" '
        f'transform="rotate(-90 {c} {c})"/>'
        f'<text x="{c}" y="{c + 5}" text-anchor="middle" font-size="14" '
        f'fill="currentColor">{pct * 100:.0f}%</text></svg>')


def _prob_bar(result: Dict[str, Any]) -> str:
    """Real-vs-fake probability split bar."""
    pf = result.get("prob_fake")
    if not isinstance(pf, float):
        return ""
    pr = 1.0 - pf
    return (
        '<div class="probbar" title="real vs fake probability">'
        f'<span class="pb-real" style="width:{pr * 100:.1f}%">'
        f'real {pr * 100:.0f}%</span>'
        f'<span class="pb-fake" style="width:{pf * 100:.1f}%">'
        f'fake {pf * 100:.0f}%</span></div>')


# typewriter effect for the justification (≙ ui_results.html's typed
# animation, templates/ui_results.html:40-59)
# ONE chat-append helper shared by every chat-bearing script (dashboard +
# per-result chat card — a page can embed both; redeclaration is identical
# and harmless). Inserted by f-string interpolation, so single braces are
# correct here.
_CHAT_LINE_JS = """\
// append as text nodes, never innerHTML: chat content (the user's own
// message AND the server reply, which can echo stored upload filenames)
// must not be parsed as markup
function chatLine(log, cls, prefix, text) {
  const p = document.createElement('p');
  p.className = cls;
  p.textContent = prefix + text;
  log.appendChild(p);
  log.scrollTop = log.scrollHeight;
}"""


_TYPED_JS = """
<script>
document.querySelectorAll('details.typed').forEach(function (d) {
  d.addEventListener('toggle', function () {
    if (!d.open || d.dataset.typed) return;
    d.dataset.typed = '1';
    var pre = d.querySelector('pre'), full = pre.textContent, i = 0;
    pre.textContent = '';
    (function tick() {
      pre.textContent = full.slice(0, i += 3);
      if (i < full.length) setTimeout(tick, 12);
    })();
  });
});
</script>"""


def results_page(items: List[Dict[str, Any]], user: Optional[str]) -> str:
    cards = []
    for item in items:
        result = item.get("result", {})
        fname = html.escape(item.get("filename", "video"))
        if result.get("error"):
            cards.append(f'<div class="card"><h2>{fname}</h2>'
                         f'<p class="verdict-unsure">Error: '
                         f'{html.escape(str(result["error"]))}</p></div>')
            continue
        conf = result.get("confidence")
        conf_s = f"{conf * 100:.1f}%" if isinstance(conf, float) else "–"
        pf = result.get("prob_fake")
        pf_s = f"{pf * 100:.1f}%" if isinstance(pf, float) else "–"
        just = html.escape(item.get("justification", ""))
        msg = html.escape(item.get("message", ""))
        windows_html = _windows_strip(result.get("windows"))
        frames_html = _frame_strip(result)
        gauge = _confidence_gauge(conf, result.get("prediction", ""))
        cards.append(f"""
<div class="card"><h2>{fname}</h2>
<div class="result-head">{gauge}<div>
<p>Verdict: {_verdict_span(result)} &nbsp; <span class="muted">confidence
{conf_s} · fake prob {pf_s} · faces {result.get("num_faces", "–")}</span></p>
{_prob_bar(result)}</div></div>
{windows_html}
{frames_html}
<p>{msg}</p>
<details class="typed"><summary>Full 200-word report</summary><pre id="just">{just}</pre></details>
<details><summary>Raw result</summary>
<pre>{html.escape(json.dumps(result, indent=2, default=str))}</pre></details>
</div>""")
    body = "".join(cards) or ('<div class="card"><p>No results (the job may '
                              'have expired — please upload again).</p></div>')
    body += '<p><a href="/ui"><button>Analyze more</button></a></p>'
    body += _TYPED_JS
    return _page("Results", body, user)


def login_page(user: Optional[str], error: str = "") -> str:
    err = f'<p class="verdict-fake">{html.escape(error)}</p>' if error else ""
    return _page("Login", f"""
<div class="card"><h2>Login</h2>{err}
<form method="post">
<p><input type="email" name="email" placeholder="email" required></p>
<p><input type="password" name="password" placeholder="password" required></p>
<p><button type="submit">Login</button>
<a href="/signup" class="muted">need an account?</a></p>
</form></div>""", user, starfield=True)


def signup_page(user: Optional[str], error: str = "") -> str:
    err = f'<p class="verdict-fake">{html.escape(error)}</p>' if error else ""
    return _page("Sign up", f"""
<div class="card"><h2>Sign up</h2>{err}
<form method="post">
<p><input type="email" name="email" placeholder="email" required></p>
<p><input type="password" name="password" placeholder="password" required></p>
<p><button type="submit">Create account</button></p>
</form></div>""", user, starfield=True)


# Dashboard logic as ONE plain (non-f-string) JS block — single braces are
# literal here. Capability ≙ the reference's static/js/app.js in full:
# tab switching (:3-19), metrics chart (:21-113, Plotly there → dependency-
# free SVG here), confusion-matrix grid (:115-132), metrics table
# (:134-153), model-info panel (:155-187), checkpoint load (:189-226),
# drag-drop upload + progress (:231-276), alert banners
# (templates/dashboard.html:267-268), floating chat launcher + phone
# settings (templates/dashboard.html:312-332).
_DASH_JS = _CHAT_LINE_JS + """
function showAlert(id, msg) {
  const el = document.getElementById(id);
  el.textContent = msg;
  el.style.display = 'block';
  setTimeout(() => { el.style.display = 'none'; }, 6000);
}
const showError = m => showAlert('error-alert', m);
const showSuccess = m => showAlert('success-alert', m);

// ---- tabs ----
document.querySelectorAll('.tab-btn').forEach(btn =>
  btn.addEventListener('click', () => {
    document.querySelectorAll('.tab-content').forEach(t =>
      t.classList.remove('active'));
    document.querySelectorAll('.tab-btn').forEach(b =>
      b.classList.remove('active'));
    document.getElementById(btn.dataset.tab).classList.add('active');
    btn.classList.add('active');
  }));

// ---- training metrics: SVG chart + confusion grid + table ----
const KEYS = [['accuracy', '#7aa2ff'], ['precision', '#b197fc'],
              ['recall', '#51cf66'], ['f1', '#fcc419'], ['auc', '#ff8787']];
function renderChart(es) {
  const svg = document.getElementById('chart');
  const W = 780, H = 240, padL = 44, padR = 16, padT = 24, padB = 32;
  const on = Object.fromEntries(KEYS.map(([k]) => [k, true]));
  const x = i => padL + i * (W - padL - padR) / Math.max(es.length - 1, 1);
  const y = v => H - padB - v * (H - padT - padB);
  function render() {
    let out = '';
    for (const v of [0, 0.25, 0.5, 0.75, 1]) {
      out += `<line x1="${padL}" y1="${y(v)}" x2="${W - padR}"
              y2="${y(v)}" stroke="#232d4a"/>` +
             `<text x="${padL - 6}" y="${y(v) + 4}" fill="#8b93a7"
              font-size="11" text-anchor="end">${v}</text>`;
    }
    const step = Math.max(1, Math.ceil(es.length / 12));
    es.forEach((e, i) => {
      if (i % step) return;
      out += `<text x="${x(i)}" y="${H - padB + 16}" fill="#8b93a7"
              font-size="11" text-anchor="middle">${e.epoch ?? i}</text>`;
    });
    for (const [k, color] of KEYS) {
      if (!on[k]) continue;
      const pts = es.map((e, i) => `${x(i)},${y(e[k] || 0)}`).join(' ');
      out += `<polyline fill="none" stroke="${color}" stroke-width="2"
              points="${pts}"/>`;
      out += es.map((e, i) =>
        `<circle cx="${x(i)}" cy="${y(e[k] || 0)}" r="3.5"
         fill="${color}"><title>epoch ${e.epoch ?? i} ${k} =
         ${(e[k] || 0).toFixed(3)}</title></circle>`).join('');
    }
    out += KEYS.map(([k, c], j) =>
      `<text class="legend-item${on[k] ? '' : ' off'}" data-k="${k}"
       x="${padL + j * 96}" y="14" fill="${c}"
       font-size="12">&#9632; ${k}</text>`).join('');
    // hover crosshair + readout (the Plotly affordance the reference's
    // chart has; <title> tooltips alone are laggy and invisible on touch)
    out += `<g id="xhair" style="display:none;pointer-events:none">
      <line id="xhair-line" y1="${padT}" y2="${H - padB}"
            stroke="#46507a" stroke-dasharray="3,3"/>
      <rect id="xhair-box" width="132" height="${16 * KEYS.length + 22}"
            rx="6" fill="#10162b" stroke="#232d4a"/>
      <text id="xhair-text" font-size="11" fill="#cdd3e1"></text></g>
      <rect x="${padL}" y="${padT}" width="${W - padL - padR}"
            height="${H - padT - padB}" fill="transparent" id="xhair-pad"/>`;
    svg.innerHTML = out;
    svg.querySelectorAll('.legend-item').forEach(el =>
      el.addEventListener('click', () => {
        on[el.dataset.k] = !on[el.dataset.k]; render();
      }));
    const g = svg.querySelector('#xhair');
    const pad = svg.querySelector('#xhair-pad');
    pad.addEventListener('mouseleave', () => { g.style.display = 'none'; });
    pad.addEventListener('mousemove', ev => {
      const r = svg.getBoundingClientRect();
      const mx = (ev.clientX - r.left) * W / r.width;
      const i = Math.max(0, Math.min(es.length - 1, Math.round(
        (mx - padL) * Math.max(es.length - 1, 1) / (W - padL - padR))));
      const e = es[i];
      g.style.display = '';
      g.querySelector('#xhair-line').setAttribute('x1', x(i));
      g.querySelector('#xhair-line').setAttribute('x2', x(i));
      const bx = x(i) + 140 > W - padR ? x(i) - 142 : x(i) + 10;
      const box = g.querySelector('#xhair-box');
      box.setAttribute('x', bx); box.setAttribute('y', padT);
      const t = g.querySelector('#xhair-text');
      t.innerHTML = `<tspan x="${bx + 8}" y="${padT + 16}"
        font-weight="bold">epoch ${e.epoch ?? i}</tspan>` +
        KEYS.filter(([k]) => on[k]).map(([k, c], j) =>
          `<tspan x="${bx + 8}" y="${padT + 32 + j * 16}" fill="${c}">` +
          `${k}: ${(e[k] ?? 0).toFixed(3)}</tspan>`).join('');
    });
  }
  render();
}
function renderConfusion(es) {
  const grid = document.getElementById('confusion-grid');
  grid.textContent = '';
  for (const e of es) {
    const cm = e.confusion_matrix;
    if (!cm) continue;
    const div = document.createElement('div');
    div.className = 'cm';
    div.innerHTML = `<div class="cm-head">Epoch ${e.epoch}</div><table>
<tr><th class="cm-head"></th><th class="cm-head">Pred Real</th>
<th class="cm-head">Pred Fake</th></tr>
<tr><th class="cm-head">Actual Real</th><td>${cm[0][0]}</td><td>${cm[0][1]}</td></tr>
<tr><th class="cm-head">Actual Fake</th><td>${cm[1][0]}</td><td>${cm[1][1]}</td></tr>
</table>`;
    grid.appendChild(div);
  }
}
function renderTable(es) {
  const tbody = document.getElementById('metrics-tbody');
  tbody.textContent = '';
  for (const e of es) {
    const row = tbody.insertRow();
    const pct = v => (typeof v === 'number' && isFinite(v))
                   ? (v * 100).toFixed(2) + '%' : 'N/A';
    row.innerHTML = `<td>${e.epoch}</td><td>${pct(e.accuracy)}</td>
<td>${pct(e.precision)}</td><td>${pct(e.recall)}</td><td>${pct(e.f1)}</td>
<td>${pct(e.auc)}</td><td>${e.total_samples ?? '-'}</td>`;
  }
}
fetch('/api/metrics').then(r => r.json()).then(d => {
  const es = d.epochs || [];
  if (!es.length) {
    document.getElementById('chart-note').textContent =
      'No training metrics on this server yet.';
    return;
  }
  renderChart(es);
  renderConfusion(es);
  renderTable(es);
});

// ---- model panel ----
function infoLine(container, label, value) {
  const div = document.createElement('div');
  div.className = 'info-item';
  const span = document.createElement('span');
  span.className = 'label';
  span.textContent = label;
  div.appendChild(span);
  div.appendChild(document.createTextNode(String(value)));
  container.appendChild(div);
}
function loadModelInfo() {
  fetch('/api/model-info').then(r => r.json()).then(info => {
    const c = document.getElementById('model-info');
    c.textContent = '';
    infoLine(c, 'Status:', info.loaded ? 'model loaded' : 'no model loaded');
    if (info.loaded) {
      infoLine(c, 'Model type:', info.model_type || '?');
      if (info.checkpoint) infoLine(c, 'Checkpoint:', info.checkpoint);
      const s = info.load_stats || {};
      if (typeof s.match_ratio === 'number')
        infoLine(c, 'Key match:', s.match_ratio.toFixed(3));
    }
    infoLine(c, 'Device:', info.device || 'unknown');
    const mb = info.microbatch;
    if (mb && mb.batches_run)
      infoLine(c, 'Micro-batching:', mb.items_run + ' items in ' +
        mb.batches_run + ' batches (mean ' + mb.mean_batch + ')');
  }).catch(() => {});
}
function loadCheckpoints() {
  fetch('/api/checkpoints').then(r => r.json()).then(d => {
    const sel = document.getElementById('ckpt-select');
    sel.textContent = '';
    const blank = document.createElement('option');
    blank.value = '';
    blank.textContent = (d.checkpoints || []).length
      ? '— pick a checkpoint —' : 'no checkpoints found';
    sel.appendChild(blank);
    for (const p of d.checkpoints || []) {
      const o = document.createElement('option');
      o.value = p;
      o.textContent = p + (p === d.current ? '  (current)' : '');
      sel.appendChild(o);
    }
  }).catch(() => {});
}
async function loadModel() {
  const path = document.getElementById('ckpt-select').value ||
               document.getElementById('ckpt').value;
  const el = document.getElementById('mstatus');
  if (!path) { showError('Pick or type a checkpoint path first'); return; }
  const model_type = document.getElementById('mtype').value || null;
  el.textContent = 'loading…';
  try {
    const r = await fetch('/api/load-model', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({path, model_type})});
    const j = await r.json();
    if (j.ok) {
      el.textContent = 'loaded ' + j.stats.model_type +
        ' (match ' + j.stats.match_ratio.toFixed(2) + ')';
      showSuccess('Model loaded');
      loadModelInfo(); loadCheckpoints();
    } else {
      el.textContent = '';
      showError(j.error || 'load failed');
    }
  } catch (err) { el.textContent = ''; showError(String(err)); }
}
loadModelInfo();
loadCheckpoints();

// ---- upload: drag-drop + progress ----
const ddz = document.getElementById('ddz');
const vid = document.getElementById('vid');
ddz.addEventListener('click', () => vid.click());
ddz.addEventListener('dragover', e => {
  e.preventDefault(); ddz.classList.add('drag'); });
ddz.addEventListener('dragleave', () => ddz.classList.remove('drag'));
ddz.addEventListener('drop', e => {
  e.preventDefault(); ddz.classList.remove('drag');
  if (e.dataTransfer.files.length) apiUpload(e.dataTransfer.files[0]);
});
vid.addEventListener('change', () => {
  if (vid.files.length) apiUpload(vid.files[0]);
});
async function apiUpload(file) {
  const el = document.getElementById('upstatus');
  const track = document.getElementById('progress-track');
  const fill = document.getElementById('progress-fill');
  el.textContent = 'analyzing ' + file.name + '…';
  track.style.display = 'block';
  fill.style.width = '15%';
  const tick = setInterval(() => {
    const w = parseFloat(fill.style.width) || 0;
    if (w < 90) fill.style.width = (w + 5) + '%';
  }, 800);
  try {
    const fd = new FormData();
    fd.append('video', file);
    const r = await fetch('/api/upload', {method: 'POST', body: fd});
    const j = await r.json();
    fill.style.width = '100%';
    if (j.uploads) {
      el.textContent = j.uploads[0].filename + ' → ' +
        j.uploads[0].verdict;
      showSuccess('Analyzed ' + j.uploads[0].filename);
      setTimeout(() => window.location.reload(), 1200);
    } else {
      el.textContent = '';
      showError(j.error || 'upload failed');
    }
  } catch (err) { el.textContent = ''; showError(String(err));
  } finally { clearInterval(tick);
    setTimeout(() => { track.style.display = 'none';
                       fill.style.width = '0'; }, 1200); }
}

// ---- floating chat launcher + phone settings ----
document.getElementById('chat-launcher').addEventListener('click', () =>
  document.getElementById('chat-panel').classList.toggle('open'));
document.getElementById('chat-close').addEventListener('click', () =>
  document.getElementById('chat-panel').classList.remove('open'));
document.getElementById('chat-settings').addEventListener('click', () => {
  const p = document.getElementById('chat-settings-panel');
  p.style.display = p.style.display === 'none' ? 'block' : 'none';
});
fetch('/api/agent-config').then(r => r.json()).then(d => {
  if (d.configured) document.getElementById('phstatus').textContent =
    'Configured (' + (d.redacted_phone || '***') + ')';
}).catch(() => {});
async function savePhone() {
  const phone = document.getElementById('phone').value.trim();
  const el = document.getElementById('phstatus');
  const r = await fetch('/api/agent-config', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({notification_phone: phone})});
  const j = await r.json();
  el.textContent = j.success ? 'Configured (***' + phone.slice(-4) + ')'
                             : (j.error || 'failed');
}
document.getElementById('save-phone').addEventListener('click', savePhone);
async function send() {
  const m = document.getElementById('msg').value;
  if (!m) return;
  const log = document.getElementById('log');
  chatLine(log, 'chat-msg-user', 'You: ', m);
  document.getElementById('msg').value = '';
  const r = await fetch('/api/chat', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({message: m})});
  const j = await r.json();
  chatLine(log, 'chat-msg-bot', 'Bot: ', j.reply || j.error || '');
}
document.getElementById('chat-send').addEventListener('click', send);
document.getElementById('msg').addEventListener('keydown',
  e => { if (e.key === 'Enter') send(); });
"""


def dashboard_page(user: Optional[str], uploads: List[Dict[str, Any]]) -> str:
    rows = "".join(
        f"<tr><td><a href='/result/{html.escape(str(u.get('id', '')))}'>"
        f"{html.escape(str(u.get('filename', '?')))}</a></td>"
        f"<td>{html.escape(str(u.get('verdict', '?')))}</td>"
        f"<td class='muted'>{html.escape(str(u.get('ts', '')))}</td></tr>"
        for u in reversed(uploads[-50:]))
    table = (f"<table><tr><th>File</th><th>Verdict</th><th>When</th></tr>"
             f"{rows}</table>" if rows else
             '<p class="muted">No uploads yet.</p>')
    body = f"""
<div class="alert alert-error" id="error-alert"></div>
<div class="alert alert-success" id="success-alert"></div>
<div class="tabbar">
<button class="tab-btn active" data-tab="tab-upload">Upload</button>
<button class="tab-btn" data-tab="tab-training">Training metrics</button>
<button class="tab-btn" data-tab="tab-model">Model</button>
</div>

<div id="tab-upload" class="tab-content active">
<div class="card"><h2>Analyze a video</h2>
<div class="dropzone" id="ddz">Drag &amp; drop a video here<br>
<span class="muted">or click to choose</span>
<input type="file" id="vid" accept="video/*" style="display:none"></div>
<div class="progress-track" id="progress-track" style="display:none">
<div class="progress-fill" id="progress-fill"></div></div>
<p class="muted" id="upstatus"></p></div>
<div class="card"><h2>Upload history</h2>{table}</div>
</div>

<div id="tab-training" class="tab-content">
<div class="card"><h2>Training metrics</h2>
<svg id="chart" width="780" height="240" viewBox="0 0 780 240"></svg>
<p class="muted" id="chart-note">Per-epoch accuracy/precision/recall/F1/AUC
recomputed from preds_epoch_*.csv (via /api/metrics). Click a legend entry
to toggle a series; hover points for values.</p></div>
<div class="card"><h2>Confusion matrices</h2>
<div class="cm-grid" id="confusion-grid"><span class="muted">No training
data yet.</span></div></div>
<div class="card"><h2>Per-epoch metrics</h2>
<table><thead><tr><th>Epoch</th><th>Accuracy</th><th>Precision</th>
<th>Recall</th><th>F1</th><th>AUC</th><th>Samples</th></tr></thead>
<tbody id="metrics-tbody"></tbody></table></div>
</div>

<div id="tab-model" class="tab-content">
<div class="card"><h2>Model info</h2>
<div id="model-info" class="muted">loading&hellip;</div></div>
<div class="card"><h2>Load a checkpoint</h2>
<p><select id="ckpt-select"><option value="">loading&hellip;</option></select></p>
<p><input type="text" id="ckpt"
 placeholder="or type a checkpoint path on the server"></p>
<p><select id="mtype">
<option value="">auto-detect architecture</option>
<option value="efficientnet_b0">efficientnet_b0</option>
<option value="resnet18">resnet18</option>
<option value="resnet34">resnet34</option>
<option value="resnet50">resnet50</option>
<option value="vit_gcn">vit_gcn</option>
</select>
<button onclick="loadModel()">Load model</button>
<span class="muted" id="mstatus"></span></p></div>
</div>

<button id="chat-launcher" class="chat-launcher">&#128172; Chat</button>
<div id="chat-panel" class="chat-panel">
<div class="chat-head"><span class="title">Assistant</span>
<button id="chat-settings" title="Settings">&#9881;</button>
<button id="chat-close" title="Close">&times;</button></div>
<div class="chat-body"><div class="chat-log" id="log"></div></div>
<div id="chat-settings-panel" style="display:none"
 class="chat-body">
<p class="muted">CRITICAL deepfake alerts go to this phone
(&#8793; the reference's agent settings panel).</p>
<p><input type="text" id="phone" placeholder="+15551234567">
<button id="save-phone">Save</button>
<span class="muted" id="phstatus"></span></p></div>
<div class="chat-foot">
<input type="text" id="msg" placeholder="Ask about your results&hellip;">
<button id="chat-send">Send</button></div>
</div>
<script>
{_DASH_JS}
</script>"""
    return _page("Dashboard", body, user)


def _chat_card(endpoint: str) -> str:
    """Chat box wired to the chat API (≙ the reference's per-result chat,
    ``templates/result.html``)."""
    return f"""
<div class="card"><h2>Ask about this result</h2>
<div class="chat-log" id="rlog"></div>
<p><input type="text" id="rmsg" placeholder="e.g. why was this flagged?">
<button onclick="rsend()">Send</button></p></div>
<script>
{_CHAT_LINE_JS}
async function rsend() {{
  const m = document.getElementById('rmsg').value;
  if (!m) return;
  const log = document.getElementById('rlog');
  chatLine(log, 'chat-msg-user', 'You: ', m);
  document.getElementById('rmsg').value = '';
  const r = await fetch('{endpoint}', {{method: 'POST',
    headers: {{'Content-Type': 'application/json'}},
    body: JSON.stringify({{message: m}})}});
  const j = await r.json();
  chatLine(log, 'chat-msg-bot', 'Bot: ', j.reply || j.error || '');
}}
document.getElementById('rmsg').addEventListener('keydown',
  e => {{ if (e.key === 'Enter') rsend(); }});
</script>"""


def result_page(user: Optional[str], record: Dict[str, Any]) -> str:
    result = record.get("result", {})
    page = results_page([{"filename": record.get("filename", "video"),
                          "result": result,
                          "message": record.get("message", ""),
                          "justification": record.get("justification", "")}],
                        user)
    chat = _chat_card("/api/chat" if user else "/api/chat-public")
    return page.replace("</main>", chat + "</main>")

"""The port's MTCNN cascade (``models/mtcnn.py``) and the mtcnn branches of
``FaceExtractor`` against the JAX package's, on the CPU.

Both packages load the same facenet-layout weights,
``tests/mtcnn_torch_ref.py::make_nets(seed=7)``. The nets agree within
1e-5 and each pyramid level within 1e-4. The cascade fixtures follow
``tests/test_mtcnn_golden.py``: smooth blobs, P-Net's threshold at the
98th percentile of its scores, R-Net's and O-Net's at 0, so that no score
sits on a threshold; the valid boxes must then agree within 1e-3 px and
their scores within 1e-4, in the JAX package's order.

The extractor runs at its default thresholds on weights whose face-class
biases are raised (``_biased``): every P-Net cell, R-Net and O-Net crop
passes, well clear of the thresholds, as ``chip_smoke.py`` does on the
card. Its crops are resized by f32 products that the two packages sum in
other orders, so a byte may differ by 1; the share of such bytes is
bounded too (``test_torch_port_video.py``): 0.01 % of the bytes on the
blob frames, 12 % on the flat synthetic face that the haar chain crops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfake_video_detection_tpu.data import faces as jax_faces
from deepfake_video_detection_tpu.models import mtcnn as jax_mtcnn
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.data import faces
from deepfake_video_detection_tpu_torch.models import mtcnn

from mtcnn_torch_ref import make_nets, pnet_scores
from test_haar import scene_with_face

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
# face-class bias shifts of P-, R- and O-Net: random nets score ~0.55, ~0.5
# and ~0.49; these lift every candidate to ~0.9, ~0.85, ~0.84, past the
# default thresholds (0.6, 0.7, 0.7) with no score near one
FACE_BIAS = (2.0, 1.7, 1.7)


@pytest.fixture(scope="module")
def weights():
    nets, sd = make_nets(seed=7)
    return nets, sd, jax_mtcnn.import_facenet_weights(sd)


@pytest.fixture
def env(monkeypatch):
    for k in ("FACE_DETECTOR", "MTCNN_WEIGHTS", "KEEP_ALL_FACES", "HAAR_CASCADE",
              "HAAR_TRACK", "VIDEO_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _blobs(seed: int, H: int = 96, W: int = 96) -> np.ndarray:
    """``test_mtcnn_golden``'s fixture: two smooth coloured blobs and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.zeros((H, W, 3), np.float32)
    for cx, cy, s in [(30, 30, 12), (68, 60, 16)]:
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2))
        img += blob[..., None] * rng.uniform(80, 255, 3)
    return np.clip(img + rng.uniform(0, 40, img.shape), 0, 255).astype(np.uint8)


def _port(sd, image_size, **kw) -> mtcnn.MTCNN:
    det = mtcnn.MTCNN(image_size, device="cpu", **kw)
    det.load_state_dict(mtcnn.import_facenet_weights(sd), strict=True)
    return det


def _biased(sd, shifts=FACE_BIAS):
    out = {k: v.copy() for k, v in sd.items()}
    for key, d in zip(("pnet.conv4_1.bias", "rnet.dense5_1.bias", "onet.dense6_1.bias"),
                      shifts):
        out[key][1] += d
    return out


def _save_pt(sd, path) -> str:
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


def _level_gap(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


# ---------------------------------------------------------------------------
# the nets, the weights, NMS and the pyramid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net,shape", [("pnet", (2, 36, 30, 3)), ("rnet", (4, 24, 24, 3)),
                                       ("onet", (4, 48, 48, 3))])
def test_nets_match_jax(weights, net, shape):
    _, sd, params = weights
    x = np.random.default_rng(len(net) + shape[1]).uniform(-1, 1, shape).astype(np.float32)
    det = jax_mtcnn.MTCNN(image_size=shape[1:3])
    ref = getattr(det, net).apply(params[net], jnp.asarray(x))
    port = _port(sd, shape[1:3])
    with torch.no_grad():
        got = getattr(port, net)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy()
        if g.ndim == 4:                       # P-Net's maps: NCHW → NHWC
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5)


def test_weights_carry_across_from_facenet_and_from_jax(weights):
    nets, sd, params = weights
    port = mtcnn.MTCNN((48, 48), device="cpu")
    port.load_state_dict(mtcnn.import_facenet_weights(sd), strict=True)
    for k, t in port.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[k])
    # the JAX params (HWIO convs) through the bridge give the same state dict
    from_jax = state_dict_from_jax(params)
    assert set(from_jax) == set(sd)
    for k, t in from_jax.items():
        np.testing.assert_array_equal(t.numpy(), sd[k])
    port.load_state_dict(from_jax, strict=True)
    # and the facenet-layout nets themselves give the port's outputs
    x = np.random.default_rng(4).uniform(-1, 1, (3, 3, 48, 48)).astype(np.float32)
    with torch.no_grad():
        for got, ref in zip(port.onet(torch.from_numpy(x)), nets["onet"](torch.from_numpy(x))):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    # keys of other modules in a facenet file are left out
    assert set(mtcnn.import_facenet_weights({**sd, "extra.weight": np.ones(2)})) == set(sd)


def _nms_fixture(F: int, K: int, seed: int):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (F, K, 2))
    wh = rng.uniform(4, 30, (F, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                               # a duplicate box
    scores = np.round(rng.uniform(0, 1, (F, K)), 1).astype(np.float32)   # ties
    valid = rng.uniform(0, 1, (F, K)) > 0.25
    valid[0] = False                                        # a frame with nothing
    return boxes, scores, valid


@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_masked_nms_batched_and_single_equal_jax(thr):
    boxes, scores, valid = _nms_fixture(6, 32, seed=int(thr * 10))
    ref = np.asarray(jax.vmap(lambda b, s, v: jax_mtcnn.masked_nms(b, s, v, thr))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
    got = mtcnn.masked_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref[1:].any() and not ref[0].any()
    single = mtcnn.masked_nms(torch.from_numpy(boxes[3]), torch.from_numpy(scores[3]),
                              torch.from_numpy(valid[3]), thr).numpy()
    np.testing.assert_array_equal(single, ref[3])


@pytest.mark.parametrize("H,W", [(96, 96), (72, 120)])
def test_pyramid_levels_match_jax_resize(H, W):
    img = (_blobs(1, H, W).astype(np.float32) - 127.5) / 128.0
    det = mtcnn.MTCNN((H, W), device="cpu")
    assert det.scales == jax_mtcnn.MTCNN((H, W)).scales and len(det.scales) >= 3
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    for scale in det.scales:
        sh, sw = max(12, int(H * scale)), max(12, int(W * scale))
        ref = np.asarray(jax.image.resize(jnp.asarray(img), (sh, sw, 3), "linear"))
        got = det.pyramid_level(x, scale)[0].permute(1, 2, 0).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-4)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------


def _check_valid_equal(got, ref):
    """Valid slots equal, and their boxes and scores close, slot by slot."""
    gb, gs, gv = (t.numpy() for t in got)
    rb, rs, rv = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(gv, rv)
    assert rv.any()
    np.testing.assert_allclose(gb[gv], rb[rv], atol=BOX_ATOL)
    np.testing.assert_allclose(gs[gv], rs[rv], atol=SCORE_ATOL)
    np.testing.assert_array_equal(gs[~gv], 0.0)


def test_cascade_matches_jax_on_the_golden_blobs(weights):
    nets, sd, params = weights
    img = _blobs(3)
    thr = (float(np.quantile(pnet_scores(img, nets), 0.98)), 0.0, 0.0)
    ref_det = jax_mtcnn.MTCNN(image_size=(96, 96), thresholds=thr)
    ref = jax.jit(lambda im: ref_det.detect(params, im))(jnp.asarray(img))
    got = _port(sd, (96, 96), thresholds=thr).detect(img[None])
    _check_valid_equal([t[0] for t in got], ref)


def test_cascade_batch_of_frames_matches_jax_vmap(weights):
    """Four frames through one batched cascade, against ``jax.vmap``."""
    nets, sd, params = weights
    frames = np.stack([_blobs(s, 64, 80) for s in range(4)])
    thr0 = float(np.quantile(np.concatenate([pnet_scores(f, nets) for f in frames]), 0.98))
    thr = (thr0, 0.0, 0.0)
    ref_det = jax_mtcnn.MTCNN(image_size=(64, 80), thresholds=thr, max_refined=32,
                              max_faces=8)
    ref = jax.jit(jax.vmap(lambda im: ref_det.detect(params, im)))(jnp.asarray(frames))
    port = _port(sd, (64, 80), thresholds=thr, max_refined=32, max_faces=8)
    got = port.detect(torch.from_numpy(frames))
    assert got[0].shape == (4, 8, 4) and got[2].dtype == torch.bool
    _check_valid_equal(got, ref)


# ---------------------------------------------------------------------------
# FaceExtractor's mtcnn branches
# ---------------------------------------------------------------------------


def test_extractor_mtcnn_crops_within_one_level_of_jax(weights, env, tmp_path):
    _, sd, _ = weights
    path = _save_pt(_biased(sd), tmp_path / "mtcnn.pt")
    frames = np.stack([_blobs(s) for s in range(3)])
    ref_ex = jax_faces.FaceExtractor(detector="mtcnn", face_size=32, mtcnn_weights=path)
    ex = faces.FaceExtractor(detector="mtcnn", face_size=32, mtcnn_weights=path,
                             device="cpu")
    assert ex.detector == ref_ex.detector == "mtcnn"
    # the detections themselves: one box a frame, the largest valid one
    got_boxes, ref_boxes = ex._detect_mtcnn(frames), ref_ex._detect_mtcnn(frames)
    assert all(b is not None and b.shape == (1, 4) for b in got_boxes)
    np.testing.assert_allclose(np.concatenate(got_boxes), np.concatenate(ref_boxes),
                               atol=BOX_ATOL)
    got, ref = ex.extract_from_frames(frames), ref_ex.extract_from_frames(frames)
    assert got.shape == (3, 32, 32, 3)
    gap, share = _level_gap(got, ref)
    assert gap <= 1 and share < 0.01, (gap, share)
    # keep_all: every valid box of every frame
    env.setenv("KEEP_ALL_FACES", "1")
    ex_all = faces.FaceExtractor(detector="mtcnn", face_size=32, mtcnn_weights=path,
                                 device="cpu")
    every = ex_all._detect_mtcnn(frames)
    assert sum(len(b) for b in every) > 3
    assert ex_all.extract_from_frames(frames).shape[0] == sum(len(b) for b in every)


def test_extractor_batch_on_a_ragged_batch_equals_the_per_clip_path(weights, env, tmp_path):
    """One cascade over the frames of clips of 3, 5, 0 and 2 frames gives
    the per-clip crops byte for byte: the port compiles nothing per shape,
    so a ragged batch costs no recompile (JAX ``data/faces.py:282``
    compiles the cascade once per distinct total frame count)."""
    _, sd, _ = weights
    path = _save_pt(_biased(sd), tmp_path / "mtcnn.pt")
    ex = faces.FaceExtractor(detector="mtcnn", face_size=32, mtcnn_weights=path,
                             device="cpu")
    frames = np.stack([_blobs(s) for s in range(10)])
    clips = [frames[:3], frames[3:8], np.zeros((0, 96, 96, 3), np.uint8), frames[8:]]
    batched = ex.extract_from_frames_batch(clips)
    assert [b.shape[0] for b in batched] == [3, 5, 0, 2]
    for got, clip in zip(batched, clips):
        np.testing.assert_array_equal(got, ex.extract_from_frames(clip))
    assert len(ex._mtcnn_cache) == 1
    # clips of two frame sizes go clip by clip
    mixed = ex.extract_from_frames_batch([frames[:2], np.stack([_blobs(0, 64, 80)])])
    np.testing.assert_array_equal(mixed[0], ex.extract_from_frames(frames[:2]))
    assert mixed[1].shape == (1, 32, 32, 3)


def test_extractor_mtcnn_finding_nothing_chains_to_haar(weights, env, tmp_path):
    """P-Net's face bias lowered until no cell passes: the clip goes through
    haar (which finds the synthetic face), as in the JAX package, and the
    crops agree within 1 level."""
    from test_haar import _require_cascade

    _require_cascade()
    _, sd, _ = weights
    path = _save_pt(_biased(sd, (-20.0, 0.0, 0.0)), tmp_path / "blind.pt")
    img = scene_with_face(H=160, W=200, oy=20, ox=70, s=110)
    frames = np.repeat(np.stack([img] * 2)[..., None], 3, -1).astype(np.uint8)
    ex = faces.FaceExtractor(detector="mtcnn", face_size=32, mtcnn_weights=path,
                             device="cpu")
    assert ex._detect_mtcnn(frames) == [None, None]
    got = ex.extract_from_frames(frames)
    haar = faces.FaceExtractor(detector="haar", face_size=32, device="cpu")
    np.testing.assert_array_equal(got, haar.extract_from_frames(frames))
    center = faces.FaceExtractor(detector="center", face_size=32, device="cpu")
    assert not np.array_equal(got, center.extract_from_frames(frames))
    ref = jax_faces.FaceExtractor(detector="mtcnn", face_size=32,
                                  mtcnn_weights=path).extract_from_frames(frames)
    gap, share = _level_gap(got, ref)
    assert gap <= 1 and share < 0.2, (gap, share)


def test_auto_resolves_to_mtcnn_from_a_weights_file(weights, env, tmp_path):
    _, sd, _ = weights
    path = _save_pt(sd, tmp_path / "mtcnn_weights.pt")
    env.setenv("MTCNN_WEIGHTS", path)
    ex = faces.FaceExtractor(face_size=32, device="cpu")
    assert ex.detector == jax_faces.FaceExtractor(face_size=32).detector == "mtcnn"
    out = ex.extract_from_frames(np.stack([_blobs(0, 64, 64)] * 2))
    assert out.shape[1:] == (32, 32, 3) and out.shape[0] >= 1
    # the cascade holds the file's weights, not a random init
    det = ex._mtcnn_cache[(64, 64)]
    np.testing.assert_array_equal(det.pnet.conv1.weight.detach().numpy(),
                                  sd["pnet.conv1.weight"])
    # without a file the cascade is drawn from a generator seeded 0
    env.delenv("MTCNN_WEIGHTS")
    blind = faces.FaceExtractor(detector="mtcnn", face_size=32, device="cpu")
    assert blind.detector != "mtcnn"
    blind.detector = "mtcnn"
    assert blind.extract_from_frames(np.stack([_blobs(0, 64, 64)])).shape == (1, 32, 32, 3)
    seeded = mtcnn.MTCNN((64, 64), device="cpu")
    for k, t in blind._mtcnn_cache[(64, 64)].state_dict().items():
        assert torch.equal(t, seeded.state_dict()[k]), k

"""The port's video decoding, Haar detection, face extraction and
``Predictor.predict_video`` against the JAX package's, on the CPU.

Clips are written by the JAX package's ``encode_video`` (mpeg4), with the
moving synthetic face of ``test_haar.synth_face``. Both packages load the
same committed ``native/build/libvideodec.so`` and ``libhaar.so``, so the
decoder's frames, the in-decoder crops (RGB and packed YUV420), the Haar
boxes and the found codes must be equal byte for byte. The RGB crops are
resized by ``crop_and_resize_batch``: f32 products that the two packages
sum in different orders before truncating to uint8, so a byte may differ by
1. On the synthetic clips' flat regions an exact 120.0 lands at 119.99999
in one package and at 120.00001 in the other, so 9-32 % of the bytes
differ by 1 (12.5 % with the Haar boxes, 27-32 % resizing whole frames); on
random frames 0.02-0.25 %. A shift of the whole resize by one level would
move every flat byte, so the tests bound the share as well as the gap.

``predict_video`` serves an EfficientNet-B0 detector at 32 px (JAX tree
filled by ``random_variables``, ``SERVE_WARMUP=0``, ``MIN_FACES=1``,
``DETECT_ABSTAIN_CONF=0``) through one JAX and one port ``Predictor``, whose
extractors are swapped between requests, so the JAX side compiles each
forward shape once. Results key for key, ``prob_fake`` within 5e-4.
"""

import os
import threading

import numpy as np
import pytest

import jax
import torch

from deepfake_video_detection_tpu.data import faces as jax_faces
from deepfake_video_detection_tpu.data import haar as jax_haar
from deepfake_video_detection_tpu.data import haar_native as jax_haar_native
from deepfake_video_detection_tpu.data import video as jax_video
from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.data import _native
from deepfake_video_detection_tpu_torch.data import faces
from deepfake_video_detection_tpu_torch.data import haar
from deepfake_video_detection_tpu_torch.data import haar_native
from deepfake_video_detection_tpu_torch.data import video
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.serve import predict as port_predict

from test_haar import scene_with_face, synth_face
from test_torch_port_convnets import random_variables

SIZE, T = 32, 4
PROB_ATOL = 5e-4
VIDEO_FNS = ("vd_probe", "vd_sample", "vd_sample_crop", "vd_sample_seek_crop",
             "vd_sample_seek_crop_yuv", "vd_sample_seek_center",
             "vd_sample_seek_center_yuv", "vd_sample_seek_faces_yuv", "vd_encode")


def _face_frames(n=36, H=240, W=320, s=110, face_frames=None):
    """The JAX suite's moving synthetic face (``test_video_faces._face_clip``)."""
    face = synth_face(s)
    frames = np.full((n, H, W), 120.0, np.float32)
    for t in range(n):
        if face_frames is None or t in face_frames:
            oy, ox = 30 + (t % 8), 60 + t
            frames[t, oy:oy + s, ox:ox + s] = face
    return np.repeat(frames[..., None], 3, -1).astype(np.uint8)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    out = {"face": _face_frames(),
           "partial": _face_frames(face_frames=set(range(18))),
           "noface": np.full((24, 240, 320, 3), 120, np.uint8)}
    paths = {}
    for name, rgb in out.items():
        paths[name] = str(d / f"{name}.avi")
        jax_video.encode_video(paths[name], rgb, fps=12)
    return paths


@pytest.fixture
def env(monkeypatch):
    for k in ("VIDEO_BACKEND", "VIDEO_SAMPLE_RATE", "VIDEO_KEYFRAMES_ONLY", "FACE_DETECTOR",
              "MTCNN_WEIGHTS", "HAAR_CASCADE", "HAAR_TRACK", "HAAR_MAX_SIDE", "KEEP_ALL_FACES",
              "SERVE_WINDOWS", "SERVE_YUV_TRANSFER", "SERVE_EXPLAIN", "FAKE_CLASS_INDEX",
              "DETECT_FAKE_THRESHOLD", "DETECT_ABSTAIN_MARGIN"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _level_gap(a, b):
    """(max |a − b| in levels, share of differing bytes)."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()) if d.size else 0, float((d > 0).mean()) if d.size else 0.0


# ---------------------------------------------------------------------------
# the decoder's bindings and its routes
# ---------------------------------------------------------------------------


def test_bindings_match_jax_and_load_the_committed_libraries(clips):
    jax_video.probe_video(clips["face"])                  # load both libraries
    jax_haar_native._get_lib()
    ours, ref = video._get_lib(), jax_video._get_lib()
    for fn in VIDEO_FNS:
        assert getattr(ours, fn).argtypes == getattr(ref, fn).argtypes, fn
        assert getattr(ours, fn).restype == getattr(ref, fn).restype, fn
    ours, ref = haar_native._get_lib(), jax_haar_native._get_lib()
    for fn in ("haar_scan", "haar_prepare"):
        assert getattr(ours, fn).argtypes == getattr(ref, fn).argtypes, fn
        assert getattr(ours, fn).restype == getattr(ref, fn).restype, fn
    assert haar_native.engine() == "native"
    committed = os.path.join(_native.NATIVE_DIR, "build")
    assert _native.library_path("libvideodec.so", ()) == os.path.join(committed,
                                                                      "libvideodec.so")
    assert _native.library_path("libhaar.so", ()) == os.path.join(committed, "libhaar.so")


def test_missing_library_is_built_once_into_build_and_never_into_native(tmp_path,
                                                                          monkeypatch):
    monkeypatch.setattr(_native, "COMMITTED_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "_errors", {})
    path = _native.library_path("libhaar.so", ("haar.cc",))
    assert path == str(tmp_path / "build" / "libhaar.so") and os.path.exists(path)
    stamp = os.stat(path).st_mtime_ns
    assert haar_native.engine() == "native"            # loads the built library
    assert _native.library_path("libhaar.so", ("haar.cc",)) == path
    assert os.stat(path).st_mtime_ns == stamp          # no rebuild
    gray = scene_with_face().astype(np.float32)
    cascade = haar.get_default_cascade()
    np.testing.assert_array_equal(
        haar_native.detect_raw(cascade, gray, 1.1, 24, None),
        jax_haar_native.detect_raw(jax_haar.get_default_cascade(), gray, 1.1, 24, None))


def test_an_unloadable_decoder_raises_a_decode_error_naming_it(tmp_path, predictors,
                                                               serve_env):
    """A library the loader cannot open (as where libav is missing) raises
    ``VideoDecodeError`` naming it at the first call and at every later one,
    never at import; the Predictor turns it into an ``error`` dict."""
    (tmp_path / "libvideodec.so").write_bytes(b"not an ELF file")
    serve_env.setattr(_native, "COMMITTED_DIR", str(tmp_path))
    serve_env.setattr(_native, "_libs", {})
    serve_env.setattr(_native, "_errors", {})
    for _ in range(2):
        with pytest.raises(video.VideoDecodeError, match="libvideodec.so"):
            video.probe_video("clip.mp4")
    with pytest.raises(video.VideoDecodeError, match="libvideodec.so"):
        video.sample_video_faces_spread_yuv("clip.mp4", face_size=SIZE)
    _, ppred = _use(predictors, "center")
    res = ppred.predict_video("clip.mp4")
    assert list(res) == ["error"] and "libvideodec.so" in res["error"]


@pytest.mark.parametrize("kw", [{}, {"sample_rate": 3, "max_frames": 5},
                                {"size": (160, 120), "max_frames": 40},
                                {"keyframes_only": True, "sample_rate": 1}])
def test_native_frames_match_jax(clips, env, kw):
    for name in ("face", "noface"):
        assert video.probe_video(clips[name]) == jax_video.probe_video(clips[name])
        ours = video.sample_video_frames(clips[name], **kw)
        ref = jax_video.sample_video_frames(clips[name], **kw)
        assert ours.shape == ref.shape and ours.shape[0] > 0
        np.testing.assert_array_equal(ours, ref)


def test_cv2_route_matches_the_native_route_and_jax(clips, env):
    """``VIDEO_BACKEND=cv2`` (the route on a host without libav) decodes the
    same bytes as the native decoder here, and as JAX's cv2 route."""
    pytest.importorskip("cv2")
    native = video.sample_video_frames(clips["face"], sample_rate=5, max_frames=8)
    env.setenv("VIDEO_BACKEND", "cv2")
    ours = video.sample_video_frames(clips["face"], sample_rate=5, max_frames=8)
    np.testing.assert_array_equal(ours, jax_video.sample_video_frames(
        clips["face"], sample_rate=5, max_frames=8))
    np.testing.assert_array_equal(ours, native)
    assert video.sample_video_frames(__file__).shape == (0, 0, 0, 3)  # not a video


@pytest.mark.parametrize("margin", [0.1, 0.07, 0.0, -0.05])
def test_center_crops_match_jax(clips, env, margin):
    for w, h in ((320, 240), (1280, 720), (101, 77)):
        assert video.center_crop_box(w, h, margin) == jax_video.center_crop_box(w, h, margin)
        np.testing.assert_array_equal(faces.center_square_boxes(3, h, w, margin),
                                      jax_faces.center_square_boxes(3, h, w, margin))
    assert video._margin_ppm(margin) == jax_video._margin_ppm(margin)
    path = clips["face"]
    np.testing.assert_array_equal(
        video.sample_video_faces_center(path, face_size=SIZE, max_frames=6, margin=margin),
        jax_video.sample_video_faces_center(path, face_size=SIZE, max_frames=6, margin=margin))
    np.testing.assert_array_equal(
        video.sample_video_faces_spread(path, face_size=SIZE, n_frames=5, margin=margin),
        jax_video.sample_video_faces_spread(path, face_size=SIZE, n_frames=5, margin=margin))
    batch = np.zeros((2, 5, SIZE * SIZE * 3 // 2), np.uint8)
    got = video.sample_video_faces_spread_yuv(path, face_size=SIZE, n_frames=5,
                                              margin=margin, out=batch[1])
    assert np.shares_memory(got, batch)
    np.testing.assert_array_equal(batch[1], jax_video.sample_video_faces_spread_yuv(
        path, face_size=SIZE, n_frames=5, margin=margin))
    assert not batch[0].any()
    for bad in (batch[:, 0], np.zeros((5, 10), np.uint8), batch[1].astype(np.int16)):
        with pytest.raises(ValueError, match="out buffer"):
            video.sample_video_faces_spread_yuv(path, face_size=SIZE, n_frames=5, out=bad)


@pytest.mark.parametrize("clip", ["face", "partial", "noface"])
@pytest.mark.parametrize("opts", [{}, {"track": False, "acquire": False, "margin": 0.0},
                                  {"max_side": 200, "min_neighbors": 3,
                                   "track_expand": 1.5}])
def test_in_decoder_haar_matches_jax(clips, clip, opts):
    ours = video.sample_video_faces_haar_yuv(clips[clip], haar.get_default_cascade(),
                                             face_size=SIZE, n_frames=6, **opts)
    ref = jax_video.sample_video_faces_haar_yuv(clips[clip], jax_haar.get_default_cascade(),
                                                face_size=SIZE, n_frames=6, **opts)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    found = ours[2]
    assert found.all() if clip == "face" else (not found.any() if clip == "noface"
                                               else 0 < found.sum() < 6)


# ---------------------------------------------------------------------------
# the Haar detector
# ---------------------------------------------------------------------------


def test_haar_helpers_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(haar.rgb_to_gray(rgb), jax_haar.rgb_to_gray(rgb))
    g = haar.rgb_to_gray(rgb)
    np.testing.assert_array_equal(haar._resize_bilinear(g, 20, 31),
                                  jax_haar._resize_bilinear(g, 20, 31))
    boxes = np.concatenate([rng.uniform(0, 100, (30, 2)),
                            np.repeat(rng.uniform(20, 40, (30, 1)), 2, 1)], 1)
    boxes[10:20] = boxes[0] + rng.normal(0, 1, (10, 4))
    for k in (1, 3, 4):
        for o, r in zip(haar.group_rectangles(boxes, k), jax_haar.group_rectangles(boxes, k)):
            np.testing.assert_array_equal(o, r)
    assert haar.find_cascade_file() == jax_haar.find_cascade_file()


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_cascade_detect_matches_jax(engine):
    ours, ref = haar.get_default_cascade(), jax_haar.get_default_cascade()
    for attr in ("rects", "weights", "feat_idx", "node_thr", "leaves", "stage_ends",
                 "stage_thr"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    gray = scene_with_face(H=160, W=200, oy=20, ox=60, s=90)
    assert len(ours.detect(gray, engine=engine)[0]) > 0
    for kw in ({}, {"min_neighbors": 2, "min_size": 40, "max_size": 120}):
        o = ours.detect(gray, engine=engine, **kw)
        r = ref.detect(gray, engine=engine, **kw)
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, b)


def test_detect_faces_matches_jax_with_and_without_a_roi(clips, env):
    frame = video.sample_video_frames(clips["face"], max_frames=3)[2]
    big = np.repeat(np.repeat(frame, 3, 0), 3, 1)            # 720 × 960: downscaled
    for img in (frame, big):
        s = img.shape[1] / frame.shape[1]
        for kw in ({}, {"roi": (40 * s, 10 * s, 230 * s, 180 * s)},
                   {"roi": (40 * s, 10 * s, 230 * s, 180 * s), "min_size_px": 70 * s,
                    "max_size_px": 170 * s}, {"min_neighbors": 6, "max_side": 200}):
            o, r = haar.detect_faces(img, **kw), jax_haar.detect_faces(img, **kw)
            for a, b in zip(o, r):
                np.testing.assert_array_equal(a, b)
        assert len(haar.detect_faces(img)[0]) > 0


# ---------------------------------------------------------------------------
# crop / resize and the extractor
# ---------------------------------------------------------------------------


def test_crop_and_resize_matches_jax_within_one_level():
    """Fractional corners, boxes partly off the frame, a 1-px box, the whole
    frame, and output sizes above and below the crop's."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (6, 90, 120, 3), np.uint8)
    boxes = np.array([[10.3, 5.7, 60.2, 55.9], [-20.5, -10.25, 80.75, 95.5],
                      [50, 40, 51, 41], [0, 0, 120, 90], [100.6, 70.1, 140.2, 110.3],
                      [33.3, 12.1, 33.3, 12.1]], np.float32)
    shares = []
    for size in (7, 32, 224):
        ours = faces.crop_and_resize_batch(frames, boxes, size, "cpu")
        gap, share = _level_gap(ours, jax_faces.crop_and_resize_batch(frames, boxes, size))
        assert gap <= 1 and share < 0.01, (size, gap, share)
        shares.append(share)
    assert faces.crop_and_resize_batch(frames[:0], boxes[:0], 8, "cpu").shape == (0, 8, 8, 3)


@pytest.mark.parametrize("detector", ["center", "haar", "none"])
def test_extract_from_frames_and_video_match_jax(clips, env, detector):
    ours = faces.FaceExtractor(detector=detector, face_size=SIZE, device="cpu")
    ref = jax_faces.FaceExtractor(detector=detector, face_size=SIZE)
    assert ours.detector == ref.detector == detector
    for clip in ("face", "partial", "noface"):
        frames = video.sample_video_frames(clips[clip], max_frames=6)
        for o, r in ((ours.extract_from_frames(frames), ref.extract_from_frames(frames)),
                     (ours.extract_from_video(clips[clip], max_frames=6),
                      ref.extract_from_video(clips[clip], max_frames=6)),
                     (ours.extract_from_video(clips[clip], max_frames=3, spread=True),
                      ref.extract_from_video(clips[clip], max_frames=3, spread=True))):
            gap, share = _level_gap(o, r)
            assert gap <= 1 and share < 0.5, (clip, gap, share)
        if detector == "haar":
            assert len(ours._detect_haar(frames)) == len(frames)
            for o, r in zip(ours._detect_haar(frames), ref._detect_haar(frames)):
                assert (o is None and r is None) or np.array_equal(o, r)
    batch = ours.extract_from_frames_batch([frames, frames[:2], frames[:0]])
    assert [b.shape[0] for b in batch] == [len(frames), 2, 0]
    np.testing.assert_array_equal(batch[1], ours.extract_from_frames(frames[:2]))


@pytest.mark.parametrize("track", ["1", "0"])
def test_haar_tracking_and_keep_all_match_jax(clips, env, track):
    env.setenv("HAAR_TRACK", track)
    env.setenv("HAAR_TRACK_EXPAND", "1.6")
    frames = video.sample_video_frames(clips["partial"], sample_rate=3, max_frames=12)
    for keep_all in (False, True):
        ours = faces.FaceExtractor(detector="haar", face_size=SIZE, keep_all=keep_all,
                                   device="cpu")
        ref = jax_faces.FaceExtractor(detector="haar", face_size=SIZE, keep_all=keep_all)
        got, want = ours._detect_haar(frames), ref._detect_haar(frames)
        assert [g is None for g in got] == [w is None for w in want]
        for g, w in zip(got, want):
            if g is not None:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("detector", ["center", "haar"])
def test_extract_from_video_yuv_matches_jax(clips, env, detector):
    ours = faces.FaceExtractor(detector=detector, face_size=SIZE, device="cpu")
    ref = jax_faces.FaceExtractor(detector=detector, face_size=SIZE)
    for clip in ("face", "partial", "noface"):
        o = ours.extract_from_video_yuv(clips[clip], max_frames=6)
        np.testing.assert_array_equal(o, ref.extract_from_video_yuv(clips[clip], max_frames=6))
        if detector == "haar":
            for attr in ("last_boxes", "last_found", "last_frame_index"):
                np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
            assert o.shape[0] == ours.last_boxes.shape[0] == len(ours.last_frame_index)
    slot = np.zeros((6, SIZE * SIZE * 3 // 2), np.uint8)
    got = ours.extract_from_video_yuv(clips["face"], max_frames=6, out=slot)
    assert np.shares_memory(got, slot)
    keep_all = faces.FaceExtractor(detector=detector, face_size=SIZE, keep_all=True,
                                   device="cpu")
    if detector == "haar":
        with pytest.raises(ValueError, match="KEEP_ALL_FACES"):
            keep_all.extract_from_video_yuv(clips["face"])
    none = faces.FaceExtractor(detector="none", face_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="requires detector"):
        none.extract_from_video_yuv(clips["face"])


def test_detector_resolution_matches_jax(env, tmp_path, caplog):
    weights = tmp_path / "mtcnn.npz"
    weights.write_bytes(b"")
    cases = [({}, "haar"), ({"detector": "center"}, "center"),
             ({"detector": "mtcnn"}, "haar"),
             ({"detector": "mtcnn", "mtcnn_weights": str(weights)}, "mtcnn"),
             ({"mtcnn_weights": str(weights)}, "mtcnn")]
    for kw, want in cases:
        ours = faces.FaceExtractor(face_size=SIZE, device="cpu", **kw)
        assert ours.detector == jax_faces.FaceExtractor(face_size=SIZE, **kw).detector == want
    env.setenv("FACE_DETECTOR", "Center ")
    env.setenv("FACE_SIZE", "48")
    env.setenv("KEEP_ALL_FACES", "yes")
    ours = faces.FaceExtractor(device="cpu")
    assert (ours.detector, ours.face_size, ours.keep_all) == ("center", 48, True)
    env.setenv("HAAR_CASCADE", str(tmp_path / "missing.xml"))
    haar._DEFAULT.clear()
    jax_haar._DEFAULT.clear()
    try:
        for kw in ({"detector": "haar"}, {"detector": "auto"}):
            assert faces.FaceExtractor(face_size=SIZE, device="cpu", **kw).detector == \
                jax_faces.FaceExtractor(face_size=SIZE, **kw).detector == "center"
        assert "falling back to the 'center' face prior" in caplog.text
    finally:
        haar._DEFAULT.clear()
        jax_haar._DEFAULT.clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        faces.FaceExtractor(detector="center")                   # the card by default


def test_mtcnn_raises_naming_item_17(tmp_path, clips):
    """The mtcnn detector is ported (ROADMAP item 17's MTCNN half): an
    unreadable weights file raises at first use, as the JAX package's
    does, and a facenet-layout file runs the cascade on the clip's frames
    (``test_torch_port_mtcnn.py`` holds it against JAX's)."""
    from mtcnn_torch_ref import make_nets

    weights = tmp_path / "mtcnn.npz"
    weights.write_bytes(b"")
    frames = video.sample_video_frames(clips["face"], max_frames=2)
    for ex in (faces.FaceExtractor(detector="mtcnn", mtcnn_weights=str(weights),
                                   face_size=SIZE, device="cpu"),
               jax_faces.FaceExtractor(detector="mtcnn", mtcnn_weights=str(weights),
                                       face_size=SIZE)):
        assert ex.detector == "mtcnn"
        with pytest.raises(EOFError):
            ex.extract_from_frames(frames)
    _, sd = make_nets(seed=7)
    pt = tmp_path / "mtcnn.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(pt))
    ex = faces.FaceExtractor(detector="mtcnn", mtcnn_weights=str(pt), face_size=SIZE,
                             device="cpu")
    got = ex.extract_from_frames(frames)
    assert got.shape[1:] == (SIZE, SIZE, 3) and got.shape[0] >= 1
    np.testing.assert_array_equal(ex.extract_from_frames_batch([frames])[0], got)


# ---------------------------------------------------------------------------
# predict_video
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    """One JAX and one port Predictor over the same B0 detector at 32 px."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {"SERVE_WARMUP": "0", "SERVE_DP": "0", "MAX_FRAMES": str(T)}.items():
            mp.setenv(k, v)
        jmodel = JaxDetector("efficientnet_b0")
        variables = random_variables(jmodel, 21)
        jpred = jax_predict.Predictor(
            jmodel, variables, "pretrained",
            extractor=jax_faces.FaceExtractor(detector="center", face_size=SIZE))
        ppred = port_predict.Predictor(
            BackboneDetector("efficientnet_b0", device="cpu"), state_dict_from_jax(variables),
            "pretrained", extractor=faces.FaceExtractor(detector="center", face_size=SIZE,
                                                        device="cpu"), device="cpu")
    yield jpred, ppred
    ppred.close()


@pytest.fixture
def serve_env(env):
    for k, v in {"SERVE_WARMUP": "0", "SERVE_DP": "0", "MIN_FACES": "1",
                 "DETECT_ABSTAIN_CONF": "0", "MAX_FRAMES": str(T)}.items():
        env.setenv(k, v)
    return env


def _use(preds, detector):
    jpred, ppred = preds
    jpred.extractor = jax_faces.FaceExtractor(detector=detector, face_size=SIZE)
    ppred.extractor = faces.FaceExtractor(detector=detector, face_size=SIZE, device="cpu")
    return jpred, ppred


def _assert_same(ours, ref):
    assert "error" not in ours and "error" not in ref, (ours, ref)
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        if key in ("prob_fake", "prob_real", "confidence", "threshold"):
            assert ours[key] == pytest.approx(want, abs=PROB_ATOL), key
        elif key == "frame_scores":
            np.testing.assert_allclose(ours[key], want, atol=PROB_ATOL)
        elif key == "windows":
            assert sorted(ours[key]) == sorted(want)
            np.testing.assert_allclose(ours[key]["prob_fake"], want["prob_fake"],
                                       atol=PROB_ATOL)
            for k in ("count", "deciding_window", "temporal_alignment", "policy"):
                assert ours[key][k] == want[k], k
        elif key == "saliency":
            assert sorted(ours[key]) == sorted(want)
            assert ours[key]["grid"] == want["grid"]
            assert ours[key]["pipeline_note"] == want["pipeline_note"]
            np.testing.assert_allclose(ours[key]["frames"], want["frames"], atol=5e-2)
        else:
            assert ours[key] == want, key


@pytest.mark.parametrize("case", ["center_yuv", "haar_yuv", "haar_yuv_partial",
                                  "haar_yuv_noface", "haar_rgb_cv2", "center_rgb",
                                  "haar_windows_yuv", "haar_windows_rgb", "explain"])
def test_predict_video_matches_jax(predictors, serve_env, clips, case):
    detector = case.split("_")[0] if case != "explain" else "haar"
    jpred, ppred = _use(predictors, detector)
    clip = {"haar_yuv_partial": "partial", "haar_yuv_noface": "noface"}.get(case, "face")
    if case in ("haar_rgb_cv2", "center_rgb", "haar_windows_rgb"):
        serve_env.setenv("SERVE_YUV_TRANSFER", "0")
    if case == "haar_rgb_cv2":
        serve_env.setenv("VIDEO_BACKEND", "cv2")
    if "windows" in case:
        serve_env.setenv("SERVE_WINDOWS", "2")
    rgb_calls = []
    orig = ppred.extractor.extract_from_video
    ppred.extractor.extract_from_video = lambda *a, **kw: rgb_calls.append(kw) or orig(*a, **kw)
    ours = ppred.predict_video(clips[clip], explain=case == "explain")
    ref = jpred.predict_video(clips[clip], explain=case == "explain")
    _assert_same(ours, ref)
    assert bool(rgb_calls) == (case in ("haar_rgb_cv2", "center_rgb", "haar_windows_rgb",
                                        "explain"))
    if "windows" in case:
        assert ours["windows"]["count"] == 2 and rgb_calls in ([], [{"max_frames": 2 * T,
                                                                     "spread": True}])
    if case == "explain":
        assert ppred.explain_error is None and len(ours["saliency"]["frames"]) == T
    if case != "haar_yuv_partial":
        assert ours["num_faces"] == (2 * T if "windows" in case else T)


def test_predict_video_error_dicts_match_jax(predictors, serve_env, tmp_path, clips):
    jpred, ppred = _use(predictors, "center")
    missing = str(tmp_path / "missing.mp4")
    ours, ref = ppred.predict_video(missing), jpred.predict_video(missing)
    assert sorted(ours) == sorted(ref) == ["error"] and missing in ours["error"]
    jpred, ppred = _use(predictors, "haar")
    serve_env.setenv("SERVE_YUV_TRANSFER", "0")
    serve_env.setenv("VIDEO_BACKEND", "cv2")
    # cv2 cannot open a text file: no frames, hence no faces
    ours, ref = ppred.predict_video(__file__), jpred.predict_video(__file__)
    assert ours == ref == {"error": "No faces detected in video"}
    serve_env.setenv("MIN_FACES", "8")                      # the abstain gate sees 4 faces
    serve_env.delenv("VIDEO_BACKEND")
    ours, ref = ppred.predict_video(clips["face"]), jpred.predict_video(clips["face"])
    assert ours == ref and ours["abstained"] and ours["num_faces"] == T


def test_legacy_predict_video_matches_jax(serve_env, clips):
    from test_torch_port_legacy import _graph_pair

    jm, v, pm = _graph_pair(192, seed=5)
    jpred = jax_predict.Predictor(jm, v, "vit_gcn", extractor=jax_faces.FaceExtractor(
        detector="haar", face_size=SIZE))
    ppred = port_predict.Predictor(pm, None, "vit_gcn", extractor=faces.FaceExtractor(
        detector="haar", face_size=SIZE, device="cpu"), device="cpu")
    ours, ref = ppred.predict_video(clips["face"]), jpred.predict_video(clips["face"])
    ppred.close()
    assert sorted(ours) == sorted(ref) and ours["num_faces"] == ref["num_faces"] == T
    for key, want in ref.items():
        if isinstance(want, float):
            assert ours[key] == pytest.approx(want, abs=PROB_ATOL), key
        else:
            assert ours[key] == want, key


def test_pad_to_fixed_scan_shape_matches_jax(env):
    rng = np.random.default_rng(3)
    for min_faces in ("1", "2", "5"):
        env.setenv("MIN_FACES", min_faces)
        for n, windows, total in ((3, 2, 8), (8, 2, 8), (1, 3, 12), (4, 1, 8), (0, 2, 8),
                                  (11, 4, 16)):
            x = rng.integers(0, 256, (n, 6), np.uint8)
            np.testing.assert_array_equal(
                port_predict.Predictor._pad_to_fixed_scan_shape(x, windows, total),
                jax_predict.Predictor._pad_to_fixed_scan_shape(x, windows, total))


class _GatedExtractor:
    """Counts extractions in flight; each waits at ``gate``."""
    detector, keep_all, face_size = "center", False, SIZE

    def __init__(self, parties):
        self.lock, self.inside, self.most = threading.Lock(), 0, 0
        self.gate = threading.Barrier(parties, timeout=2)

    def extract_from_video_yuv(self, path, max_frames=None):
        with self.lock:
            self.inside += 1
            self.most = max(self.most, self.inside)
        try:
            self.gate.wait()
        except threading.BrokenBarrierError:
            pass
        with self.lock:
            self.inside -= 1
        return np.zeros((0, SIZE * SIZE * 3 // 2), np.uint8)


@pytest.mark.parametrize("limit", ["0", "1", "3"])
def test_extraction_semaphore(serve_env, limit):
    """``SERVE_EXTRACT_CONCURRENCY``: 0 turns admission control off, N lets
    N extractions run at once; the default is max(2, cpu_count)."""
    ex = _GatedExtractor(3)
    pred = port_predict.Predictor(BackboneDetector("efficientnet_b0", device="cpu"), None,
                                  "pretrained", extractor=ex, device="cpu")
    assert pred._extract_sem._value == max(2, os.cpu_count() or 1)
    pred.close()
    serve_env.setenv("SERVE_EXTRACT_CONCURRENCY", limit)
    pred = port_predict.Predictor(BackboneDetector("efficientnet_b0", device="cpu"), None,
                                  "pretrained", extractor=ex, device="cpu")
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, pred.predict_video(f"clip{i}.mp4"))) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    pred.close()
    assert out == [{"error": "No faces detected in video"}] * 3
    assert (pred._extract_sem is None) == (limit == "0")
    assert ex.most == {"0": 3, "1": 1, "3": 3}[limit]


@pytest.mark.parametrize("backend", [None, "cv2"])
def test_spread_without_the_native_probe(clips, env, backend):
    """``extract_from_video(spread=True)``: with the native decoder both
    packages stride the clip from ``probe_video``'s frame count and sample
    the same frames, byte-equal. Under ``VIDEO_BACKEND=cv2`` with
    ``probe_video`` made to raise (no libav), JAX's samples stop at the
    clip's head (a fault of the reference) and the port's span it, the
    stride from cv2's frame count."""
    calls = {}

    def recording(module, name):
        real = module.sample_video_frames

        def sample(path, sample_rate=None, **kw):
            frames = real(path, sample_rate=sample_rate, **kw)
            calls[name] = (sample_rate, frames)
            return frames

        env.setattr(module, "sample_video_frames", sample)

    def no_probe(path):
        raise video.VideoDecodeError(f"{path}: no libav")

    for module, name in ((faces, "port"), (jax_faces, "jax")):
        recording(module, name)
    if backend:
        env.setenv("VIDEO_BACKEND", backend)
        env.setattr(faces, "probe_video", no_probe)
        env.setattr(jax_video, "probe_video", no_probe)     # imported at the call
    n_total, n = 36, 3
    ours = faces.FaceExtractor(detector="haar", face_size=SIZE, device="cpu")
    ref = jax_faces.FaceExtractor(detector="haar", face_size=SIZE)
    ours.extract_from_video(clips["face"], max_frames=n, spread=True)
    ref.extract_from_video(clips["face"], max_frames=n, spread=True)
    (rate, got), (jrate, want) = calls["port"], calls["jax"]
    assert len(got) == len(want) == n
    if backend is None:
        assert rate == jrate == n_total // n and got.tobytes() == want.tobytes()
        return
    assert jrate is None                                # the default stride: the head
    assert video.backend_frame_count("cv2", clips["face"]) == n_total
    assert rate == n_total // n
    full = video.sample_video_frames(clips["face"], sample_rate=1, max_frames=n_total)
    assert all(np.array_equal(got[i], full[i * rate]) for i in range(n))
    assert not np.array_equal(got[1], want[1])

"""The port's dataset preparation (``data/prepare.py``), its direct-from-
video dataset (``data/video_dataset.py``) and ``--from-videos`` in the
training CLI and the evaluator, against the JAX package's, on the CPU.

Clips are written by the JAX package's ``encode_video`` (mpeg4). Both
packages load the same committed ``native/build/libvideodec.so``, so every
crop made inside the decoder (the center detector's, the haar seek path's)
is equal byte for byte; crops resized by ``crop_and_resize_batch`` may
differ by 1 level (f32 sums in other orders; ``test_torch_port_video.py``).

The center repair: where the native decoder cannot load (a host without
libav), JAX's center branch fails on every clip and its
dataset trains on zeros; the port, with ``VIDEO_BACKEND=cv2``, decodes
through cv2 and crops with the center prior.
"""

import csv
import os
import shutil
import tarfile
import zipfile

import numpy as np
import pytest

from deepfake_video_detection_tpu.data import prepare as jax_prepare
from deepfake_video_detection_tpu.data import faces as jax_faces
from deepfake_video_detection_tpu.data import video as jax_video
from deepfake_video_detection_tpu.data import video_dataset as jax_video_dataset
from deepfake_video_detection_tpu.evals import evaluate as jax_evaluate
from deepfake_video_detection_tpu_torch.data import prepare
from deepfake_video_detection_tpu_torch.data import video
from deepfake_video_detection_tpu_torch.data import video_dataset
from deepfake_video_detection_tpu_torch.evals import evaluate
from deepfake_video_detection_tpu_torch.train import cli

from mtcnn_torch_ref import make_nets
from test_haar import _require_cascade, scene_with_face

PROB_ATOL = 5e-4


@pytest.fixture
def env(monkeypatch):
    for k in ("VIDEO_BACKEND", "VIDEO_SAMPLE_RATE", "VIDEO_KEYFRAMES_ONLY", "FACE_DETECTOR",
              "MTCNN_WEIGHTS", "HAAR_CASCADE", "HAAR_TRACK", "HAAR_MAX_SIDE",
              "KEEP_ALL_FACES", "MAX_FRAMES", "FACE_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """``test_video_dataset``'s corpus: 8 labelled noise clips of 12 frames
    at 64 x 96, a text file and an unlabelled empty clip."""
    d = tmp_path_factory.mktemp("rawclips")
    rng = np.random.default_rng(0)
    for i in range(8):
        label = i % 2
        base = 190 if label else 50
        frames = rng.integers(base - 30, base + 30, (12, 64, 96, 3)).astype(np.uint8)
        jax_video.encode_video(str(d / f"clip{i}_{'fake' if label else 'real'}.avi"),
                               frames, fps=10)
    (d / "notes.txt").write_text("not a video")
    (d / "unlabeled.avi").write_bytes(b"")
    return str(d)


@pytest.fixture(scope="module")
def face_dir(tmp_path_factory):
    """One 16-frame clip of the synthetic face (``test_haar``), 240 x 320."""
    d = tmp_path_factory.mktemp("faceclip")
    img = scene_with_face(H=240, W=320, oy=20, ox=190, s=100)
    frames = np.stack([np.stack([img] * 3, -1).astype(np.uint8)] * 16)
    jax_video.encode_video(str(d / "fake_clip.avi"), frames, fps=12)
    return str(d)


def _level_gap(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()) if d.size else 0, float((d > 0).mean()) if d.size else 0.0


def _both_prepare(argv, tmp_path, capsys=None):
    """Run both packages' ``main`` into their own out dirs; returns
    ({name: (faces, label)} of each, the port's stdout)."""
    outs, printed = [], ""
    for tag, main in (("jax", jax_prepare.main), ("port", prepare.main)):
        out = tmp_path / tag
        extra = ["--device", "cpu"] if tag == "port" else []
        assert main(argv + ["--out_dir", str(out)] + extra) == 0
        if capsys is not None and tag == "port":
            printed = capsys.readouterr().out
        files = {}
        for f in sorted(out.glob("*.npz")):
            with np.load(f) as z:
                files[f.name] = (z["faces"], int(z["label"]))
        outs.append(files)
    return outs[0], outs[1], printed


def _assert_same_samples(ref, got, max_share=1.0):
    assert sorted(got) == sorted(ref) and got
    for name in ref:
        assert got[name][1] == ref[name][1]
        gap, share = _level_gap(got[name][0], ref[name][0])
        assert gap <= 1 and share <= max_share, (name, gap, share)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "filename,label\nvidA.mp4,fake\nvidB,REAL\nvidC,1\nvidD,original\nvidE,unknown\n",
    "a/b/clip1.avi,df\nclip2,0\n\nclip3\n",
    "video,is_fake\nx,1\n",
])
def test_labels_csv_and_resolve_label_equal_jax(tmp_path, text):
    p = tmp_path / "labels.csv"
    p.write_text(text)
    labels = prepare.load_labels_csv(str(p))
    assert labels == jax_prepare.load_labels_csv(str(p))
    for path in ("d/vidA.mp4", "d/vidB_extra.avi", "clip1.avi", "clip2_fake.mp4",
                 "x.mp4", "nothing.mp4", "real/one.mp4", "z_fake_1.png"):
        for lab in (labels, None):
            assert prepare.resolve_label(path, lab) == jax_prepare.resolve_label(path, lab)


def test_flat_frame_keys_and_layout_equal_jax():
    names = ["vidA_000_0.png", "vid_B_12_3.JPG", "x_1.png", "y_2_3.bmp", "clip.png",
             "a_b_c.jpeg", "v_0001_0000.jpeg"]
    for n in names:
        assert prepare.parse_flat_frames_key(n) == jax_prepare.parse_flat_frames_key(n)
    for files, thr in ((names, 0.8), (names, 0.4), (names[:2], 0.8), (["a.txt"], 0.8), ([], 0.8)):
        assert (prepare.is_flat_frames_layout(files, thr)
                == jax_prepare.is_flat_frames_layout(files, thr))


def test_extract_archive_equal_jax(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(os.urandom(300))
    zpath, tpath = tmp_path / "a.zip", tmp_path / "a.tar"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(src, "inner/x.bin")
    with tarfile.open(tpath, "w") as t:
        t.add(src, "inner/y.bin")
    for arc in (zpath, tpath):
        a, b = tmp_path / f"port_{arc.name}", tmp_path / f"jax_{arc.name}"
        assert prepare.extract_archive(str(arc), str(a)) == str(a)
        jax_prepare.extract_archive(str(arc), str(b))
        got = sorted(str(p.relative_to(a)) for p in a.rglob("*"))
        assert got == sorted(str(p.relative_to(b)) for p in b.rglob("*")) and got
    with pytest.raises(ValueError):
        prepare.extract_archive(str(src), str(tmp_path / "no"))


def test_packed_yuv_to_rgb_is_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    for size in (32, 224):
        packed = rng.integers(0, 256, (3, size * size * 3 // 2)).astype(np.uint8)
        got = prepare._packed_yuv_to_rgb_u8(packed, size)
        assert got.shape == (3, size, size, 3)
        np.testing.assert_array_equal(got, jax_prepare._packed_yuv_to_rgb_u8(packed, size))


# ---------------------------------------------------------------------------
# the prep CLI
# ---------------------------------------------------------------------------


def test_prepare_raw_videos_center_and_a_corrupt_clip(video_dir, env, tmp_path, capsys):
    d = tmp_path / "clips"
    d.mkdir()
    for f in ("clip0_real.avi", "clip1_fake.avi", "notes.txt"):
        shutil.copy(os.path.join(video_dir, f), d / f)
    (d / "broken_fake.avi").write_bytes(os.urandom(4096))
    ref, got, printed = _both_prepare(
        ["--data_dir", str(d), "--sample_rate", "3", "--max_frames", "4", "--size", "32",
         "--detector", "center", "--workers", "2"], tmp_path, capsys)
    assert sorted(got) == ["clip0_real_real.npz", "clip1_fake_fake.npz"]
    _assert_same_samples(ref, got, max_share=0.05)
    assert "[prepare] skipping" in printed and "broken_fake.avi" in printed
    assert got["clip1_fake_fake.npz"][0].shape == (4, 32, 32, 3)


@pytest.mark.parametrize("seek", [True, False])
def test_prepare_haar_seek_path_and_scan(face_dir, env, tmp_path, seek):
    """The seek path crops inside the native decoder (byte-equal to JAX's);
    ``--no-seek-sampling`` scans and resizes on the device (within 1 level)."""
    _require_cascade()
    ref, got, _ = _both_prepare(
        ["--data_dir", face_dir, "--detector", "haar", "--size", "64", "--max_frames", "4"]
        + ([] if seek else ["--no-seek-sampling"]), tmp_path)
    _assert_same_samples(ref, got, max_share=0.0 if seek else 0.2)
    faces_ = got["fake_clip_fake.npz"][0]
    assert 1 <= faces_.shape[0] <= 4 and float(faces_.mean()) > 135   # on the face


def test_prepare_flat_frames_are_faces_and_frame_folders(env, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    flat = tmp_path / "flat"
    flat.mkdir()
    for vid in ("vidA", "vidB"):
        for fr in range(3):
            Image.fromarray(rng.integers(0, 255, (48, 48, 3)).astype(np.uint8)).save(
                flat / f"{vid}_{fr:03d}_0.png")
    csvp = tmp_path / "labels.csv"
    csvp.write_text("filename,label\nvidA,fake\nvidB,real\n")
    ref, got, _ = _both_prepare(["--data_dir", str(flat), "--labels_csv", str(csvp),
                                 "--frames-are-faces"], tmp_path / "a")
    assert sorted(got) == ["vidA_fake.npz", "vidB_real.npz"]
    assert got["vidA_fake.npz"][0].shape == (3, 224, 224, 3)
    _assert_same_samples(ref, got, max_share=0.05)

    folders = tmp_path / "folders"
    for name in ("clip1_real", "clip2_fake"):
        (folders / name).mkdir(parents=True)
        for fr in range(2):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)).save(
                folders / name / f"frame{fr}.png")
    ref, got, _ = _both_prepare(["--data_dir", str(folders), "--detector", "center",
                                 "--size", "24"], tmp_path / "b")
    assert sorted(got) == ["clip1_real_real.npz", "clip2_fake_fake.npz"]
    _assert_same_samples(ref, got, max_share=0.05)


def test_prepare_zip_archive(video_dir, env, tmp_path):
    zpath = tmp_path / "videos.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(os.path.join(video_dir, "clip3_fake.avi"), "inner/clip3_fake.avi")
        z.write(os.path.join(video_dir, "clip4_real.avi"), "inner/clip4_real.avi")
    ref, got, _ = _both_prepare(["--archive", str(zpath), "--sample_rate", "5",
                                 "--max_frames", "4", "--size", "32", "--detector", "center"],
                                tmp_path)
    assert sorted(got) == ["clip3_fake_fake.npz", "clip4_real_real.npz"]
    _assert_same_samples(ref, got, max_share=0.05)


def test_prepare_mtcnn_batches_equal_jax(env, tmp_path):
    """``--detector mtcnn``: one cascade a batch of clips, weights from
    ``MTCNN_WEIGHTS`` (``make_nets(seed=7)`` with the face-class biases
    raised so that candidates pass the default thresholds)."""
    from test_torch_port_mtcnn import _biased, _save_pt

    _, sd = make_nets(seed=7)
    env.setenv("MTCNN_WEIGHTS", _save_pt(_biased(sd), tmp_path / "mtcnn.pt"))
    vids = tmp_path / "videos"
    vids.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        frames = rng.integers(0, 256, (10, 64, 64, 3)).astype(np.uint8)
        jax_video.encode_video(str(vids / f"{'fake' if i % 2 else 'real'}_{i}.avi"),
                               frames, fps=10)
    ref, got, _ = _both_prepare(["--data_dir", str(vids), "--detector", "mtcnn", "--size",
                                 "32", "--max_frames", "4", "--batch-clips", "3"], tmp_path)
    # every 5th of 10 frames: 2 a clip
    assert len(got) == 3 and all(f.shape == (2, 32, 32, 3) for f, _ in got.values())
    _assert_same_samples(ref, got, max_share=0.05)


# ---------------------------------------------------------------------------
# VideoClipsDataset
# ---------------------------------------------------------------------------


def test_video_clips_dataset_interface_equals_jax(video_dir, env):
    ds = video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32, device="cpu")
    ref = jax_video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32)
    assert ds.files == ref.files and len(ds) == 8
    np.testing.assert_array_equal(ds.labels(), ref.labels())
    assert ds.labels().sum() == 4 and ds.extractor.detector == "center"
    for i in (0, 5):
        faces_, lab, path = ds[i]
        ref_faces, ref_lab, ref_path = ref[i]
        assert faces_.shape == (4, 32, 32, 3) and faces_.dtype == np.uint8
        np.testing.assert_array_equal(faces_, ref_faces)   # the in-decoder crop
        assert (lab, path) == (ref_lab, ref_path) and lab == ds.label(i)
    tr, va = ds.split(0.25)
    rtr, rva = ref.split(0.25)
    assert tr.files == rtr.files and va.files == rva.files and len(va) == 2
    assert len(video_dataset.VideoClipsDataset(video_dir, max_samples=3, device="cpu")) == 3
    with pytest.raises(FileNotFoundError):
        video_dataset.VideoClipsDataset(os.path.join(video_dir, "none"), device="cpu")


def test_video_clips_dataset_labels_csv(video_dir, env, tmp_path):
    csvp = tmp_path / "labels.csv"
    rows = ["filename,label"] + [f"clip{i}_{'fake' if i % 2 else 'real'},"
                                 f"{'fake' if i < 4 else 'real'}" for i in range(8)]
    csvp.write_text("\n".join(rows))
    ds = video_dataset.VideoClipsDataset(video_dir, num_frames=2, face_size=16,
                                         labels_csv=str(csvp), device="cpu")
    ref = jax_video_dataset.VideoClipsDataset(video_dir, num_frames=2, face_size=16,
                                              labels_csv=str(csvp))
    np.testing.assert_array_equal(ds.labels(), ref.labels())
    assert ds.labels().sum() == 4 and ds.label(0) == 1     # the CSV over the path token


def test_video_clips_dataset_contains_failures_and_caches_clips(video_dir, env, tmp_path,
                                                                capsys):
    d = tmp_path / "mix"
    d.mkdir()
    for f in ("clip0_real.avi", "clip1_fake.avi"):
        shutil.copy(os.path.join(video_dir, f), d / f)
    (d / "broken_fake.avi").write_bytes(os.urandom(2048))
    (d / "broken2_real.avi").write_bytes(os.urandom(2048))
    ds = video_dataset.VideoClipsDataset(str(d), num_frames=4, face_size=32, cache_clips=True,
                                         device="cpu")
    bad = [ds.files.index(str(d / n)) for n in ("broken_fake.avi", "broken2_real.avi")]
    for i in bad:
        faces_, lab, _ = ds[i]
        assert faces_.shape == (4, 32, 32, 3) and not faces_.any()
        assert lab == ds.label(i) and i not in ds._cache       # a failure is not cached
    err = capsys.readouterr().err
    assert err.count("[video_dataset] decode failed") == 1     # the first failure only
    good = ds.files.index(str(d / "clip1_fake.avi"))
    first = ds[good][0]
    assert first.any() and ds[good][0] is first                 # decoded once
    ref = jax_video_dataset.VideoClipsDataset(str(d), num_frames=4, face_size=32)
    np.testing.assert_array_equal(first, ref[good][0])
    nocache = video_dataset.VideoClipsDataset(str(d), num_frames=4, face_size=32,
                                              device="cpu")
    assert nocache._cache is None and nocache[good][0] is not nocache[good][0]


def _no_native(monkeypatch):
    """Both packages' native decoders unloadable, as without libav."""
    def missing():
        raise OSError("libavformat.so.59: cannot open shared object file")

    def missing_port():
        raise video.VideoDecodeError("libavformat.so.59: cannot open shared object file")

    monkeypatch.setattr(jax_video, "_get_lib", missing)
    monkeypatch.setattr(video, "_get_lib", missing_port)


def test_center_repair_decodes_through_cv2_without_the_native_decoder(video_dir, env,
                                                                       capsys):
    pytest.importorskip("cv2")
    # without VIDEO_BACKEND the port keeps JAX's in-decoder crop, byte for byte
    ds = video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32, device="cpu")
    ref = jax_video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32)
    np.testing.assert_array_equal(ds[1][0], ref[1][0])

    env.setenv("VIDEO_BACKEND", "cv2")
    _no_native(env)
    ds = video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32, device="cpu")
    ref = jax_video_dataset.VideoClipsDataset(video_dir, num_frames=4, face_size=32)
    capsys.readouterr()
    ref_faces = ref[1][0]
    assert not ref_faces.any()                                  # JAX: zeros
    assert "[video_dataset] decode failed" in capsys.readouterr().err
    got = ds[1][0]
    assert "decode failed" not in capsys.readouterr().err
    frames = video.sample_video_frames(ds.files[1], max_frames=4)    # cv2, every 5th
    assert frames.shape == (3, 64, 96, 3)
    want = jax_faces.FaceExtractor(detector="center", face_size=32).extract_from_frames(frames)
    gap, share = _level_gap(got[:3], want)
    assert gap <= 1 and share < 0.05, (gap, share)
    np.testing.assert_array_equal(got[3], got[2])               # padded by the last frame
    # the serving path's spread sampling takes the same route
    spread = ds.extractor.extract_from_video(ds.files[1], max_frames=4, spread=True)
    assert spread.shape[1:] == (32, 32, 3) and spread.any()


# ---------------------------------------------------------------------------
# --from-videos in the training CLI and the evaluator
# ---------------------------------------------------------------------------


def test_train_cli_passes_the_from_videos_flags(video_dir, env, monkeypatch):
    seen = {}

    class Recording(video_dataset.VideoClipsDataset):
        def __init__(self, *a, **kw):
            seen.update(kw)
            super().__init__(*a, **kw)

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(cli, "VideoClipsDataset", Recording)
    monkeypatch.setattr(cli, "build_model", stop)
    with pytest.raises(Stop):
        cli.main(["--data_dir", video_dir, "--from-videos", "--detector", "none",
                  "--face_size", "48", "--cache-clips", "--num_frames", "3",
                  "--labels_csv", os.devnull, "--device", "cpu"])
    assert seen == {"num_frames": 3, "face_size": 48, "detector": "none",
                    "labels_csv": os.devnull, "recursive": False, "cache_clips": True,
                    "device": "cpu"}


def test_train_and_evaluate_from_videos_against_jax(video_dir, env, tmp_path):
    """The port's CLI trains a small CNN+LSTM from the clips (as JAX's
    ``test_train_cli_from_videos``); both evaluators score its checkpoint
    from the clips: the same rows, ``prob_fake`` within 5e-4."""
    out = tmp_path / "ckpt"
    rc = cli.main(["--data_dir", video_dir, "--from-videos", "--model", "cnn_lstm",
                   "--epochs", "2", "--batch_size", "4", "--num_frames", "4",
                   "--face_size", "32", "--no-augment", "--out_dir", str(out),
                   "--device", "cpu"])
    assert rc == 0 and (out / "checkpoint_best.npz").exists()
    with open(out / "training_history.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and all(np.isfinite(float(r["train_loss"])) for r in rows)

    args = ["--data_dir", video_dir, "--from-videos", "--checkpoint",
            str(out / "checkpoint_best.npz"), "--num_frames", "4", "--face_size", "32",
            "--batch_size", "4"]
    assert evaluate.main(args + ["--out_csv", str(tmp_path / "port.csv"),
                                 "--device", "cpu"]) == 0
    assert jax_evaluate.main(args + ["--out_csv", str(tmp_path / "jax.csv")]) == 0
    got, ref = ([r for r in csv.DictReader(open(tmp_path / f"{t}.csv"))]
                for t in ("port", "jax"))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert (g["path"], g["label"]) == (r["path"], r["label"])
        assert abs(float(g["prob_fake"]) - float(r["prob_fake"])) <= PROB_ATOL

"""Serving data parallelism: the port's Predictor over eight CPU replicas
against the JAX package's Predictor over its eight CPU devices.

Both serve the two-block ViT-Tiny detector at 32 px of
``test_torch_port_serve.py`` (JAX's init, carried over), with
``SERVE_MICROBATCH`` and ``SERVE_DP`` on and ``SERVE_WARMUP=0``: JAX shards
each coalesced batch over the ``data`` axis of its 8-device mesh; the port
splits it into 8 row shards, one a replica, each on its own thread. Six
concurrent requests, the windowed scan at W = 3 (padded to 8 windows), the
buckets of ``MicroBatcher(bucket_multiple=...)``, the devices a Predictor
picks, and the warmup over every replica.
"""

import concurrent.futures as fut
import time

import numpy as np
import pytest

import jax
import torch

from deepfake_video_detection_tpu.models.backbone_detector import BackboneDetector as JaxDetector
from deepfake_video_detection_tpu.models.vit import VisionTransformer as JaxViT
from deepfake_video_detection_tpu.serve import predict as jax_predict
from deepfake_video_detection_tpu.serve.batcher import MicroBatcher as JaxBatcher
from deepfake_video_detection_tpu_torch.checkpoint.bridge import state_dict_from_jax
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.serve.batcher import MicroBatcher

SIZE, T, N_DP = 32, 4, 8
PROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    model = JaxDetector("vit_tiny_patch16_224")
    model.backbone = JaxViT(variant="vit_tiny_patch16_224", img_size=SIZE, depth=2)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0))


@pytest.fixture
def dp_env(monkeypatch):
    for k, v in {"SERVE_WARMUP": "0", "MIN_FACES": "1", "DETECT_ABSTAIN_CONF": "0",
                 "SERVE_MICROBATCH": "1", "SERVE_DP": "1", "MAX_FRAMES": str(T)}.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _extractor():
    return FaceExtractor(detector="center", face_size=SIZE, device="cpu")


def _port(weights, devices):
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.backbone = VisionTransformer(variant="vit_tiny_patch16_224", img_size=SIZE,
                                       depth=2, device="cpu")
    return port_predict.Predictor(model, state_dict_from_jax(weights[1]), "pretrained",
                                  extractor=_extractor(), device="cpu", devices=devices)


def _jax(weights):
    assert len(jax.devices()) == N_DP, "tests/conftest.py provisions 8 host devices"
    return jax_predict.Predictor(weights[0], weights[1], "pretrained", extractor=_extractor())


def _clips(n, frames=T, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (frames, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(n)]


def _assert_same(ours, ref):
    assert "error" not in ours and "error" not in ref
    for key in ("prediction", "verdict_yes_no", "pred_class", "num_faces", "abstained"):
        assert ours.get(key) == ref.get(key), key
    for key in ("prob_fake", "prob_real", "confidence"):
        if ref.get(key) is not None:
            assert ours[key] == pytest.approx(ref[key], abs=PROB_ATOL), key


def test_predictor_over_eight_replicas_matches_jax_dp(weights, dp_env):
    """Six concurrent requests through each package's DP Predictor: the
    same buckets (multiples of 8), verdicts and probabilities within 1e-5;
    every replica ran a shard, and the one-device port Predictor answers
    alike."""
    clips = _clips(6)
    jpred = _jax(weights)
    ppred = _port(weights, ["cpu"] * N_DP)
    assert jpred._batcher.bucket_multiple == ppred._batcher.bucket_multiple == N_DP
    assert ppred._batcher.bucket_sizes() == jpred._batcher.bucket_sizes() == [8, 16]
    assert len(ppred._replicas) == N_DP and ppred._replicas[0].model is ppred.model
    with fut.ThreadPoolExecutor(6) as pool:
        want = list(pool.map(lambda ic: jpred.predict_faces(ic[1], f"v{ic[0]}"),
                             enumerate(clips)))
        got = list(pool.map(lambda ic: ppred.predict_faces(ic[1], f"v{ic[0]}"),
                            enumerate(clips)))
    for w, g in zip(want, got):
        _assert_same(g, w)
    assert ppred._batcher.items_run == 6
    assert all(rep.batches >= 1 for rep in ppred._replicas)
    one = _port(weights, None)
    assert one._n_dp == 1 and not one._replicas and one._batcher.bucket_multiple == 1
    for i, c in enumerate(clips[:2]):
        _assert_same(one.predict_faces(c, f"v{i}"), got[i])
    for p in (ppred, one):
        p.close()


def test_windowed_scan_pads_three_windows_to_eight(weights, dp_env):
    """W = 3 windows of T frames over 8 replicas: 8 rows, one a replica,
    the 5 padding windows repeat the last and are sliced off; the windows'
    probabilities and the verdict equal JAX's DP scan and the one-device
    port's."""
    dp_env.setenv("SERVE_WINDOWS", "3")
    faces = _clips(1, frames=3 * T, seed=5)[0]
    ref = _jax(weights)._predict_pretrained(faces, "v", windows=3)
    ppred = _port(weights, ["cpu"] * N_DP)
    got = ppred._predict_pretrained(faces, "v", windows=3)
    assert [rep.batches for rep in ppred._replicas] == [1] * N_DP
    one = _port(weights, None)._predict_pretrained(faces, "v", windows=3)
    for res in (ref, one):
        _assert_same(got, res)
        assert got["windows"]["count"] == res["windows"]["count"] == 3
        assert got["windows"]["deciding_window"] == res["windows"]["deciding_window"]
        np.testing.assert_allclose(got["windows"]["prob_fake"], res["windows"]["prob_fake"],
                                   atol=PROB_ATOL)
    ppred.close()


def test_close_with_requests_pending_serves_every_request(weights, dp_env):
    """Eight replicas, six requests waiting in the batcher when the
    Predictor closes (a window of 2 s), and one request after close:
    every one gets the one-device Predictor's verdict."""
    dp_env.setenv("SERVE_MICROBATCH_WAIT_MS", "2000")
    clips = _clips(7, seed=7)
    ppred = _port(weights, ["cpu"] * N_DP)
    with fut.ThreadPoolExecutor(6) as pool:
        pending = [pool.submit(ppred.predict_faces, c, f"v{i}") for i, c in enumerate(clips[:6])]
        deadline = time.monotonic() + 5
        while sum(len(v[3]) for v in list(ppred._batcher._pending.values())) < 6 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        ppred.close()
        got = [f.result() for f in pending]
    got.append(ppred.predict_faces(clips[6], "v6"))
    one = _port(weights, None)
    for i, (c, g) in enumerate(zip(clips, got)):
        _assert_same(g, one.predict_faces(c, f"v{i}"))
    one.close()


@pytest.mark.parametrize("max_batch,multiple", [(16, 1), (16, 8), (12, 8), (4, 8), (16, 3),
                                                (1, 1), (9, 2)])
def test_bucket_multiple_equals_jax(max_batch, multiple):
    """The cap and every bucket, and the bucket each pending count pads to."""
    from deepfake_video_detection_tpu.serve.batcher import _bucket as jax_bucket

    from deepfake_video_detection_tpu_torch.serve.batcher import _bucket

    ours = MicroBatcher(max_batch=max_batch, bucket_multiple=multiple)
    ref = JaxBatcher(max_batch=max_batch, bucket_multiple=multiple)
    assert ours.max_batch == ref.max_batch
    assert ours.bucket_sizes() == ref.bucket_sizes()
    assert all(b % multiple == 0 for b in ours.bucket_sizes())
    for n in range(1, ours.max_batch + 1):
        assert _bucket(n, ours.max_batch, multiple) == jax_bucket(n, ref.max_batch, multiple)


def test_a_closed_batcher_runs_an_item_as_a_batch_of_the_multiple():
    seen = []
    b = MicroBatcher(max_batch=8, bucket_multiple=4)
    b.close()
    out = b.call(lambda x: (seen.append(x.shape) or x * 2,), np.ones(3), out_axes=(0,))
    assert seen == [(4, 3)] and out[0].shape == (1, 3)


def test_serving_devices(monkeypatch):
    """``device="cuda"`` keeps one card unless ``SERVE_DP=1``, and then
    spreads over every visible card when data parallelism applies;
    ``"cuda:i"`` keeps card i and the legacy types one device; ``devices=``
    asks for its replicas whatever ``SERVE_DP`` says, and naming several
    where data parallelism does not apply raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("SERVE_DP", raising=False)
    sd = port_predict.serving_devices
    assert sd("pretrained") == [torch.device("cuda")]
    assert sd("pretrained", devices=["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    monkeypatch.setenv("SERVE_DP", "0")
    assert sd("ensemble_pretrained") == [torch.device("cuda")]
    assert sd("pretrained", devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setenv("SERVE_DP", "1")
    assert sd("pretrained") == [torch.device("cuda", i) for i in range(4)]
    assert sd("temporal", "cuda") == [torch.device("cuda", i) for i in range(4)]
    assert sd("pretrained", "cuda:1") == [torch.device("cuda", 1)]
    assert sd("vit_gcn") == [torch.device("cuda")]
    assert sd("pretrained", "cpu") == [torch.device("cpu")]
    monkeypatch.setenv("SERVE_MICROBATCH", "0")
    assert sd("pretrained") == [torch.device("cuda")]
    with pytest.raises(ValueError, match="SERVE_MICROBATCH"):
        sd("pretrained", devices=["cpu", "cpu"])
    monkeypatch.setenv("SERVE_MICROBATCH", "1")
    with pytest.raises(ValueError, match="temporal model"):
        sd("cnn_lstm", devices=["cpu", "cpu"])
    assert sd("cnn_lstm", devices=["cpu"]) == [torch.device("cpu")]


def test_warmup_runs_every_shape_on_every_replica(weights, dp_env):
    """Two replicas with ``SERVE_WINDOWS=3``: batch 2, the padded W = 4 and
    the buckets 2-16, each through the YUV and the RGB forward, on both;
    a replica that fails makes ``warmup_error``."""
    dp_env.setenv("SERVE_WINDOWS", "3")
    pred = _port(weights, ["cpu", "cpu"])
    rows = {0: [], 1: []}
    for i, rep in enumerate(pred._replicas):
        for attr in ("forward", "forward_yuv"):
            fn = getattr(rep, attr)
            setattr(rep, attr, lambda x, _fn=fn, _i=i: rows[_i].append(x.shape[0]) or _fn(x))
    pred.warmup()
    assert pred.warmup_error is None
    assert rows[0] == rows[1] == [1, 1, 2, 2, 4, 4, 8, 8]

    def broken(x):
        raise RuntimeError("replica 1 is down")

    pred._replicas[1].forward_yuv = broken
    pred.warmup()
    assert isinstance(pred.warmup_error, RuntimeError)
    assert "replica 1 is down" in str(pred.warmup_error)
    pred.close()

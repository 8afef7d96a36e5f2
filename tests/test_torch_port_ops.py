"""PyTorch port ops vs the JAX package's ops, on the CPU.

The port's kernels run only on a CUDA card; here each wrapper takes its
plain PyTorch version (the tensors lie on the CPU), which is held against
the JAX Pallas kernel run in interpret mode, on the same numpy inputs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepfake_video_detection_tpu.data.normalize import imagenet_normalize as jax_imagenet_normalize
from deepfake_video_detection_tpu.ops.attention import _flash_impl, flash_attention as jax_flash
from deepfake_video_detection_tpu.ops.preprocess import fused_normalize as jax_fused_normalize
from deepfake_video_detection_tpu.ops.yuv import yuv420_packed_to_rgb as jax_yuv_to_rgb
from deepfake_video_detection_tpu_torch.data.normalize import imagenet_normalize
from deepfake_video_detection_tpu_torch.ops import _build
from deepfake_video_detection_tpu_torch.ops import attention as A
from deepfake_video_detection_tpu_torch.ops import preprocess as P
from deepfake_video_detection_tpu_torch.ops import yuv as Y


def test_fused_normalize_plain_matches_pallas_interpret():
    x = np.random.default_rng(0).integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    ref = np.asarray(jax_fused_normalize(jnp.asarray(x), out_dtype=jnp.float32,
                                         interpret=True))
    got = P.fused_normalize(torch.from_numpy(x), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_fused_normalize_odd_shape_matches_imagenet_normalize():
    # 5*7*9*3 elements: not a multiple of the TPU kernel's 128 lanes
    x = np.random.default_rng(1).integers(0, 256, (5, 7, 9, 3), dtype=np.uint8)
    ref = np.asarray(jax_imagenet_normalize(jnp.asarray(x)))
    got = P.fused_normalize(torch.from_numpy(x), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the port's own plain imagenet_normalize agrees too
    np.testing.assert_allclose(imagenet_normalize(torch.from_numpy(x)).numpy(),
                               ref, atol=1e-6)
    # bf16 output is the f32 result rounded once
    bf = P.fused_normalize(torch.from_numpy(x))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 3), np.float32)])
def test_fused_normalize_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        P.fused_normalize(torch.from_numpy(bad))
    with pytest.raises(ValueError):
        P.fused_normalize(torch.zeros((2, 3), dtype=torch.uint8),
                          out_dtype=torch.float16)


@pytest.mark.parametrize("n", [64, 197, 640, 641, 1025])
def test_flash_plain_matches_pallas_interpret(n):
    """N = 64 and 197 land in the short-N kernel (n_pad ≤ 512, K2), N = 640
    and up in the streaming kernel (K3): 641 is the long-clip training
    shape (640 frames + cls), 1025 the evaluation one."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_out = np.asarray(jax_flash(jq, jk, jv, interpret=True))
    ref_lse = np.asarray(_flash_impl(jq, jk, jv, interpret=True)[1])[..., 0]
    out, lse = A.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert out.shape == (1, 2, n, 64) and lse.shape == (1, 2, n)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5)
    np.testing.assert_allclose(
        A.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
        ref_out, atol=2e-5)


@pytest.mark.parametrize("n", [64, 197, 640, 641, 1025])
def test_flash_attention_grad_matches_pallas_interpret(n):
    """The port's autograd Function (the plain backward on the CPU) vs
    ``jax.grad`` through the Pallas backward in interpret mode: N = 64 and
    197 reach the short-N kernel (K4), N = 640 and up the two streaming
    passes (K5, K6). f32, the JAX suite's gradient tolerance."""
    rng = np.random.default_rng(100 + n)
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32) for _ in range(3))
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v, interpret=True) ** 2),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(torch.sum(A.flash_attention(tq, tk, tv) ** 2),
                              (tq, tk, tv))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3, rtol=2e-3)


def test_flash_bwd_plain_takes_strided_dout():
    """dO as autograd hands it back through the head merge: a (B, H, N, d)
    view of a (B, N, H*d) gradient."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 20, 8)).astype(np.float32))
               for _ in range(3))
    out, lse = A.flash_attention_fwd(q, k, v)
    g = torch.from_numpy(rng.normal(size=(2, 20, 24)).astype(np.float32))
    dout = g.view(2, 20, 3, 8).transpose(1, 2)
    assert not dout.is_contiguous()
    got = A.flash_attention_bwd(q, k, v, out, lse, dout)
    ref = A.flash_attention_bwd_plain(q, k, v, out, lse, dout.contiguous())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        A.flash_attention_bwd(q, k, v, out, lse[:, :, :5], dout)


def test_flash_plain_takes_strided_qkv_views():
    """The views multi_head_attention cuts from a fused QKV buffer."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3, 4, 16)).astype(np.float32))
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous()
    out, lse = A.flash_attention_fwd(q, k, v)
    ref, ref_lse = A.flash_attention_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-6)


def test_flash_rejects_mismatched_inputs():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, q[:, :, :4], q)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, q.to(torch.bfloat16), q)


def test_yuv420_packed_to_rgb_matches_jax():
    h = w = 16
    packed = np.random.default_rng(4).integers(0, 256, (2, 3, h * w * 3 // 2),
                                               dtype=np.uint8)
    ref = np.asarray(jax_yuv_to_rgb(jnp.asarray(packed), h, w))
    got = Y.yuv420_packed_to_rgb(torch.from_numpy(packed), h, w)
    assert got.shape == (2, 3, h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 1, 6, 10)])
def test_fused_normalize_yuv_plain_matches_jax(shape):
    """The YUV entry's plain version, as a function of the packed bytes,
    against the JAX serving forward's arithmetic: ``yuv420_packed_to_rgb``
    then ``imagenet_normalize(rgb / 255, scaled=True)``."""
    B, T, H, W = shape
    x = np.random.default_rng(H).integers(0, 256, (B, T, H * W * 3 // 2), dtype=np.uint8)
    rgb = jax_yuv_to_rgb(jnp.asarray(x), H, W)
    ref = np.asarray(jax_imagenet_normalize(rgb / 255.0, scaled=True))
    got = P.fused_normalize_yuv(torch.from_numpy(x), H, W, out_dtype=torch.float32)
    assert got.shape == (B, T, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    bf = P.fused_normalize_yuv(torch.from_numpy(x), H, W)       # bf16 by default
    np.testing.assert_array_equal(bf.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def test_fused_normalize_yuv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 6 * 10 * 3 // 2), dtype=torch.uint8)
    for bad in [dict(height=5, width=12), dict(height=6, width=9),    # odd H or W
                dict(height=6, width=12)]:                            # wrong last axis
        with pytest.raises(ValueError):
            P.fused_normalize_yuv(x, **bad)
    with pytest.raises(ValueError):
        P.fused_normalize_yuv(x.float(), 6, 10)
    with pytest.raises(ValueError):
        P.fused_normalize_yuv(x, 6, 10, out_dtype=torch.float16)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc → the build raises; there is no fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not list(tmp_path.iterdir())


def test_kernel_libraries_are_named_by_source_hash():
    paths = {s: _build.library_path(s) for s in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for src, p in paths.items():
        assert (_build.CSRC_DIR / src).exists()
        assert p.parent == _build.BUILD_DIR and p.name.startswith("lib")


# the split policy of the bf16 kernels at N > 512 (ops/attention.py::_long_splits)

@pytest.mark.parametrize("shape,bf16", [
    ((128, 12, 197, 64), True),                   # ViT-B/16 training
    ((8, 12, 197, 64), True),                     # ViT-B/16 serving
    ((1, 1, 512, 64), True),                      # the last short-N length
    ((16, 12, 1, 64), True),
    ((2, 4, 1025, 64), False),                    # f32 at N > 512
    ((1, 4, 641, 64), False),
])
def test_split_policy_keeps_short_n_and_f32_unsplit(shape, bf16):
    assert A._long_splits(*shape, bf16=bf16) == (1, 1)


@pytest.mark.parametrize("shape", [(2, 4, 1025, 64), (1, 4, 641, 64)])
def test_split_policy_splits_the_long_clip_shapes(shape):
    """The temporal transformer's evaluation (N = 1025) and training
    (N = 641) calls: 4 heads per clip leave most of the card idle unsplit,
    so the forward splits both. The backward splits the training call (its
    one backward); at N = 1025 its unsplit grid of 136 blocks reads fastest
    on the card (the backward sweep, PERF.md)."""
    s_fwd, s_bwd = A._long_splits(*shape)
    assert s_fwd > 1
    assert (s_bwd > 1) == (shape[2] == 641)


@pytest.mark.parametrize("shape,split", [
    ((2, 12, 640, 64), False),      # the K5/K6 regime at 12 heads: 240 blocks unsplit
    ((1, 4, 4097, 64), False),      # a clip of minutes: 260 blocks unsplit
    ((1, 4, 641, 64), True),        # long-clip training: 44 blocks unsplit
    ((2, 4, 513, 64), True),        # the first split shape: 72 blocks unsplit
])
def test_split_policy_follows_the_backward_sweep(shape, split):
    """The bf16 backward takes S = 1 where its sweep on the card read S = 1
    fastest (the unsplit grid nearly fills the card: a split adds waves and
    three f32 partial planes), and S >= 2 where the split still wins."""
    s_bwd = A._long_splits(*shape)[1]
    assert (s_bwd > 1) == split
    times = {s: A._bwd_us(*shape, s) for s in range(1, 9)}
    assert times[s_bwd] == min(times.values())


@pytest.mark.parametrize("shape", [
    (2, 4, 1025, 64), (1, 4, 641, 64), (2, 4, 513, 64), (1, 4, 4097, 64),
    (2, 12, 640, 64), (1, 1, 700, 256), (3, 2, 2000, 36), (1, 4, 65536, 64),
    (1, 4, 1025, 128), (1, 2, 700, 192),
])
def test_split_policy_keeps_two_tiles_per_split_and_no_split_past_n(shape):
    """The kernels give split s the streamed tiles [s T / S, (s + 1) T / S)
    (the forward's key tiles of ``_fwd_key_tile``, the backward's of
    ``_bwd_tile``): each split keeps at least 2 tiles, and each starts below
    N."""
    B, H, N, d = shape
    fwd_tile = A._fwd_key_tile(d)
    assert fwd_tile == (64 if d <= 128 else 32)
    for splits, tile in zip(A._long_splits(*shape), (fwd_tile, A._bwd_tile(d))):
        tiles = -(-N // tile)
        bounds = [s * tiles // splits for s in range(splits + 1)]
        assert splits >= 1
        assert all(hi - lo >= 2 for lo, hi in zip(bounds, bounds[1:])) or splits == 1
        assert all(lo * tile < N for lo in bounds[:-1]) and bounds[-1] == tiles


def test_split_policy_is_a_function_of_the_shape():
    """The same shape always gets the same S, so reruns are bit-identical."""
    shapes = [(2, 4, 1025, 64), (1, 4, 641, 64), (1, 4, 4097, 64)]
    first = [A._long_splits(*s) for s in shapes]
    assert [A._long_splits(*s) for s in reversed(shapes)][::-1] == first
    assert [A._long_splits(*s) for s in shapes] == first


@pytest.mark.parametrize("shape", [(1, 4, 65536, 64), (2, 4, 1025, 64), (1, 4, 4097, 256)])
def test_split_scratch_stays_under_its_cap(shape):
    B, H, N, d = shape
    s_fwd, s_bwd = A._long_splits(*shape)
    assert s_fwd * B * H * N * (d + 1) * 4 <= A._SPLIT_SCRATCH_CAP
    assert 3 * s_bwd * B * H * N * d * 4 <= A._SPLIT_SCRATCH_CAP

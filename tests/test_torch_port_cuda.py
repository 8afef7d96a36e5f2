"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``. Whether a card is present is decided inside each test, so
every worker collects the same tests; without one they skip. On a machine
with a card and ``nvcc``:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from deepfake_video_detection_tpu_torch.ops import attention as A
from deepfake_video_detection_tpu_torch.ops import preprocess as P

pytestmark = pytest.mark.cuda


def _cuda_generator() -> torch.Generator:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((2, 8, 224, 224, 3), torch.bfloat16, 0),
    ((2, 8, 224, 224, 3), torch.float32, 0),
    ((3, 37, 41, 3), torch.bfloat16, 0),          # not a multiple of 16 or 128
    ((5, 7, 3), torch.float32, 1),                # not 16-byte aligned
])
def test_fused_normalize_kernel_matches_plain(shape, dtype, offset):
    gen = _cuda_generator()
    n = int(np.prod(shape))
    buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    x = buf[offset:].view(shape)
    before = P.fused_normalize.launches
    got = P.fused_normalize(x, dtype)
    assert P.fused_normalize.launches == before + 1
    ref = P.fused_normalize_plain(x, dtype)
    tol = 1.6e-2 if dtype == torch.bfloat16 else 1e-6
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape,dtype", [
    ((16, 8, 224, 224), torch.bfloat16),          # the serving forward's largest bucket
    ((16, 8, 224, 224), torch.float32),
    ((3, 5, 224, 224), torch.bfloat16),           # an odd-sized batch
    ((2, 3, 6, 10), torch.float32),               # a row of 5 pairs: pairs straddle rows
])
def test_fused_normalize_yuv_kernel_matches_plain(shape, dtype):
    gen = _cuda_generator()
    B, T, H, W = shape
    x = torch.randint(0, 256, (B, T, H * W * 3 // 2), dtype=torch.uint8, device="cuda",
                      generator=gen)
    before = P.fused_normalize_yuv.launches
    got = P.fused_normalize_yuv(x, H, W, dtype)
    assert P.fused_normalize_yuv.launches == before + 1
    ref = P.fused_normalize_yuv_plain(x, H, W, dtype)
    assert got.dtype == dtype and got.shape == (B, T, H, W, 3)
    err = float((got.float() - ref.float()).abs().max())
    tol = 2e-2 * float(ref.float().abs().max()) if dtype == torch.bfloat16 else 1e-4
    assert err <= tol
    with pytest.raises(ValueError):
        P.fused_normalize_yuv(x, H + 1, W, dtype)                # odd H
    with pytest.raises(ValueError):
        P.fused_normalize_yuv(x[..., 1:], H, W, dtype)           # wrong last axis


@pytest.mark.parametrize("B,H,N,d,dtype,strided", [
    (8, 12, 197, 64, torch.bfloat16, True),       # ViT-B/16, one request
    (8, 12, 197, 64, torch.float32, False),
    (2, 12, 640, 64, torch.bfloat16, False),      # the streaming (K3) regime
    (2, 4, 1025, 64, torch.bfloat16, True),       # long-clip evaluation, 1024 frames
    (1, 4, 641, 64, torch.bfloat16, True),        # long-clip training, 640 frames
    (4, 6, 197, 32, torch.float32, False),
    (16, 12, 1, 64, torch.bfloat16, False),
    (2, 4, 130, 256, torch.float32, False),
    (2, 4, 100, 80, torch.bfloat16, True),
    (2, 3, 77, 36, torch.bfloat16, False),        # d not a multiple of 8: padded copy
    (4, 12, 256, 64, torch.bfloat16, False),      # N a multiple of the tile
    (128, 12, 197, 64, torch.bfloat16, True),     # ViT-B/16 training, 8 x 16 frames
    (2, 4, 130, 256, torch.bfloat16, False),
    (3, 2, 17, 128, torch.bfloat16, False),
    (2, 3, 77, 30, torch.float32, False),         # f32 d not a multiple of 4: padded copy
    (16, 12, 1, 64, torch.float32, False),
    (1, 4, 4097, 64, torch.float32, True),        # f32 at long N: unsplit
    (128, 12, 197, 64, torch.float32, True),      # f32 ViT-B/16 step, 8 x 16 frames
    (128, 3, 197, 64, torch.float32, True),       # the training CLI's default: vit_gcn
    (16, 3, 197, 64, torch.bfloat16, True),       # vit_gcn serving, 16 frames
    (16, 6, 197, 64, torch.float32, True),        # the ViT-GNN CLIs, 16 images
    (8, 4, 17, 64, torch.float32, True),          # --model temporal over B0, 8 x 16 frames
    (8, 4, 17, 64, torch.bfloat16, True),         # the same with --bf16
    (2, 4, 300, 128, torch.bfloat16, True),       # d = 128: two 64-column boxes a tile
    (1, 2, 700, 256, torch.bfloat16, True),       # d = 256: 32-key tiles, split
])
def test_flash_kernel_matches_plain(B, H, N, d, dtype, strided):
    gen = _cuda_generator()
    if strided:
        qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn((B, H, N, d), device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
    f = A.flash_attention_fwd
    before = (f.launches, f.launches_long, f.launches_f32, f.launches_split)
    out, lse = A.flash_attention_fwd(q, k, v)
    f32 = dtype == torch.float32
    assert (f.launches, f.launches_long, f.launches_f32) == (
        before[0] + 1, before[1] + (N > 512), before[2] + f32)
    if f32:                                       # f32 has no split route
        assert f.launches_split == before[3]
    ref, ref_lse = A.flash_attention_plain(q, k, v)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert out.shape == (B, H, N, d) and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-3


def _bwd_inputs(gen, B, H, N, d, dtype, strided):
    """q, k, v (strided views of one QKV buffer when ``strided``), the
    forward's out and lse, and dO as the (B, H, N, d) view of a (B, N, H*d)
    gradient, as the head merge of multi_head_attention hands it back."""
    if strided:
        qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn((B, H, N, d), device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
    out, lse = A.flash_attention_plain(q, k, v)
    dout = torch.randn((B, N, H * d), device="cuda", generator=gen).to(dtype)
    dout = dout.view(B, N, H, d).transpose(1, 2)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("B,H,N,d,dtype,strided", [
    (16, 12, 197, 64, torch.bfloat16, True),      # ViT-B/16 training, 1 clip
    (8, 12, 197, 64, torch.float32, False),
    (2, 12, 640, 64, torch.bfloat16, False),      # the K5/K6 regime, n_pad > 512
    (1, 4, 641, 64, torch.bfloat16, True),        # long-clip training, 640 frames
    (2, 4, 1025, 64, torch.bfloat16, True),       # a longer clip, 1024 frames
    (16, 12, 1, 64, torch.bfloat16, False),
    (4, 6, 197, 32, torch.float32, False),
    (2, 4, 130, 256, torch.float32, False),
    (2, 4, 100, 80, torch.bfloat16, True),
    (2, 3, 77, 36, torch.bfloat16, False),        # d not a multiple of 8: padded copy
    (4, 12, 256, 64, torch.bfloat16, False),      # N a multiple of the tile
    (128, 12, 197, 64, torch.bfloat16, True),     # ViT-B/16 training, 8 x 16 frames
    (2, 4, 130, 256, torch.bfloat16, False),
    (3, 2, 17, 128, torch.bfloat16, False),
    (2, 3, 77, 30, torch.float32, False),         # f32 d not a multiple of 4: padded copy
    (16, 12, 1, 64, torch.float32, False),
    (1, 4, 4097, 64, torch.float32, True),        # f32 at long N: unsplit
    (128, 12, 197, 64, torch.float32, True),      # f32 ViT-B/16 step, 8 x 16 frames
    (128, 3, 197, 64, torch.float32, True),       # the training CLI's default: vit_gcn
    (16, 6, 197, 64, torch.float32, True),        # the ViT-GNN trainer, 16 images
    (8, 4, 17, 64, torch.float32, True),          # --model temporal over B0, 8 x 16 frames
    (8, 4, 17, 64, torch.bfloat16, True),         # the same with --bf16
])
def test_flash_bwd_kernel_matches_plain(B, H, N, d, dtype, strided):
    gen = _cuda_generator()
    q, k, v, out, lse, dout = _bwd_inputs(gen, B, H, N, d, dtype, strided)
    f = A.flash_attention_bwd
    before = (f.launches, f.launches_long, f.launches_f32, f.launches_split)
    got = A.flash_attention_bwd(q, k, v, out, lse, dout)
    f32 = dtype == torch.float32
    assert (f.launches, f.launches_long, f.launches_f32) == (
        before[0] + 1, before[1] + (N > 512), before[2] + f32)
    if f32:                                       # f32 has no split route
        assert f.launches_split == before[3]
    ref = A.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for g, r in zip(got, ref):
        assert g.shape == (B, H, N, d) and g.dtype == dtype
        err = float((g.float() - r.float()).abs().max())
        if dtype == torch.bfloat16:
            # relative to the largest |value|; at N = 1 dQ and dK are 0 in
            # exact arithmetic (P = 1, dP = D) and both sides hold f32
            # rounding residue of ~1e-6, hence the absolute floor
            assert err <= max(2e-2 * float(r.float().abs().max()), 1e-4)
        else:                           # the JAX suite's gradient tolerance
            assert torch.allclose(g, r, atol=1e-3, rtol=1e-3), err


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 150, 64), torch.float32),             # the 3xTF32 kernels
    ((16, 12, 197, 64), torch.float32),           # the 3xTF32 kernels, ViT-B/16 training
    ((1, 4, 4097, 64), torch.float32),            # the 3xTF32 kernels at long N, unsplit
    ((16, 12, 197, 64), torch.bfloat16),          # the bf16 kernels
    ((1, 4, 641, 64), torch.bfloat16),            # the split route, long-clip training
])
def test_flash_kernel_is_differentiable_and_deterministic(shape, dtype):
    """The autograd Function runs the forward and backward kernels; a
    second backward on the same inputs agrees bit for bit (no atomics)."""
    gen = _cuda_generator()
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               .requires_grad_() for _ in range(3))
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    f0, b0 = A.flash_attention_fwd.launches, A.flash_attention_bwd.launches
    grads = torch.autograd.grad((A.flash_attention(q, k, v) * g).sum(), (q, k, v))
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    again = torch.autograd.grad((A.flash_attention(q, k, v) * g).sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
    out, _ = A.flash_attention_plain(qd, kd, vd)
    ref = torch.autograd.grad((out * g).sum(), (qd, kd, vd))
    for a, r in zip(grads, ref):
        if dtype == torch.bfloat16:             # relative to the largest |value|
            err = float((a.float() - r.float()).abs().max())
            assert err <= 2e-2 * float(r.float().abs().max())
        else:
            assert torch.allclose(a, r, atol=1e-3, rtol=1e-3)


def test_f32_kernels_propagate_nan():
    """A NaN made by the card's arithmetic (0x7fffffff, which rounding to
    nearest by integer operations would turn into -0) in one query row: the
    3xTF32 kernels give O and the gradients NaN exactly where the plain
    versions do. (lse of that row stays finite in both dtypes' kernels: l is
    guarded by fmaxf(l, 1e-30), which drops a NaN.)"""
    gen = _cuda_generator()
    q, k, v, _, _, dout = _bwd_inputs(gen, 2, 3, 150, 64, torch.float32, False)
    q = q.clone()
    q[0, 1, 5, 3] = torch.zeros((), device="cuda") / 0
    out, lse = A.flash_attention_fwd(q, k, v)
    ref, _ = A.flash_attention_plain(q, k, v)
    assert bool(out[0, 1, 5].isnan().all()) and torch.equal(out.isnan(), ref.isnan())
    got = A.flash_attention_bwd(q, k, v, out, lse, dout)
    for g, r in zip(got, A.flash_attention_bwd_plain(q, k, v, out, lse, dout)):
        assert torch.equal(g.isnan(), r.isnan())
        assert bool(g.isnan().any())


@pytest.mark.parametrize("B,H,N,d,splits", [
    (4, 4, 641, 64, (2, 1)),                      # S divides neither pass's 11 tiles
    (1, 4, 1025, 64, (5, 3)),                     # a 1024-frame clip
    (1, 4, 4097, 64, (3, 1)),                     # a clip of minutes
    (1, 4, 1025, 128, (3, 3)),                    # d = 128
    (1, 2, 700, 256, (6, 3)),                     # d = 256: 32-key forward tiles
])
def test_flash_split_route_matches_plain(B, H, N, d, splits, monkeypatch):
    """bf16 at N > 512: the policy's S (``_long_splits``: the forward
    splits each of these, the backward where its modelled device time says
    so), then the split kernels forced (the backward's S at least 2) so that
    each shape runs them; at N = 641 and 1025 S does not divide the streamed
    tiles, so the splits are uneven. Forward and backward against the plain
    versions, and a rerun of the backward bit-identical."""
    gen = _cuda_generator()
    assert A._long_splits(B, H, N, d) == splits
    s_fwd, s_bwd = splits[0], max(2, splits[1])
    monkeypatch.setattr(A, "_long_splits", lambda *_: (s_fwd, s_bwd))
    if N < 4096:
        assert -(-N // A._fwd_key_tile(d)) % s_fwd and -(-N // A._bwd_tile(d)) % s_bwd
    q, k, v, _, _, dout = _bwd_inputs(gen, B, H, N, d, torch.bfloat16, True)
    f0, b0 = A.flash_attention_fwd.launches_split, A.flash_attention_bwd.launches_split
    out, lse = A.flash_attention_fwd(q, k, v)
    ref, ref_lse = A.flash_attention_plain(q, k, v)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    got = A.flash_attention_bwd(q, k, v, out, lse, dout)
    again = A.flash_attention_bwd(q, k, v, out, lse, dout)
    assert (A.flash_attention_fwd.launches_split, A.flash_attention_bwd.launches_split) == (
        f0 + 1, b0 + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, r in zip(got, A.flash_attention_bwd_plain(q, k, v, out, lse, dout)):
        assert float((g.float() - r.float()).abs().max()) <= 2e-2 * float(r.float().abs().max())


def _one_key_input_sets(gen, B, H, N, d, dtype):
    """Four sets of q, k, v and dO of one launch key: the views of two fused
    QKV buffers, and of the two halves of a third one (views at two offsets
    of one buffer); dO the head-merge view of a gradient buffer."""
    def fused(qkv):
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)

    one = B * N * 3 * H * d
    halves = torch.randn(2 * one, device="cuda", generator=gen).to(dtype)
    qkvs = [torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dtype)
            for _ in range(2)] + [halves[i * one:(i + 1) * one].view(B, N, 3, H, d)
                                  for i in range(2)]
    sets = []
    for qkv in qkvs:
        dout = torch.randn((B, N, H * d), device="cuda", generator=gen).to(dtype)
        sets.append((*fused(qkv), dout.view(B, N, H, d).transpose(1, 2)))
    return sets


def _flash_calls(sets, rounds=2):
    """Forward and backward on each set in turn, ``rounds`` times; returns
    the last round's (O, lse, dQ, dK, dV) of each set."""
    for _ in range(rounds):
        res = []
        for q, k, v, dout in sets:
            out, lse = A.flash_attention_fwd(q, k, v)
            res.append((out, lse, *A.flash_attention_bwd(q, k, v, out, lse, dout)))
    torch.cuda.synchronize()
    return res


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 197, 64), torch.bfloat16),            # the unsplit kernels
    ((1, 4, 641, 64), torch.bfloat16),            # the split route: partials, combine, reduce
    ((2, 4, 197, 64), torch.float32),             # the 3xTF32 kernels
    ((2, 3, 77, 36), torch.bfloat16),             # the padded copies' maps
])
def test_cached_tensor_maps_follow_each_calls_addresses(shape, dtype):
    """Calls alternate between four input sets of one launch key, so every
    call reuses the key's plan and its cached tensor maps, given that call's
    addresses (a stale address would read another set's data): each result
    within the plain version's gate, and bit-identical to the same call
    after the launch caches are cleared and every map is encoded anew."""
    gen = _cuda_generator()
    sets = _one_key_input_sets(gen, *shape, dtype)
    A._clear_launch_caches()
    got = _flash_calls(sets)
    assert len(A._FWD_PLANS) == len(A._BWD_PLANS) == 1
    bf16 = dtype == torch.bfloat16
    for (q, k, v, dout), res in zip(sets, got):
        ref, ref_lse = A.flash_attention_plain(q, k, v)
        err = float((res[0].float() - ref.float()).abs().max())
        assert err <= (2e-2 * float(ref.float().abs().max()) if bf16 else 1e-4)
        assert float((res[1] - ref_lse).abs().max()) <= 1e-3
        for g, r in zip(res[2:], A.flash_attention_bwd_plain(q, k, v, res[0], res[1], dout)):
            if bf16:
                err = float((g.float() - r.float()).abs().max())
                assert err <= max(2e-2 * float(r.float().abs().max()), 1e-4)
            else:
                assert torch.allclose(g, r, atol=1e-3, rtol=1e-3)
    A._clear_launch_caches()
    fresh = [_flash_calls([s], rounds=1)[0] for s in sets]
    for a, b in zip(got, fresh):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cached_launches_from_two_threads_on_two_cards():
    """Serving replicas launch from a thread a card: two threads, one on
    each of two cards, alternate between input sets of one shape; every
    result is bit-identical to the same call made alone on its card."""
    _cuda_generator()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import threading

    results, errors = {}, []

    def replica(i):
        try:
            with torch.cuda.device(i):
                gen = torch.Generator(device=f"cuda:{i}").manual_seed(i)
                sets = _one_key_input_sets(gen, 8, 12, 197, 64, torch.bfloat16)
                alone = [_flash_calls([s], rounds=1)[0] for s in sets]
                barrier.wait()
                results[i] = (alone, _flash_calls(sets, rounds=20))
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)
            barrier.abort()

    barrier = threading.Barrier(2)
    threads = [threading.Thread(target=replica, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for alone, together in results.values():
        for a, b in zip(alone, together):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_vit_shapes_take_the_unsplit_kernels():
    """N <= 512 (the ViT-B/16 blocks) runs the unsplit tensor-core kernels."""
    gen = _cuda_generator()
    assert A._long_splits(128, 12, 197, 64) == (1, 1)
    q, k, v, _, _, dout = _bwd_inputs(gen, 128, 12, 197, 64, torch.bfloat16, True)
    f0, b0 = A.flash_attention_fwd.launches_split, A.flash_attention_bwd.launches_split
    out, lse = A.flash_attention_fwd(q, k, v)
    A.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (A.flash_attention_fwd.launches_split, A.flash_attention_bwd.launches_split) == (
        f0, b0)


def test_flash_kernel_rejects_what_it_does_not_take():
    gen = _cuda_generator()
    q = torch.randn((1, 2, 8, 300), device="cuda", generator=gen)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, q, q)                  # d > 256
    q = torch.randn((1, 2, 16, 8), device="cuda", generator=gen).transpose(-1, -2)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, q, q)                  # last axis strided


def test_small_detector_on_cuda_matches_plain_versions():
    """A two-block ViT-Tiny detector: kernels vs the plain versions."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer

    gen = _cuda_generator()
    model = BackboneDetector("vit_tiny_patch16_224", device="cuda")
    model.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=64, depth=2,
                                       device="cuda")
    x = torch.randint(0, 256, (2, 3, 64, 64, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    with torch.no_grad():
        logits, _ = model(P.fused_normalize(x, torch.float32))
        with mock.patch.object(A, "flash_attention",
                               lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
            ref, _ = model(P.fused_normalize_plain(x, torch.float32))
    assert float((logits - ref).abs().max()) <= 1e-3


def test_frame_graph_detector_on_cuda_matches_plain_versions():
    """A two-block ViT-Tiny + GCN at 64 px, f32: logits and one backward's
    gradients through the f32 flash kernels vs the plain versions."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
    from deepfake_video_detection_tpu_torch.utils.graph import (
        chain_adjacency, normalize_adjacency)

    gen = _cuda_generator()
    model = FrameGraphDetector(vit_variant="vit_tiny_patch16_224", img_size=64,
                               device="cuda")
    model.vit = VisionTransformer("vit_tiny_patch16_224", img_size=64, depth=2,
                                  device="cuda")
    x = torch.randn((2, 4, 64, 64, 3), device="cuda", generator=gen)
    adj = normalize_adjacency(chain_adjacency(4)).cuda().expand(2, 4, 4)
    params = list(model.parameters())

    def run():
        logits = model(x, adj)
        return logits, torch.autograd.grad(logits.square().sum(), params)

    before = (A.flash_attention_fwd.launches_f32, A.flash_attention_bwd.launches_f32)
    logits, grads = run()
    assert (A.flash_attention_fwd.launches_f32, A.flash_attention_bwd.launches_f32) == (
        before[0] + 2, before[1] + 2)
    with mock.patch.object(A, "flash_attention",
                           lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
        ref, ref_grads = run()
    assert float((logits - ref).detach().abs().max()) <= 1e-3
    for g, r in zip(grads, ref_grads):
        assert torch.allclose(g, r, atol=1e-3, rtol=1e-3)


def test_long_clip_temporal_model_on_cuda_matches_plain_versions():
    """A small tinyconv temporal model at T = 640 (N = 641): one step's loss
    and gradients through the streaming-regime kernels vs the plain
    versions, and the launch counts of that regime."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)

    gen = _cuda_generator()
    model = TemporalTransformerDetector("tinyconv", d_model=64, depth=2, num_heads=2,
                                        dropout_rate=0.0, device="cuda")
    x = torch.randn((1, 640, 16, 16, 3), device="cuda", generator=gen)
    params = list(model.parameters())

    def loss_and_grads():
        logits, _ = model(x, train=True)
        loss = torch.nn.functional.cross_entropy(logits, torch.tensor([1], device="cuda"))
        return loss, torch.autograd.grad(loss, params, allow_unused=True)

    f0, b0 = A.flash_attention_fwd.launches_long, A.flash_attention_bwd.launches_long
    loss, grads = loss_and_grads()
    assert (A.flash_attention_fwd.launches_long, A.flash_attention_bwd.launches_long) == (
        f0 + 2, b0 + 2)
    with mock.patch.object(A, "flash_attention",
                           lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
        ref_loss, ref_grads = loss_and_grads()
    assert abs(float(loss) - float(ref_loss)) <= 1e-4
    for g, r in zip(grads, ref_grads):
        if r is not None:
            assert torch.allclose(g, r, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("backbones", [("efficientnet_b0",), ("efficientnet_b0", "resnet18")])
def test_convnet_serving_forward_on_cuda_matches_plain_versions(backbones, monkeypatch):
    """B0 and the B0 + resnet18 ensemble at 64 px, f32 on the card, BN
    stats drawn from U(0.5, 1.5): the serving forwards (K1's RGB and YUV
    entries, cuDNN convs) against the plain normalisations on the same
    model."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import (
        BackboneDetector, EnsembleDetector)
    from deepfake_video_detection_tpu_torch.serve.predict import make_forward_fns

    gen = _cuda_generator()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = (BackboneDetector(backbones[0], device="cuda") if len(backbones) == 1
             else EnsembleDetector(backbones, device="cuda")).eval()
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5, generator=gen)
    fwd, fwd_yuv = make_forward_fns(model, len(backbones) > 1, 64)
    x = torch.randint(0, 256, (2, 3, 64, 64, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    packed = torch.randint(0, 256, (2, 3, 64 * 64 * 3 // 2), dtype=torch.uint8,
                           device="cuda", generator=gen)
    k1, k1y = P.fused_normalize.launches, P.fused_normalize_yuv.launches
    probs, _, _, members = fwd(x)
    probs_yuv = fwd_yuv(packed)[0]
    assert (P.fused_normalize.launches, P.fused_normalize_yuv.launches) == (k1 + 1, k1y + 1)
    assert (members is None) == (len(backbones) == 1)
    with torch.no_grad():
        ref = torch.softmax(model(P.fused_normalize_plain(x, torch.float32))[0], -1)
        ref_yuv = torch.softmax(model(P.fused_normalize_yuv_plain(
            packed, 64, 64, torch.float32))[0], -1)
    assert float((probs - ref).abs().max()) <= 1e-4
    assert float((probs_yuv - ref_yuv).abs().max()) <= 1e-4


@pytest.mark.parametrize("tf32", [False, True])
def test_b0_train_step_on_cuda_matches_cpu(tf32, monkeypatch):
    """One B0 step (2 clips x 4 frames at 224 px, SGD with a clip of 1.0
    that bites, no dropout or drop-path draws) on the card and on the CPU
    from the same weights and batch: loss, grad norm and every BN running
    stat within chip_smoke.py's CPU_TOL for the card's cuDNN TF32 flag."""
    import copy

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.train import losses, optim, steps
    from deepfake_video_detection_tpu_torch.train.state import TrainState

    _cuda_generator()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    tol = ({"loss": 1e-2, "grad_norm": 5e-2, "bn_stats": 5e-2} if tf32
           else {"loss": 1e-4, "grad_norm": 1e-3, "bn_stats": 1e-3})
    cpu = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    cpu.backbone.drop_path_rate = 0.0
    card = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(4)
    batch = {"frames": torch.from_numpy(rng.normal(size=(2, 4, 224, 224, 3))
                                        .astype(np.float32)),
             "labels": torch.tensor([0, 1]), "valid": torch.ones(2, dtype=torch.bool)}

    def run(model, dev):
        opt = optim.build_optimizer("sgd", 0.5, grad_clip=1.0)
        step = steps.make_train_step(model, opt, losses.cross_entropy_loss)
        _, m = step(TrainState.create(model, opt), {k: v.to(dev) for k, v in batch.items()})
        return float(m["loss"]), float(m["grad_norm"]), {
            k: v.detach().cpu().double() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}

    loss_c, norm_c, stats_c = run(cpu, "cpu")
    loss_g, norm_g, stats_g = run(card, "cuda")
    assert norm_c > 1.0
    assert abs(loss_g - loss_c) <= tol["loss"] * abs(loss_c)
    assert abs(norm_g - norm_c) <= tol["grad_norm"] * norm_c
    for k, mean in stats_c.items():     # a mean by the channel's std, a variance by itself
        if k.endswith("running_mean"):
            var = stats_c[k[:-len("mean")] + "var"]
            assert float(((stats_g[k] - mean).abs() / var.sqrt()).max()) <= tol["bn_stats"], k
            assert float(((stats_g[k[:-len("mean")] + "var"] - var).abs() / var).max()) \
                <= tol["bn_stats"], k


def test_flash_bwd_at_the_explain_shape_through_an_input_gradient():
    """K4-bf16 at (8, 12, 197, 64), reached as an explain request reaches
    it: the gradient of a bf16 attention block's output for its input
    alone, q/k/v strided views of one QKV projection, against the plain
    versions within 2e-2 of max |ref|."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.nn import layers as L

    gen = _cuda_generator()
    B, N, H, d = 8, 197, 12, 64
    C = H * d
    x = torch.randn((B, N, C), device="cuda", generator=gen).to(torch.bfloat16)
    w_qkv = torch.randn((3 * C, C), device="cuda", generator=gen) / C ** 0.5
    w_proj = torch.randn((C, C), device="cuda", generator=gen) / C ** 0.5

    def input_grad():
        leaf = x.detach().requires_grad_()
        y = L.multi_head_attention(leaf, w_qkv, None, w_proj, None, H)
        return torch.autograd.grad(y.float().square().sum(), leaf)[0]

    f0, b0 = A.flash_attention_fwd.launches, A.flash_attention_bwd.launches
    got = input_grad()
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    assert all(p.grad is None for p in (w_qkv, w_proj))
    with mock.patch.object(A, "flash_attention",
                           lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
        ref = input_grad()
    assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())


@pytest.mark.parametrize("backbone", ["vit_base_patch16_224", "efficientnet_b0"])
def test_saliency_on_cuda_matches_plain_versions(backbone, monkeypatch):
    """Full-size ViT-B/16 and B0 detectors serving in bf16, 8 crops of 224
    px: the saliency grids through K1 (f32 out), K2 and K4 against the
    plain versions within chip_smoke.py's bf16 gate (5e-2), max-normalised,
    with the launches an explanation makes."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve import saliency

    gen = _cuda_generator()
    import chip_smoke

    model = BackboneDetector(backbone, compute_dtype=torch.bfloat16, device="cuda").eval()
    chip_smoke._input_sensitive(torch, model, 0)    # a B0 at its init has no input gradient
    x = torch.randint(0, 256, (1, 8, 224, 224, 3), dtype=torch.uint8, device="cuda",
                      generator=gen)
    fn = saliency.make_saliency_fn(model, fake_idx=1)
    depth = len(getattr(model.backbone, "blocks", ())) if backbone.startswith("vit") else 0
    counts = (P.fused_normalize.launches, A.flash_attention_fwd.launches,
              A.flash_attention_bwd.launches)
    got = fn(x)
    assert (P.fused_normalize.launches, A.flash_attention_fwd.launches,
            A.flash_attention_bwd.launches) == (counts[0] + 1, counts[1] + depth,
                                                counts[2] + depth)
    monkeypatch.setattr(saliency, "fused_normalize", P.fused_normalize_plain)
    monkeypatch.setattr(A, "flash_attention",
                        lambda q, k, v: A.flash_attention_plain(q, k, v)[0])
    ref = fn(x)
    assert got.shape == (1, 8, 14, 14) and bool(torch.isfinite(got).all())
    assert torch.allclose(got.amax(dim=(2, 3)), torch.ones(1, 8, device="cuda"))
    assert float((got - ref).abs().max()) <= 5e-2
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("backbone", ["vit_tiny_patch16_224", "efficientnet_b0"])
def test_int8_forward_on_cuda_matches_cpu(backbone, monkeypatch):
    """A quantized detector (f32 activations, 64 px, cuDNN's TF32 off) on
    the card against the same quantized detector on the CPU: the same
    int8 weights and scales, logits within 1e-3."""
    import copy

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
    from deepfake_video_detection_tpu_torch.nn.quant import Int8Weight, quantize_module

    _cuda_generator()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = BackboneDetector(backbone, device="cpu").eval()
    if backbone.startswith("vit"):
        cpu.backbone = VisionTransformer(backbone, img_size=64, depth=2, device="cpu")
    n = quantize_module(cpu)
    card = copy.deepcopy(cpu).cuda()
    assert n > 0 and all(m.q.is_cuda for m in card.modules() if isinstance(m, Int8Weight))
    x = torch.randn((2, 3, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = cpu(x)[0]
        got = card(x.cuda())[0].cpu()
    assert float((got - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("flavor,dtype", [("clip", torch.float32), ("dinov2", torch.bfloat16)])
def test_improved_step_on_cuda_matches_plain_versions(flavor, dtype):
    """The improved trainer's model (the frame graph over a two-block
    ViT-Tiny at 64 px, CLIP- or DINOv2-flavoured) under its loss (focal,
    label smoothing 0.1): one step's loss and grad norm through the flash
    kernels (2 forward and 2 backward launches, f32 as 3xTF32) against the
    plain versions, f32 within 1e-4 / 1e-3 and bf16 within 1e-2 / 5e-2."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.data.normalize import clip_normalize
    from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
    from deepfake_video_detection_tpu_torch.train.losses import focal_loss
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.utils.graph import (
        chain_adjacency, normalize_adjacency)

    gen = _cuda_generator()
    model = FrameGraphDetector(vit_variant="vit_tiny_patch16_224", img_size=64,
                               backbone=flavor, compute_dtype=dtype, device="cuda")
    model.vit = VisionTransformer("vit_tiny_patch16_224", img_size=64, depth=2,
                                  compute_dtype=dtype, device="cuda")
    u8 = torch.randint(0, 256, (2, 4, 64, 64, 3), dtype=torch.uint8, device="cuda",
                       generator=gen)
    x = clip_normalize(u8) if flavor == "clip" else P.fused_normalize_plain(u8, torch.float32)
    adj = normalize_adjacency(chain_adjacency(4)).cuda().expand(2, 4, 4)
    labels = torch.tensor([0, 1], device="cuda")
    params = list(model.parameters())

    def run():
        loss = focal_loss(model(x, adj, train=True), labels, label_smoothing=0.1)
        return float(loss), float(global_norm(torch.autograd.grad(loss, params)))

    fwd, bwd = A.flash_attention_fwd, A.flash_attention_bwd
    before = (fwd.launches, bwd.launches, fwd.launches_f32, bwd.launches_f32)
    loss, norm = run()
    f32 = 2 if dtype == torch.float32 else 0
    assert (fwd.launches, bwd.launches, fwd.launches_f32, bwd.launches_f32) == (
        before[0] + 2, before[1] + 2, before[2] + f32, before[3] + f32)
    with mock.patch.object(A, "flash_attention",
                           lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
        ref_loss, ref_norm = run()
    tol = (1e-4, 1e-3) if dtype == torch.float32 else (1e-2, 5e-2)
    assert abs(loss - ref_loss) <= tol[0] * abs(ref_loss)
    assert abs(norm - ref_norm) <= tol[1] * ref_norm


def test_progressive_stage_on_cuda_leaves_frozen_parameters():
    """Stage 0 (head only) of a B0 detector on the card: one masked AdamW
    step moves the head and the batch-norm running stats and leaves every
    backbone parameter bit for bit."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.train import steps as S
    from deepfake_video_detection_tpu_torch.train.losses import cross_entropy_loss
    from deepfake_video_detection_tpu_torch.train.progressive import ProgressiveFineTuner
    from deepfake_video_detection_tpu_torch.train.state import TrainState

    gen = _cuda_generator()
    model = BackboneDetector("efficientnet_b0", device="cuda")
    ft = ProgressiveFineTuner(model)
    opt = ft.make_optimizer()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    batch = {"frames": torch.randn((2, 2, 64, 64, 3), device="cuda", generator=gen),
             "labels": torch.tensor([0, 1], device="cuda")}
    S.make_train_step(model, opt, cross_entropy_loss)(TrainState.create(model, opt), batch,
                                                      torch.Generator(device="cuda"))
    mask = ft.trainable_mask()
    for k, t in model.state_dict().items():
        moved = not torch.equal(t, before[k])
        assert moved == (mask[k] if k in mask else k.endswith(("running_mean",
                                                                "running_var"))), k


def test_crop_and_resize_on_cuda_matches_cpu():
    """The RGB path's crop and resize (two f32 products with JAX's
    resampling weights) on the card against the same call on the CPU, at
    1280 x 720: boxes with fractional corners, partly off the frame, one
    pixel wide, the whole frame; at most 1 level anywhere."""
    from deepfake_video_detection_tpu_torch.data.faces import crop_and_resize_batch

    _cuda_generator()
    frames = np.random.default_rng(0).integers(0, 256, (8, 720, 1280, 3), np.uint8)
    boxes = np.array([[10.3, 5.7, 500.2, 455.9], [-120.5, -80.25, 380.75, 395.5],
                      [640.0, 360.0, 641.0, 361.0], [0, 0, 1280, 720],
                      [1000.6, 500.1, 1400.2, 900.3], [300.25, 100.75, 777.5, 577.5],
                      [-10.0, -10.0, 20.0, 20.0], [1274.5, 714.5, 1380.0, 820.0]], np.float32)
    for size in (224, 64):
        got = crop_and_resize_batch(frames, boxes, size, "cuda").astype(np.int16)
        ref = crop_and_resize_batch(frames, boxes, size, "cpu").astype(np.int16)
        d = np.abs(got - ref)
        assert got.shape == (8, size, size, 3) and d.max() <= 1
        assert (d > 0).mean() < 0.01


def test_predict_video_on_cuda_through_cv2(tmp_path, monkeypatch):
    """A video file served on the card as on a host without libav: cv2
    decoding, Haar detection (``FACE_DETECTOR`` at auto), the crops resized
    on the card and one K1 launch; the result has no ``error`` key."""
    pytest.importorskip("cv2")
    import chip_smoke
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    _cuda_generator()
    for k, v in {"VIDEO_BACKEND": "cv2", "SERVE_YUV_TRANSFER": "0", "MAX_FRAMES": "4",
                 "FACE_SIZE": "64", "SERVE_WARMUP": "0", "SERVE_WINDOWS": "1",
                 "MIN_FACES": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FACE_DETECTOR", raising=False)
    path = str(tmp_path / "face.mp4")
    chip_smoke.write_clip(path, 0)
    pred = Predictor(BackboneDetector("efficientnet_b0", device="cuda"), None, "pretrained",
                     device="cuda")
    try:
        assert pred.extractor.detector == "haar"
        before = P.fused_normalize.launches
        res = pred.predict_video(path)
        assert P.fused_normalize.launches == before + 1
    finally:
        pred.close()
    assert "error" not in res, res
    assert res["num_faces"] == 4 and len(res["frame_scores"]) == 4


def test_web_app_serves_an_upload_on_cuda(tmp_path, monkeypatch):
    """One clip posted to the port's WSGI app on the card (cv2 decoding,
    Haar): the checkpoint swapped in over ``/api/load-model`` is a ViT-Tiny
    ``BackboneDetector``; the request launches K1 once and K2 once a block,
    and its result has no ``error`` key."""
    pytest.importorskip("cv2")
    import io
    import json

    import chip_smoke
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve.app import create_app

    _cuda_generator()
    for k, v in {"VIDEO_BACKEND": "cv2", "SERVE_YUV_TRANSFER": "0", "MAX_FRAMES": "4",
                 "FACE_SIZE": "224", "SERVE_WARMUP": "0", "SERVE_WINDOWS": "1",
                 "MIN_FACES": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FACE_DETECTOR", raising=False)
    model = BackboneDetector("vit_tiny_patch16_224", device="cuda")
    depth = len(model.backbone.blocks)
    ckpt = tmp_path / "ckpts" / "vit" / "checkpoint_best.npz"
    save_checkpoint(str(ckpt), model.state_dict(), meta={"model_config": {
        "model_type": "pretrained", "backbone": "vit_tiny_patch16_224"}})
    clip = tmp_path / "face.mp4"
    chip_smoke.write_clip(str(clip), 0)
    app = create_app(autoload=False, device="cuda", upload_dir=str(tmp_path / "up"),
                     data_dir=str(tmp_path / "data"), log_root=str(tmp_path / "logs"),
                     checkpoints_root=str(tmp_path / "ckpts"))

    def post(path, body, ctype):
        out = {}
        environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path, "QUERY_STRING": "",
                   "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": ctype,
                   "wsgi.input": io.BytesIO(body)}
        data = b"".join(app(environ, lambda status, headers: out.update(status=status)))
        return out["status"], json.loads(data)

    status, loaded = post("/api/load-model", json.dumps({"path": str(ckpt)}).encode(),
                          "application/json")
    assert status.startswith("200") and loaded["ok"], loaded
    body = (b'--b\r\nContent-Disposition: form-data; name="video"; filename="face.mp4"'
            b"\r\n\r\n" + clip.read_bytes() + b"\r\n--b--\r\n")
    try:
        assert app.predictor.device.type == "cuda"
        k1, k2 = P.fused_normalize.launches, A.flash_attention_fwd.launches
        status, res = post("/api/predict", body, "multipart/form-data; boundary=b")
        torch.cuda.synchronize()
        assert P.fused_normalize.launches == k1 + 1
        assert A.flash_attention_fwd.launches == k2 + depth
    finally:
        app.predictor.close()
    assert status.startswith("200") and "error" not in res, res
    assert res["num_faces"] == 4 and 0.0 <= res["prob_fake"] <= 1.0


def _biased_mtcnn_state(seed: int = 0):
    """A facenet-layout state dict of the port's cascade from ``seed``, its
    face-class biases raised so that candidates pass the default thresholds
    (``chip_smoke.py``'s weights)."""
    import chip_smoke

    return chip_smoke.mtcnn_weights(torch, seed)


def test_mtcnn_cascade_on_cuda_matches_cpu(monkeypatch):
    """The cascade on the card against the CPU, cuDNN's TF32 off: the same
    valid slots, boxes within 1e-2 px, scores within 1e-3."""
    from deepfake_video_detection_tpu_torch.models.mtcnn import MTCNN

    _cuda_generator()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    import chip_smoke

    frames = chip_smoke.mtcnn_frames(4, 180, 320)
    sd = _biased_mtcnn_state()
    out = {}
    for dev in ("cpu", "cuda"):
        det = MTCNN((180, 320), device=dev)
        det.load_state_dict(sd, strict=True)
        out[dev] = [t.cpu() for t in det.detect(frames)]
    (gb, gs, gv), (rb, rs, rv) = out["cuda"], out["cpu"]
    assert rv.any()
    match, gap = chip_smoke.match_detections(gb, gs, gv, rb, rs, rv)
    assert match >= 0.9 and gap < 1e-3, (match, gap)


def test_video_clips_dataset_mtcnn_item_on_cuda_through_cv2(tmp_path, monkeypatch):
    """One ``VideoClipsDataset`` item with the mtcnn detector, decoded by cv2
    (``VIDEO_BACKEND=cv2``), the cascade and the crops on the card: the
    clip is not zero-filled and nothing is printed about a failure."""
    pytest.importorskip("cv2")
    import chip_smoke
    from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset

    _cuda_generator()
    path = tmp_path / "mtcnn.pt"
    torch.save(_biased_mtcnn_state(), str(path))
    monkeypatch.setenv("MTCNN_WEIGHTS", str(path))
    monkeypatch.setenv("VIDEO_BACKEND", "cv2")
    chip_smoke.write_clip(str(tmp_path / "clip_fake.mp4"), 0)
    ds = VideoClipsDataset(str(tmp_path), num_frames=4, face_size=64, detector="mtcnn",
                           device="cuda")
    assert ds.extractor.detector == "mtcnn"
    faces, label, _ = ds[0]
    assert not ds._warned and label == 1
    assert faces.shape == (4, 64, 64, 3) and all(f.any() for f in faces)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dense_on_cuda_matches_cpu(dtype):
    """``MoEMLP.apply_dense`` on the card (batched matmuls over the stacked
    experts, cuBLAS) against the same weights and tokens on the CPU: the
    output (f32 either way: bf16 tokens are promoted), the routing, the
    load-balance loss and the parameters' gradients."""
    from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP

    gen = _cuda_generator()
    moe = MoEMLP(256, 1024, 4, device="cuda", generator=torch.Generator().manual_seed(0))
    ref_moe = MoEMLP(256, 1024, 4, device="cpu")
    ref_moe.load_state_dict({k: v.cpu() for k, v in moe.state_dict().items()})
    x = torch.randn((136, 256), device="cuda", generator=gen).to(dtype)
    out, aux = moe.apply_dense(x, with_aux=True)
    ref, ref_aux = ref_moe.apply_dense(x.cpu(), with_aux=True)
    assert out.dtype == torch.float32
    assert moe._route(x)[0].cpu().tolist() == ref_moe._route(x.cpu())[0].tolist()
    assert float((out.cpu() - ref).detach().abs().max()) <= 1e-5 * float(ref.detach().abs().max())
    assert abs(float(aux.detach()) - float(ref_aux.detach())) <= 1e-6
    grads = torch.autograd.grad(out.square().sum() + aux, list(moe.parameters()))
    ref_grads = torch.autograd.grad(ref.square().sum() + ref_aux, list(ref_moe.parameters()))
    for g, r in zip(grads, ref_grads):
        assert float((g.cpu() - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_moe_on_cuda_matches_plain_versions(dtype):
    """A tinyconv MoE temporal model (4 experts, 2 blocks) at T = 16: one
    step's loss, aux and gradients through the flash kernels vs their plain
    versions, and the routes: f32 throughout, or with bf16 activations
    block 0 in bf16 and block 1 in f32 (the MoE promotes, as in JAX)."""
    from unittest import mock

    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)

    gen = _cuda_generator()
    model = TemporalTransformerDetector("tinyconv", d_model=64, depth=2, num_heads=2,
                                        moe_experts=4, dropout_rate=0.0, compute_dtype=dtype,
                                        device="cuda")
    x = torch.randn((2, 16, 16, 16, 3), device="cuda", generator=gen)
    params = list(model.parameters())

    def loss_and_grads():
        logits, _, aux = model(x, train=True)
        loss = torch.nn.functional.cross_entropy(logits, torch.tensor([0, 1], device="cuda"))
        loss = loss + 0.01 * aux["moe_load_balance"]
        return loss, torch.autograd.grad(loss, params, allow_unused=True)

    fwd, bwd = A.flash_attention_fwd, A.flash_attention_bwd
    counts = (fwd.launches, fwd.launches_f32, bwd.launches, bwd.launches_f32)
    loss, grads = loss_and_grads()
    f32 = 2 if dtype == torch.float32 else 1
    assert (fwd.launches - counts[0], fwd.launches_f32 - counts[1],
            bwd.launches - counts[2], bwd.launches_f32 - counts[3]) == (2, f32, 2, f32)
    with mock.patch.object(A, "flash_attention",
                           lambda q, k, v: A.flash_attention_plain(q, k, v)[0]):
        ref_loss, ref_grads = loss_and_grads()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert abs(float(loss) - float(ref_loss)) <= tol * abs(float(ref_loss))
    for g, r in zip(grads, ref_grads):
        if r is not None:
            assert float((g - r).abs().max()) <= 10 * tol * max(float(r.abs().max()), 1e-6)


def test_dense_attention_on_cuda_matches_the_flash_route():
    """``use_flash=False`` on the card: logits within 1e-4 of the flash
    route's on the same weights, and no flash kernel launched."""
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)

    gen = _cuda_generator()
    kw = dict(d_model=64, depth=2, num_heads=2, moe_experts=4, device="cuda")
    dense = TemporalTransformerDetector("tinyconv", use_flash=False, **kw)
    flash = TemporalTransformerDetector("tinyconv", **kw)
    flash.load_state_dict(dense.state_dict())
    x = torch.randn((2, 16, 16, 16, 3), device="cuda", generator=gen)
    with torch.no_grad():
        before = A.flash_attention_fwd.launches
        logits, scores = dense(x)
        assert A.flash_attention_fwd.launches == before
        ref, ref_scores = flash(x)
        assert A.flash_attention_fwd.launches == before + 2
    assert float((logits - ref).abs().max()) <= 1e-4
    assert float((scores - ref_scores).abs().max()) <= 1e-4

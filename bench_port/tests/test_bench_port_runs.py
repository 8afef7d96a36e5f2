"""Whole runs of every cell on the CPU at a small size, with the harness's
look for a card skipped: sound runs come out correct, and runs with the
timed path broken underneath come out not correct, once for each fault a
cell can have (an answer altered where it is produced: a served verdict,
or a training step's logit; a training step that returns its state unchanged; half of the batch left out, the mean taken over
the rest). The cells run on one card, so no exchange between cards can be
left out."""

import time

import numpy as np
import pytest
import torch

from bench_port import run as R

SEED = 2 ** 31 + 99


def _run(root, cell, trace=False):
    seconds = 4.0 if cell.endswith("train") else 1.0     # a few CPU steps
    result, lines = R.run_cell(cell, SEED, seconds, trace, device="cpu", root=root,
                               t_start=time.perf_counter())
    return result, lines


@pytest.mark.parametrize("cell", ["vit_b16.serve.backlog", "efficientnet_b0.serve.backlog",
                                  "vit_b16.serve.interactive", "vit_b16.train"])
def test_sound_runs_are_correct(tiny_root, cell):
    result, lines = _run(tiny_root, cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert list(result)[-1] == "checks" and lines[-1].startswith("check ")


def test_a_traced_run_reads_the_per_layer_metrics(tiny_root):
    result, lines = _run(tiny_root, "vit_b16.serve.backlog", trace=True)
    assert result["correct"], lines
    assert result["metrics"]["batch_fill.clips"]["value"] > 0
    assert "clips_per_s" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_an_altered_answer_is_not_correct(tiny_root, monkeypatch):
    from deepfake_video_detection_tpu_torch.serve import predict as P

    inner = P.Predictor._run

    def altered(self, rows, yuv):
        probs, *rest = inner(self, rows, yuv)
        probs = np.array(probs, copy=True)
        probs[0] = probs[0, ::-1]           # the first clip's verdict swapped
        return (probs, *rest)

    monkeypatch.setattr(P.Predictor, "_run", altered)
    result, lines = _run(tiny_root, "vit_b16.serve.backlog")
    assert not result["correct"], lines


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(tiny_root, monkeypatch):
    from deepfake_video_detection_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, *a, **k: None)
    result, lines = _run(tiny_root, "vit_b16.train")
    assert not result["correct"], lines


def test_a_half_batch_mean_is_not_correct(tiny_root, monkeypatch):
    from deepfake_video_detection_tpu_torch.train import losses

    inner = losses.cross_entropy_loss

    def half(logits, labels, sample_mask=None, **kw):
        n = logits.shape[0] // 2
        return inner(logits[:n], labels[:n],
                     sample_mask=None if sample_mask is None else sample_mask[:n], **kw)

    monkeypatch.setattr(losses, "cross_entropy_loss", half)
    result, lines = _run(tiny_root, "vit_b16.train")
    assert not result["correct"], lines


def test_an_altered_training_logit_is_not_correct(tiny_root, monkeypatch):
    from deepfake_video_detection_tpu_torch.models import backbone_detector as D

    inner = D.BackboneDetector.forward

    def altered(self, *args, **kw):
        logits, *rest = inner(self, *args, **kw)
        shift = torch.zeros_like(logits)
        shift[0, 1] = 0.5                   # the first clip's fake logit moved
        return (logits + shift, *rest)

    monkeypatch.setattr(D.BackboneDetector, "forward", altered)
    result, lines = _run(tiny_root, "vit_b16.train")
    assert not result["correct"], lines

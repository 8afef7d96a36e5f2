"""The training cell: the port's ``Trainer`` step on its loader's batches.

Set-up writes the seed's clips as ``.npz`` face stacks under the run's
temporary directory, each linked under ``entries_per_clip`` names so that
an epoch outlasts the window without writing more, builds the detector with the seed's weights, the
``Trainer`` (Adam, class-weighted cross-entropy, augmentation on) and its
state, and drives that one step object through its first steps, which the
correctness check follows; the window goes on with the same object. Each
step is the loop of ``Trainer.train_epoch``: the loader's next batch on the
device, the trainer's augment and normalise, ``Trainer.train_step``, and
the loss read on the host; augmentation and dropout draw from one
generator seeded from the run's seed.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
import types
from typing import Dict

import numpy as np
import torch

from bench_port import check, flops, traffic
from bench_port.serve import KernelRanges, _free, _sync, build_detector, dtype_of
from bench_port.tracing import Tracer

CHECKED_STEPS = 3


def _feed(trainer, ds):
    """The trainer's device batches, epoch after epoch."""
    epoch = 0
    while True:
        yield from trainer._device_batches(ds, True, epoch)
        epoch += 1


def run(cell, seed: int, seconds: float, trace: bool, device="cuda") -> types.SimpleNamespace:
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    c, m = cell.config, cell.traffic
    n, T, size, B = m["clips"], m["frames"], m["face_size"], m["batch_clips"]
    root = tempfile.mkdtemp(prefix="bench_port_train_")
    phases = {"imported": time.perf_counter()}
    try:
        faces, labels = traffic.face_clips(seed, n, T, size)
        data = os.path.join(root, "faces")
        os.makedirs(data)
        for i in range(n):
            first = os.path.join(data, f"clip_{i:04d}_00.npz")
            np.savez(first, faces=faces[i], label=labels[i])
            for r in range(1, m["entries_per_clip"]):
                os.link(first, os.path.join(data, f"clip_{i:04d}_{r:02d}.npz"))
        phases["clips_written"] = time.perf_counter()
        model = build_detector(c, device, dtype_of(c["compute_dtype"]))
        state0 = check.detector_state(c, seed, device)
        model.load_state_dict(state0, strict=True)
        initial = {k: t.cpu() for k, t in state0.items()}
        del state0
        sub = traffic.rng(seed, 6).integers(0, 2 ** 31, size=2)
        cfg = TrainerConfig(out_dir=os.path.join(root, "run"), epochs=1, batch_size=B,
                            num_frames=T, lr=m["lr"], optimizer=m["optimizer"],
                            schedule="const", loss=m["loss"], balance="weights",
                            grad_clip=None, augment=m["augment"], seed=int(sub[0]))
        trainer = Trainer(model, VideoFacesDataset(data, num_frames=T), None, cfg,
                          device=device)
        phases["trainer_built"] = time.perf_counter()
        out = _loop(trainer, c, m, int(sub[1]), seconds, trace, device, initial)
        out.phases = phases
        del trainer, model
        _free(device)
        ref = check.reference_steps(c, seed, int(sub[1]), faces, labels, out.batches_seen,
                                    m["lr"], device)
        out.numbers = {k: v for k, v in check.training_numbers(out.program, ref).items()}
        out.checked = CHECKED_STEPS
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _loop(trainer, c, m, gen_seed: int, seconds: float, trace: bool, device,
          initial: Dict[str, torch.Tensor]) -> types.SimpleNamespace:
    """Set-up's first steps (checked), then the window."""
    state = trainer.init_state()
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    feed = _feed(trainer, trainer.train_ds)
    rf = torch.profiler.record_function
    frames_per_step = m["batch_clips"] * m["frames"]

    def keep_logits(module, args, output):
        logits = output[0] if isinstance(output, tuple) else output
        out.program["logits"] = logits.detach().double().cpu()

    def step():
        nonlocal state
        with rf("bench::loader"):
            t = time.perf_counter()
            batch = next(feed)
            waited = time.perf_counter() - t
        paths = batch.pop("paths")
        with rf("bench::step"):
            state, metrics = trainer.train_step(state, trainer._prep_train(batch, gen), gen)
            loss = float(metrics["loss"])
        idx = np.array([int(os.path.basename(p)[5:9]) for p in paths])
        return idx, loss, waited

    out = types.SimpleNamespace(batches_seen=[], program={"losses": []})
    ranges = KernelRanges() if trace else None
    try:
        for k in range(1, m["warm_steps"] + 1):
            # the first step's logits, as its forward hands them to the loss
            hook = trainer.model.register_forward_hook(keep_logits) if k == 1 else None
            idx, loss, _ = step()
            if hook is not None:
                hook.remove()
            if k <= CHECKED_STEPS:
                out.batches_seen.append(idx)
                out.program["losses"].append(loss)
            if k == 1:      # the first gradient, as Adam's first moment holds it
                out.program["grads"] = {n: (t / (1 - check.ADAM_B1)).cpu()
                                        for n, t in state.opt_state["mu"].items()}
                out.program["grad_norms"] = check.leaf_norms(out.program["grads"])
            if k == CHECKED_STEPS:
                out.program["change_norms"] = check.leaf_norms(
                    {n: p.detach().cpu() - initial[n] for n, p in state.params.items()})
        tracer = Tracer("bench::step") if trace else None
        if tracer is not None:
            tracer.warm()
        gc.collect()
        gc.freeze()     # set-up's objects stay out of the collector's scans
        _sync(device)
        steps = waited = failed = 0
        out.setup_done = t0 = time.perf_counter()
        t_end = t0 + seconds
        t_trace = t_end - min(m["trace_seconds"], seconds / 2)
        untraced_steps = None
        while True:
            if tracer is not None and untraced_steps is None and time.perf_counter() >= t_trace:
                untraced_steps, t_trace = steps, time.perf_counter()
                tracer.start()
            _, loss, w = step()
            if time.perf_counter() > t_end:
                break
            steps += 1
            waited += w
            failed += not np.isfinite(loss)
        if untraced_steps is not None:
            tracer.stop()
            out.trace_overhead = (f"steps a second: {untraced_steps / (t_trace - t0)} before "
                                  f"the trace, {(steps - untraced_steps) / (t_end - t_trace)} "
                                  f"in it")
        out.__dict__.update(
            window_s=seconds, attempted=steps, failed=failed, steps=steps,
            frames=steps * frames_per_step, loader_wait_s=waited,
            flops_per_frame=flops.train_flops_per_frame(c, m["frames"]),
            memory_peak_bytes=torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
        if untraced_steps is not None:
            out.trace = tracer.summary()
            out.trace_steps = len(out.trace.named("bench::step"))
            out.trace_frames = out.trace_steps * frames_per_step
        return out
    finally:
        feed.close()
        if ranges is not None:
            ranges.close()

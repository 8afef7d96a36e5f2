"""What decides ``correct``: the program's outputs from the timed path held
against the plain reference (``reference/``), number by number, each
against its limit (``limits/<cell>.json``).

Serving: for a seeded sample of the requests that the window completed,
the gap between the served log-odds ``log(prob_fake / prob_real)`` and the
reference's logit difference on the same clip; the largest gap is compared.

Training: the first three steps of the window's own step object, on the
batches its loader fed it. The reference works the batches out again from
the raw clips (the augmentation's draws and the dropout masks from a
generator seeded alike), runs the steps in float32 and compares the
first step's logits as log-odds (the widest gap over the batch), each
step's loss, the first gradient as the optimizer got it (Adam's first
moment after one step, over 1 - beta1), and the change of the parameters
after three steps, by the worst leaf: the gap between the two norms over
the larger of the reference's norm of that leaf and the median leaf's; and
the median leaf's norm of the first gradients' difference, on that scale.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the change (Adam moves them by rounding alone).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import augment
from bench_port.reference import models as R
from bench_port import weights

FAKE, REAL = 1, 0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LEAF_FLOOR = 1e-3


def compare(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = {"value": v if v is None or math.isfinite(v) else str(v), "limit": limit}
    return ok, table


def detector_state(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    params, buffers = R.detector_shapes(c)
    return weights.make_state(params, buffers, seed, device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def reference_logodds(c: Dict, seed: int, pool: np.ndarray, clips: Sequence[int], size: int,
                      device, quant: R.Quant = None, block: int = 16) -> Dict[int, float]:
    """The reference's logit difference (fake - real) of each distinct pool
    clip in ``clips``, computed in blocks of ``block`` clips."""
    sd = detector_state(c, seed, device)
    out: Dict[int, float] = {}
    todo = sorted(set(int(i) for i in clips))
    with torch.no_grad(), R.fp32_exact():
        for s in range(0, len(todo), block):
            idx = todo[s:s + block]
            x = R.yuv420_to_normalized(torch.from_numpy(pool[idx]).to(device), size)
            logits = R.detector_forward(sd, x, c, quant).double().cpu().numpy()
            out.update(zip(idx, logits[:, FAKE] - logits[:, REAL]))
    return out


def logodds_gap(served: Sequence[Tuple[int, Tuple[float, float]]], ref: Dict[int, float]
                ) -> float:
    """The largest |served log-odds - reference's| over (clip, (prob_fake,
    prob_real)) pairs."""
    return max(abs(math.log(fake) - math.log(real) - ref[i]) for i, (fake, real) in served)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def class_weights(labels: np.ndarray, classes: int = 2) -> torch.Tensor:
    """Inverse-frequency class weights normalised to mean 1."""
    counts = np.maximum(np.bincount(labels, minlength=classes).astype(np.float64), 1.0)
    w = labels.shape[0] / (classes * counts)
    return torch.tensor(w / w.mean(), dtype=torch.float32)


def reference_steps(c: Dict, seed: int, gen_seed: int, clips: np.ndarray, labels: np.ndarray,
                    batches: List[np.ndarray], lr: float, device,
                    quant: R.Quant = None, rows: Optional[Callable] = None) -> Dict:
    """The training steps on ``batches`` (clip indices) in float32 from the
    seed's weights: the first step's logits, each step's loss, each leaf's
    first-step gradient norm and each leaf's change after the last step. ``rows(n)``, when given,
    picks the rows the loss averages over (a fault's half batch)."""
    if c["architecture"] != "vit":
        raise ValueError("the training reference has no train-mode batch norm")
    p = {n: t.requires_grad_(True) for n, t in detector_state(c, seed, device).items()}
    p0 = {n: t.detach().clone() for n, t in p.items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))
    cw = class_weights(labels).to(device)
    keep = 1.0 - c["head"]["dropout"]

    def dropout(h):
        m = torch.rand(h.shape, generator=gen, device=h.device) < keep
        return torch.where(m, h / keep, torch.zeros_like(h))

    losses, grad_norms, first, first_logits = [], {}, {}, None
    with R.fp32_exact():
        for step, idx in enumerate(batches, start=1):
            x = torch.from_numpy(clips[idx]).to(device)
            y = torch.from_numpy(labels[idx]).to(device)
            draws = augment.draw_params(gen, x.shape[0], (x.shape[2], x.shape[3]),
                                        device=x.device)
            x = R.normalize(augment.apply_params(x, draws) / 255.0)
            logits = R.detector_forward(p, x, c, quant, dropout)
            ce = -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0]
            w = cw[y]
            if rows is not None:
                keep_rows = rows(x.shape[0])
                ce, w = ce[keep_rows], w[keep_rows]
            loss = torch.sum(ce * w) / torch.sum(w)
            names = list(p)
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if step == 1:
                    first_logits = logits.detach().double().cpu()
                    first = {n: g.detach().cpu() for n, g in zip(names, grads)}
                    grad_norms = leaf_norms(first)
                for n, g in zip(names, grads):
                    mu[n].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    u = (mu[n] / (1 - ADAM_B1 ** step)) / \
                        (torch.sqrt(nu[n] / (1 - ADAM_B2 ** step)) + ADAM_EPS)
                    p[n].sub_(lr * u)
            del logits, grads, loss
    return {"losses": losses, "logits": first_logits, "grad_norms": grad_norms, "grads": first,
            "change_norms": leaf_norms({n: p[n].detach() - p0[n] for n in p})}


def _leaves(tensors: Dict[str, torch.Tensor]):
    """(name, tensor) of each leaf. The fused QKV projection's weight and
    bias count as three leaves each, q, k and v (the published model's three
    projections): the key's bias has no gradient under softmax, so it moves
    under Adam by rounding alone and the rule below leaves it out."""
    for n, t in tensors.items():
        t = t.detach().float()
        if n.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                yield f"{n}[{part}]", chunk
        else:
            yield n, t


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf."""
    return {n: float(t.norm()) for n, t in _leaves(tensors)}


def leaf_diff_norms(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
                    ) -> Dict[str, float]:
    """The norm of each leaf's difference, ``got`` less ``ref``."""
    return leaf_norms({n: got[n].float() - ref[n].float() for n in ref})


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's |got - ref| / max(ref, the median leaf's ref)."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = float(np.median([ref[n] for n in leaves]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a training run against its reference: ``logit_gap``
    (the widest gap of a clip's log-odds, fake less real, in the first
    step's forward, dropout and augmentation drawn alike), ``loss_gap``
    (the first step's loss, relative), ``grad_gap`` and ``update_gap`` (the
    worst leaf), ``grad_median_gap`` (the median leaf's gap of the first
    gradient's norms) and ``grad_diff_median`` (the median leaf's norm of
    the difference of the first gradients, over the larger of the
    reference's norm and the median leaf's: the gaps of norms cancel much of
    a rounding error, the difference keeps it); each step's loss gap and
    the median leaf's change gap ride along. ``limits/<cell>.json`` says
    which are compared. The second and third steps' losses follow
    two Adam updates whose signs round differently in bfloat16 wherever a
    gradient is near zero, and the worst leaf is one small leaf or another
    from seed to seed, so those swing (PERF.md); the first step's loss and
    the median leaf are steady."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    med = float(np.median(list(ref["grad_norms"].values())))
    diff = {n: d / max(ref["grad_norms"][n], med, 1e-30)
            for n, d in leaf_diff_norms(prog["grads"], ref["grads"]).items()}
    moved = [n for n, g in ref["grad_norms"].items() if g >= LEAF_FLOOR * med]
    update = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    worst = max(grad, key=grad.get)
    worst_update = max(update, key=update.get)
    odds = [lg[:, FAKE].double() - lg[:, REAL].double()
            for lg in (prog["logits"], ref["logits"])]
    return {"logit_gap": float((odds[0] - odds[1]).abs().max()), "loss_gap": steps[0],
            "grad_gap": grad[worst], "update_gap": update[worst_update],
            "grad_median_gap": float(np.median(list(grad.values()))),
            "grad_diff_median": float(np.median(list(diff.values()))),
            "_update_median_gap": float(np.median(list(update.values()))),
            "_loss_gaps_by_step": steps, "_grad_leaf": worst, "_update_leaf": worst_update,
            "_left_out": len(ref["grad_norms"]) - len(moved)}

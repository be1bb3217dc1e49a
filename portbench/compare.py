"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, on the same inputs.

Training (the first three steps of the run): ``loss_gap``, the largest
relative gap between the program's loss and the reference's over the
steps; ``median_grad_gap``, the first gradient as the program's Adam holds
it (its first moment after one step over 1 - beta1) against the
reference's; ``median_change_gap``, each weight's change after the steps
against the reference's. Each weight's gap is the gap between the two
norms (not the norm of the difference) over the larger of the reference's
norm of that weight and of the median weight; the number is the median
weight's gap. (The worst weight's is not steady: the density head's
weight, whose gradient runs mostly through the second-order path of the
density normal, reads 1e-6 to 1e-4 on sound seeds, and over 7e-4 in its
change; PERF.md gives the readings.) Weights whose reference gradient is
under a thousandth of the median weight's move by rounding alone and are
left out of both.

Rendering (a sample of the rays of the window's images): ``mismatch_share``,
the share of the compared values (colour, opacity and depth of each ray,
of each pass where the fine pass runs) whose bits differ from the reference's rounded the way the program's eval
copy rounds them (float16).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.train import BETA1


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def train_numbers(losses: list, first_moments: dict, final: dict, initial: dict, ref: dict,
                  detail: dict | None = None) -> dict:
    """losses: the program's per step; first_moments: its Adam first
    moment of each weight after step 1; final: its weights after the last
    step; initial: the weights both started from; ref: `train_steps`'.
    ``detail``, if given, receives each weight's two gaps and the worst."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"]))
    g_ref = {k: _norm(g) for k, g in ref["first_grads"].items()}
    med = float(np.median(list(g_ref.values())))
    kept = [k for k, g in g_ref.items() if g >= 1e-3 * med]
    g_prog = {k: _norm(first_moments[k]) / (1.0 - BETA1) for k in kept}
    grad = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med) for k in kept}
    c_ref = {k: _norm(ref["final"][k] - initial[k]) for k in kept}
    c_prog = {k: _norm(final[k].to(initial[k].device) - initial[k]) for k in kept}
    med_c = float(np.median(list(c_ref.values())))
    change = {k: abs(c_prog[k] - c_ref[k]) / max(c_ref[k], med_c) for k in kept}
    if detail is not None:
        detail.update({k: {"grad": grad[k], "change": change[k], "grad_norm": g_ref[k],
                           "change_norm": c_ref[k]} for k in kept})
        detail["worst"] = {"grad": max(grad.items(), key=lambda kv: kv[1]),
                           "change": max(change.items(), key=lambda kv: kv[1])}
        detail["left_out"] = sorted(set(g_ref) - set(kept))
        detail["losses"] = {"program": list(losses), "reference": list(ref["losses"])}
    return {"loss_gap": loss_gap, "median_grad_gap": float(np.median(list(grad.values()))),
            "median_change_gap": float(np.median(list(change.values())))}


def pack_f16(x: np.ndarray) -> np.ndarray:
    """float32 values as the eval copy leaves them: rounded to float16."""
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def render_numbers(program: np.ndarray, reference: np.ndarray, detail: dict | None = None) -> dict:
    """program: (n, 5) values as the program returned them ((n, 10) with
    the fine pass); reference: the same values of the plain reference, in
    float32. ``detail``, if given, receives the share and the largest gap
    of each channel and the mismatched rays' count."""
    ref = pack_f16(reference)
    prog = np.asarray(program, np.float32)
    same = (prog == ref) | (np.isnan(prog) & np.isnan(ref))
    if detail is not None:
        gap = np.abs(prog - np.asarray(reference, np.float32))
        detail.update(
            share_by_channel=[float(1.0 - c) for c in same.mean(0)],
            max_gap_by_channel=[float(np.nanmax(c)) for c in gap.T],
            rays_mismatched=int((~same).any(1).sum()), rays=int(len(prog)),
            nan_program=int(np.isnan(prog).sum()), nan_reference=int(np.isnan(ref).sum()))
    return {"mismatch_share": float(1.0 - same.mean())}

"""The numbers that decide ``correct``, computed the same way for the
program, the control and the faults.

Training: from the first commit window, ``loss_gap`` (the window's mean
loss against the reference's, relative), ``grad_gap`` (per leaf, the norm
of Adam's first moment: the gradients as the optimizer got them) and
``change_gap`` (per leaf, the norm of the center's change after the
commit).  A leaf's gap is the gap between the two norms, not the norm of
the difference, over the reference's norm of that leaf or of the median
leaf, whichever is larger; the number is the worst leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's (a key's
bias under softmax) move by round-off alone and are left out of both; so,
within a leaf, are the elements of the change whose reference gradient is
under a thousandth of the median leaf's root mean square (the key rows of a
fused QKV bias).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the comparison
NEGLIGIBLE_GRADIENT = 1e-3


def leaf_norms(tree) -> Dict[str, float]:
    """Each leaf's norm, in float64; a tree of numbers passes through."""
    return {k: v if isinstance(v, float) else float(v.detach().double().norm())
            for k, v in tree.items()}


def kept_leaves(ref_mu: Dict[str, float]) -> list:
    """The leaves compared: all but those with a negligible gradient."""
    mid = median(ref_mu.values())
    return [k for k, v in ref_mu.items() if v >= NEGLIGIBLE_GRADIENT * mid]


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's relative gap of norms."""
    mid = median(ref[k] for k in keep)
    return {k: abs(got[k] - ref[k]) / max(ref[k], mid) for k in keep}


def moved_norms(change, ref_mu, keep, floor: float) -> Dict[str, float]:
    """Norms of each kept leaf's change over the elements whose reference
    gradient (Adam's first moment) is at least ``floor``."""
    out = {}
    for k in keep:
        mask = ref_mu[k].abs() >= floor
        out[k] = float(change[k].to(mask.device)[mask].double().norm())
    return out


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` (the worst leaf's),
    ``grad_gap_median`` and ``change_gap_median`` (the median leaf's) of
    ``got`` against ``ref``.  Each is ``{"loss": float, "mu": {leaf: first moment or its
    norm}, "change": {leaf: the center's change}}``; ``ref``'s leaves are
    tensors.  The change is compared over the elements whose reference
    gradient is not negligible: a fused leaf holds a key's bias beside
    moving rows."""
    ref_mu = leaf_norms(ref["mu"])
    keep = kept_leaves(ref_mu)
    grad = leaf_gaps(leaf_norms(got["mu"]), ref_mu, keep)
    rms = median(ref_mu[k] / math.sqrt(max(1, ref["mu"][k].numel())) for k in ref_mu)
    floor = NEGLIGIBLE_GRADIENT * rms
    change = leaf_gaps(moved_norms(got["change"], ref["mu"], keep, floor),
                       moved_norms(ref["change"], ref["mu"], keep, floor), keep)
    return {"loss_gap": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_gap": max(grad.values()), "change_gap": max(change.values()),
            "grad_gap_median": median(grad.values()),
            "change_gap_median": median(change.values())}

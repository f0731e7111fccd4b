"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference gives for the same inputs.

Norm gaps follow the training rule: per leaf the gap between the
program's norm and the reference's (not the norm of their difference),
over the larger of that leaf's reference norm and the median leaf's,
and the worst leaf. A leaf whose reference gradient is under a
thousandth of the median leaf's moves under Adam by round-off alone and
is left out of the gradient and change gaps.
"""

import statistics

import torch


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def moving_leaves(ref_grad):
    norms = {k: _norm(g) for k, g in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def norm_gap(prog, ref, leaves):
    """Worst leaf of |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    rn = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(rn.values())
    return max(abs(_norm(prog[k]) - rn[k]) / max(rn[k], med) for k in leaves)


def image_gap(prog, ref):
    """Mean absolute difference of two image stacks over the reference's
    mean absolute value; views missing from `prog` count as empty."""
    prog = prog.detach().to(torch.float64)
    ref = ref.detach().to(torch.float64)
    if prog.shape[0] < ref.shape[0]:   # views left out count as empty
        prog = torch.cat([prog, prog.new_zeros((ref.shape[0] - prog.shape[0],)
                                               + tuple(prog.shape[1:]))])
    return float((prog - ref).abs().mean() / ref.abs().mean())


def leaf_norms(prog, ref):
    """Per leaf: the program's and the reference's first-gradient and
    change norms (for the run's log)."""
    out = {}
    for k in ref["grad1"]:
        dp = prog["params"][k].to(torch.float64) - prog["params0"][k].to(torch.float64)
        dr = ref["params"][k].to(torch.float64) - ref["params0"][k].to(torch.float64)
        out[k] = (_norm(prog["grad1"][k]), _norm(ref["grad1"][k]), _norm(dp), _norm(dr))
    return out


def training_numbers(prog, ref):
    """prog and ref: {"losses", "grad1", "params0", "params", "images1"}."""
    leaves = moving_leaves(ref["grad1"])
    change_p = {k: prog["params"][k].to(torch.float64) - prog["params0"][k].to(torch.float64)
                for k in leaves}
    change_r = {k: ref["params"][k].to(torch.float64) - ref["params0"][k].to(torch.float64)
                for k in leaves}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": norm_gap(prog["grad1"], ref["grad1"], leaves),
        "change_gap": norm_gap(change_p, change_r, leaves),
        "image_gap": image_gap(prog["images1"], ref["images1"]),
    }

"""host_syncs_per_step.train: host synchronisations inside the port's
calls of a training step (the forward, the backward; in the dp cell rank
0's data-parallel step), counted by torch's sync debug mode around those
calls only, so the benchmark's own loss read is not counted."""


def read(t):
    if t["kind"] not in ("train", "dp"):
        return None
    return t.get("syncs_per_step")

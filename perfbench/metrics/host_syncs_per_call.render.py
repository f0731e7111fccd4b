"""host_syncs_per_call.render: host synchronisations inside the port's
forward call, counted as host_syncs_per_step.train counts them."""


def read(t):
    if t["kind"] != "render":
        return None
    return t.get("syncs_per_step")

"""render_mpix_s: pixels of all forward calls completed in the window
over its wall time, in millions per second."""


def read(m):
    if m["kind"] != "render":
        return None
    return m["pixels"] / m["window_s"] / 1e6

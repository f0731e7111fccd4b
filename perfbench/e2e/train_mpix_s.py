"""train_mpix_s: pixels rendered by all steps completed in the window
(views x H x W; in the data-parallel cell summed over the ranks) over
the window's wall time (rank 0's), in millions per second."""


def read(m):
    if m["kind"] not in ("train", "dp"):
        return None
    return m["pixels"] / m["window_s"] / 1e6

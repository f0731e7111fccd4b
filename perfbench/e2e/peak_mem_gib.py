"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start (the fullest rank's), GiB."""


def read(m):
    return m["peak_bytes"] / 2 ** 30 if m["peak_bytes"] else None

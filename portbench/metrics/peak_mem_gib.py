"""The device allocator's peak over the window (max_memory_allocated after
reset_peak_memory_stats at the window's start), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30

"""The largest device memory the port's allocator held over set-up and
window (torch.cuda.max_memory_allocated), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

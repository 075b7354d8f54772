"""The device memory allocated at the window's peak (``torch.cuda.
max_memory_allocated`` after a reset at the window's start), resident
inputs included, in GiB."""


def read(window) -> float:
    return window.peak_bytes / 2**30

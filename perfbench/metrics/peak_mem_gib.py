"""Peak device memory of the training window: ``max_memory_allocated``
after a reset at the window's start."""

LAYER = "Train loop (train/train_loop.py)"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = {"train": "train_tokens_per_s"}


def read(run, name):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None

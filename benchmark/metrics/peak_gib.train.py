"""peak_gib.train: the device memory peak of the window (allocated
bytes after a reset at its start), GiB, in a train cell."""

from benchmark.readers import peak_gib


def read(rec):
    return peak_gib(rec, "train")

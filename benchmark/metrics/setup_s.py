"""Seconds from the process start (the torch import included) to the
window: kernel build or load, weights and videos made on the card, the
cell's warm-up."""


def read(rec):
    return rec["setup_s"]

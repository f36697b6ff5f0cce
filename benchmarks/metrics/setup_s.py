"""Seconds from the process's start to the window's open: imports,
building the model and its weights, kernel builds and loads, warm-up."""


def read(rec):
    return rec["setup_s"]

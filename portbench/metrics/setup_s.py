"""Set-up: from the start of the process to the start of the window
(imports, the card, building the kernels if missing, the traffic, the
warm-up calls)."""


def read(run):
    return run.setup_s

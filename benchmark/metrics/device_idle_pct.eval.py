"""Share of the traced stretch in which no kernel or copy ran on the
device (``torch.profiler``'s device activity)."""


def read(run):
    tr = run.trace
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

"""Milliseconds a device-loop step: the traced stretch over the loop's
steps in it (``DeviceEvaluator.steps``)."""


def read(run):
    s = run.stretch
    if not s or not s["steps"]:
        return None
    return 1e3 * s["seconds"] / s["steps"]

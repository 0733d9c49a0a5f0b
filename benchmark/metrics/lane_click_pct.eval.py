"""Share of the device loop's lane-steps that advanced a live object: the
window's counted clicks over the loop's steps times its lanes
(``DeviceEvaluator.steps``), over the traced stretch."""


def read(run):
    s = run.stretch
    if not s or not s["steps"]:
        return None
    return 100.0 * s["clicks"] / (s["steps"] * run.traffic["lanes"])

"""Share of the traced stretch in which the device idled while the host was
inside ``evaluate_dataset_device`` (``loop.dataset``) but outside every
``loop.step``: padding the jobs, stacking and uploading a batch, the
loop's set-up, reading the results back."""

from benchmark.lib import spans


def read(run):
    j = spans.device_join(run)
    if j is None or not j.named("loop.dataset"):
        return None
    return j.idle_share({"loop.dataset"}, {"loop.step"})

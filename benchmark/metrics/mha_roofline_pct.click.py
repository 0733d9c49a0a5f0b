"""Kernel D's share of its roofline in the host click: the least time of
LoftUp's cross-attention over the traced stretch's clicks (a click: a
forward of the crop and its flip; per forward and layer every output
pixel queries the ``grid x grid`` low-resolution tokens with
``num_heads`` heads of ``(n_dim + 4 x lr_pe_freqs) / num_heads``) over
the device time of the kernels named ``PATTERN``."""

from benchmark.lib import roofline, trace

PATTERN = "mha_kernel_f32"


def read(run):
    s = run.stretch
    seconds, launches = trace.kernel_seconds(run.trace["kernels"], PATTERN)
    if not launches or seconds <= 0 or not s or not s["clicks"]:
        return None
    up, arch, t = run.config["upsampler"], run.config["backbone"], run.traffic
    h, w = t["target_size"]
    nk = (h // arch["patch_size"]) * (w // arch["patch_size"])
    cdim = up["n_dim"] + 4 * up["lr_pe_freqs"]
    per_forward = up["num_layers"] * roofline.attention_bound_s(
        2, up["num_heads"], h * w, nk, cdim // up["num_heads"],
        run.config["dtype"], packed=False)
    return 100.0 * s["clicks"] * per_forward / seconds

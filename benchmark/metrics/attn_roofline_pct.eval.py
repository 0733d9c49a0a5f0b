"""Kernel A's share of its roofline in the device loop: the least time of
its launches at the loop's call shape (``[lanes x flips, tokens, 3 x
hidden]``, packed qkv) over the device time of the kernels named
``PATTERN`` in the traced stretch."""

from benchmark.lib import roofline, trace

PATTERN = "attn_qkv_f32"


def read(run):
    seconds, launches = trace.kernel_seconds(run.trace["kernels"], PATTERN)
    if not launches or seconds <= 0:
        return None
    arch, t = run.config["backbone"], run.traffic
    grid = t["target_size"][0] // arch["patch_size"]
    n = grid * (t["target_size"][1] // arch["patch_size"]) + 1
    heads = arch["num_attention_heads"]
    per_launch = roofline.attention_bound_s(
        t["lanes"] * 2, heads, n, n, arch["hidden_size"] // heads,
        run.config["dtype"], packed=True)
    return 100.0 * launches * per_launch / seconds

"""Dequantization's share of its roofline over the traced slice: for each
architecture evaluated in the slice, every linear's packed words and
bf16 scale and zero read once and its ``[K, N]`` bf16 weight written
once, over the bandwidth, over the device time of the ``dequant`` kernel
group.  Each architecture's weights are counted once: the least an
evaluation needs, however often the program dequantizes them."""

from perfbench import model, work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "eval_s"


def read(run):
    t = (run.trace or {}).get("group_s", {}).get("dequant")
    archs = [a for c in run.calls if c["traced"] for a in c["archs"]]
    if not t or not archs:
        return None
    group = run.quant["group_size"]
    nbytes = 0.0
    for arch in archs:
        for name, (n, k) in model.dense_shapes(run.shape).items():
            for bits in arch["linear"][name]:
                nbytes += k * n * bits / 8 + 2 * 2 * (k // group) * n + 2 * k * n
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / t

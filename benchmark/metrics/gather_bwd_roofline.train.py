"""Kernels layer: the gather's backward's (``csrc/bilinear_gather_bwd.cu``)
share of its roofline in a train step, in percent: the least time its
bytes need (``benchmark/counts/gather_bytes.py``) at the card's peak
bandwidth, over its device time summed over its launches in the traced
window, by kernel name."""

KERNELS = ("bilinear_gather_bwd_kernel", "round_to_bf16_kernel")


def read(m):
    if m.kind != "train" or m.trace is None or not m.hbm_bytes_s:
        return None
    secs = sum(m.trace.kernel_seconds(k) for k in KERNELS)
    if secs <= 0:
        return None
    return (100.0 * m.gather_bwd_bytes_per_unit * m.units / m.hbm_bytes_s
            / secs)

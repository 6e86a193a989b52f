"""Kernels layer: the bilinear gather's (``csrc/bilinear_gather.cu``)
share of its roofline, in percent: the least time its bytes need (each
input byte read once, each output byte written once, counted from the
window's shapes, ``benchmark/counts/gather_bytes.py``) at the card's
peak bandwidth, over its device time summed over its launches in the
traced window, by kernel name. It moves bytes: a few operations a byte."""

KERNEL = "bilinear_gather_kernel"


def read(m):
    if m.kind != "serve" or m.trace is None or not m.hbm_bytes_s:
        return None
    secs = m.trace.kernel_seconds(KERNEL)
    if secs <= 0:
        return None
    return 100.0 * m.gather_bytes_per_unit * m.units / m.hbm_bytes_s / secs

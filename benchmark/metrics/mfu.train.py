"""Whole step: the model's FLOPs a step (the reference's convolutions
at the run's shapes, ``benchmark/counts/flops.py``) times the steps
in the traced window, over the window's seconds, against the card's
peak in the configuration's compute dtype (``benchmark/peaks.json``),
in percent."""


def read(m):
    if (m.kind != "train" or m.trace is None or not m.units
            or not m.peak_flops or not m.flops_per_unit):
        return None
    return 100.0 * m.flops_per_unit * m.units / m.trace.window_s / m.peak_flops

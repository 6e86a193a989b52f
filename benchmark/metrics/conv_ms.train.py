"""Model layer: device milliseconds a step in kernels launched under
aten's convolution operators, forward and backward (cuDNN's layout
transposes included), from the traced window's device trace, tied to
their operators by the launch's correlation id."""


def read(m):
    if (m.kind != "train" or m.trace is None or not m.units
            or not m.trace.conv_s):
        return None
    return 1e3 * m.trace.conv_s / m.units

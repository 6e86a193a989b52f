"""Engine layer: host milliseconds a window spends inside
``InferenceEngine.dispatch_windows`` (padding, pinning and copying the
frames in, launching the model's work), the mean over the traced
window's windows, from the benchmark's host-clock spans."""


def read(m):
    secs = m.spans.seconds.get("dispatch")
    if m.kind != "serve" or not secs:
        return None
    return 1e3 * sum(secs) / len(secs)

"""Train step layer: device milliseconds of a step's backward, between
the CUDA events recorded at ``make_train_step``'s "forward" and
"backward" marks (``on_phase``), the mean over the traced window's
steps."""


def read(m):
    ms = m.phase_ms.get("backward")
    if m.kind != "train" or not ms:
        return None
    return sum(ms) / len(ms)

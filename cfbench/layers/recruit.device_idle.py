"""recruit.device_idle: one minus the union of each card's kernel, copy
and set intervals over the traced window, averaged over the cell's
cards, in percent. Layer: device."""


def read(w):
    t = w.trace
    if not t.window_s:
        return None
    return 100.0 * (1.0 - sum(t.busy_s) / len(t.busy_s) / t.window_s)

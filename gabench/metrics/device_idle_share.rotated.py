"""The share of the traced slice in which no operation ran on the device,
1 - busy / wall from the profiler's timeline, for a configuration whose
islands K2's rastrigin_sr build runs (the rotated form); nothing for any
other form."""


def read(rec):
    tr = rec.slice.trace if rec.slice is not None else None
    if rec.form != "rotated" or not tr or tr["window_s"] <= 0 \
            or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

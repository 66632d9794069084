"""The slice's generations' least time (the configuration's yardstick,
`gabench/work_rotated.generations_bound`, from the shapes alone) as a
share of the device's busy time in the traced slice, for a configuration
whose islands K2's rastrigin_sr build runs (the rotated form); nothing
for any other form."""


def read(rec):
    sl = rec.slice
    if rec.form != "rotated" or sl is None or not sl.trace:
        return None
    busy = sl.trace["busy_s"]
    return 100.0 * sl.least_ms / 1e3 / busy if busy > 0 else None

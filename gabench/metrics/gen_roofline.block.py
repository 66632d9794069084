"""The slice's generations' least time (`gabench.work.generations_bound`,
from the shapes alone) as a share of the device's busy time in the traced
slice, for a configuration whose replicas K1's block form runs; nothing
where the configuration runs the other form."""


def read(rec):
    sl = rec.slice
    if rec.form != "block" or sl is None or not sl.trace:
        return None
    busy = sl.trace["busy_s"]
    return 100.0 * sl.least_ms / 1e3 / busy if busy > 0 else None

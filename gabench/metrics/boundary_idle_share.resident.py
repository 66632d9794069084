"""The share of the device's time from the first to the last of the
window's segments in which it sat between two segments: each segment's
timing events (`device_ms`, `gap_before_ms` on the port's
`topology.segment` span), taken with no profiler running, over the
window's chunks before the traced slice's profiler starts; for a
configuration whose islands K2's resident form runs, nothing for any
other form or where the port has no such spans."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    if rec.form != "resident":
        return None
    return PS.boundary_idle_share(PS.window(rec))

"""Host microseconds a K2 launch takes in the port's island segments: the
`topology.launch` spans under the `topology.segment` spans (a runner
call: K2's wrapper and the mean of its fitness) over the launches of
`ga_epoch` the segments counted (`kernel_launches.ga_epoch`), from the
port's recorder (`gabench.program_spans`), over the window's chunks
before the traced slice's profiler starts; for a configuration whose
islands K2's resident form runs, nothing for any other form or where the
port has no such spans."""

from gabench import program_spans as PS

PS.enable()


def per_launch_us(spans):
    """Microseconds of the segments' `topology.launch` spans over their
    counted `ga_epoch` launches, or None where they counted none."""
    segs = PS.segments(spans)
    ids = {s["id"] for s in segs}
    host_ns = sum(s["t1"] - s["t0"] for s in spans
                  if s["name"] == "topology.launch" and s["parent"] in ids)
    n = sum(s["attrs"].get("kernel_launches.ga_epoch", 0) for s in segs)
    return host_ns / 1e3 / n if n > 0 else None


def read(rec):
    if rec.form != "resident":
        return None
    return per_launch_us(PS.window(rec))

"""Waves of thread-block clusters a K2 launch takes in the port's island
segments: the segments' `cluster_waves` counters (K2 launches times the
waves of clusters each takes, from the card's clusters at once) over
their `kernel_launches.ga_epoch` counters, from the port's recorder
(`gabench.program_spans`), over the window's chunks before the traced
slice's profiler starts; 1.0 while every run's cluster fits the card at
once.  For a configuration whose islands K2's rastrigin_sr build runs
(the rotated form), nothing for any other form or where the port records
no such counters."""

from gabench import program_spans as PS

PS.enable()


def waves_per_launch(spans):
    """Σ cluster_waves / Σ kernel_launches.ga_epoch over the segments that
    count both, or None where none does."""
    segs = [s for s in PS.segments(spans)
            if "cluster_waves" in s["attrs"]
            and s["attrs"].get("kernel_launches.ga_epoch", 0) > 0]
    launches = sum(s["attrs"]["kernel_launches.ga_epoch"] for s in segs)
    if launches <= 0:
        return None
    return sum(s["attrs"]["cluster_waves"] for s in segs) / launches


def read(rec):
    if rec.form != "rotated":
        return None
    return waves_per_launch(PS.window(rec))

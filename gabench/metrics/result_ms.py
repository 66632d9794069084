"""Mean milliseconds a job spends in the port's `segment.result` span (the
host copies of the replicas' bests and trajectories and their NumPy
reduction, after the device is done), from the port's recorder
(`gabench.program_spans`), over the window's jobs before the traced
slice's profiler starts; nothing where the port has no such span."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    return PS.per_run_ms(PS.window(rec), "segment.result")

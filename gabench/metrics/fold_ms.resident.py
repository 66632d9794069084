"""Mean milliseconds a chunk spends in the port's `segment.result` span of
its island segment (the one read-back of the per-interval island bests
and launch means, and the host's interval-by-interval best fold), from
the port's recorder (`gabench.program_spans`), over the window's chunks
before the traced slice's profiler starts; for a configuration whose
islands K2's resident form runs, nothing for any other form or where the
port has no such span."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    if rec.form != "resident":
        return None
    return PS.per_run_ms(PS.window(rec), "segment.result")

"""Mean milliseconds a job spends in the port's `init.seed_hash` span (the
NumPy splitmix hash of every replica's seed words, with its `astype` and
`stack`), from the port's recorder (`gabench.program_spans`), over the
window's jobs before the traced slice's profiler starts; nothing where
the port has no such span."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    return PS.per_run_ms(PS.window(rec), "init.seed_hash")

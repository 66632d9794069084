"""Host microseconds a kernel launch takes in the port's segments: the
`executor.launch` spans (a K1 wrapper call with its best fold and
trajectory reductions) over the launches of the global form's three
kernels (`ga_ffm`, `ga_best`, `ga_operators`) that the segments counted,
from the port's recorder (`gabench.program_spans`), over the window's
chunks before the traced slice's profiler starts; for a configuration
whose replicas K1's global form runs, nothing where it runs the block
form or the port has no such spans."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    if rec.form != "global":
        return None
    return PS.host_us_per_launch(PS.window(rec), PS.GLOBAL_KERNELS)

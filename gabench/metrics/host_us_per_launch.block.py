"""Host microseconds a kernel launch takes in the port's segments: the
`executor.launch` spans (a K1 wrapper call with its best fold and
trajectory reductions) over the launches of K1's one-block kernel
(`ga_generation`) that the segments counted, from the port's recorder
(`gabench.program_spans`), over the window's chunks before the traced
slice's profiler starts; for a configuration whose replicas K1's block
form runs, nothing where it runs the global form or the port has no such
spans."""

from gabench import program_spans as PS

PS.enable()


def read(rec):
    if rec.form != "block":
        return None
    return PS.host_us_per_launch(PS.window(rec), PS.BLOCK_KERNELS)

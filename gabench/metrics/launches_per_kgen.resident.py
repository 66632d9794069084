"""Kernel launches the port's wrappers counted (`kernels.ga_step.LAUNCHES`,
every kernel and form) over the traced slice, per 1000 generations, for a
configuration whose islands K2's resident form runs; nothing for any
other form."""


def read(rec):
    sl = rec.slice
    if rec.form != "resident" or sl is None or not sl.done or sl.gens <= 0:
        return None
    return 1e3 * sl.launches / sl.gens

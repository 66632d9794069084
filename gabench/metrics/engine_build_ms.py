"""Mean milliseconds a job spends building `Engine(spec, backend,
options=...)`, from the benchmark's span around the call, which ends in
a synchronize; over the jobs before the traced slice's profiler starts
(the first third of the window), since its start-up changes the host's
speed."""


def read(rec):
    times = rec.spans.times.get("engine_build") if rec.spans else None
    return 1e3 * sum(times) / len(times) if times else None

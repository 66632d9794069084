"""GA serving on the port: `GAScheduler`, `run_ga_job`, the journal and the
metrics HTTP surface."""

"""Host-device transfers an ingest step: the program's ``host_syncs``
counter (``repro_torch.trace.to_host`` and ``to_device``) over the
profile phase's steps. ``core/serve.py`` claims none a step once the loop
runs."""
from bench import program_spans


def read(trace):
    return program_spans.counter(trace, "ingest", "host_syncs")

"""Host-device transfers a round: the program's ``host_syncs`` counter
(``repro_torch.trace.to_host`` and ``to_device``, each a copy the host
waits on), over the profile phase's rounds."""
from bench import program_spans


def read(trace):
    return program_spans.counter(trace, "round", "host_syncs")

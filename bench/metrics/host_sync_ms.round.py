"""Host milliseconds a round blocked in a host-device transfer: the
program's ``host_sync`` span (``repro_torch.trace.to_host`` and
``to_device``), over the profile phase's rounds; 0 where the round made
none. Under the profiler's cost."""
from bench import program_spans


def read(trace):
    if program_spans.counter(trace, "round", "host_syncs") is None:
        return None
    return program_spans.span_ms(trace, "round", ["host_sync"]) or 0.0

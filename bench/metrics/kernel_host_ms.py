"""The kernel wrappers' host milliseconds an ingest step: every
``kernel.<counter>`` span of the program (``repro_torch.trace``, one a
public wrapper call: its checks, its route and grid planning, the
launch), summed, over the profile phase's steps; under the profiler's
cost."""
from bench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "ingest",
                                 program_spans.kernel_spans())

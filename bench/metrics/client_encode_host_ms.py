"""Client encode's host milliseconds a round: the program's
``client_encode`` span (``repro_torch.trace``, ``scheduler._encode_local``:
error feedback, the codec's encode, the EF decode), every cohort client,
over the profile phase's rounds; under the profiler's cost."""
from bench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "round", ["client_encode"])

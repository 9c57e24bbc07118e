"""The server's host milliseconds a round: the program's ``server_agg``
span (``repro_torch.trace``, ``scheduler._server_aggregate``: the
decode→aggregate and the server-lr update), over the profile phase's
rounds; under the profiler's cost."""
from bench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "round", ["server_agg"])

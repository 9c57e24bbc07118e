"""The serve step's decode→aggregate, host milliseconds a step: the
program's ``ingest.decode_agg`` span (``repro_torch.trace``, inside
``serve._Step``: ``codec.decode_and_aggregate`` and the model update),
over the profile phase's steps; under the profiler's cost."""
from bench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "ingest", ["ingest.decode_agg"])

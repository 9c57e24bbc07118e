"""The server's decode→aggregate, milliseconds an ingest round: the
``server_agg`` span (``codec.decode_and_aggregate`` inside ``serve._Step``,
ended by a synchronize), mean over the spans phase's rounds."""


def read(trace):
    return trace.span_ms_a_step("server_agg") if trace.kind == "ingest" \
        else None

"""The server's decode→aggregate, milliseconds a round of an FL round
cell: the ``server_agg`` span (``scheduler._server_aggregate``, ended by a
synchronize), mean over the spans phase's rounds."""


def read(trace):
    return trace.span_ms_a_step("server_agg") if trace.kind == "round" \
        else None

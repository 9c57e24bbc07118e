"""Client encode and error-feedback decode, milliseconds a round: the
``client_encode`` span (``scheduler._encode_local``, every cohort client's
call, each ended by a synchronize), mean over the spans phase's rounds."""


def read(trace):
    return trace.span_ms_a_step("client_encode") if trace.kind == "round" \
        else None

"""Client training's milliseconds a round: the ``client_train`` span
(``task.local_update_batched`` / ``local_update``, ended by a
synchronize), summed over a round, mean over the spans phase's rounds."""


def read(trace):
    return trace.span_ms_a_step("client_train") if trace.kind == "round" \
        else None

"""Client training's host milliseconds a round: the program's
``client_train`` span (``repro_torch.trace``, around each scheduler call
of ``task.local_update`` and ``local_update_batched``), summed over the
profile phase's rounds, over its rounds. No synchronize ends the span: it
is the host's time to enqueue and wait, under the profiler's cost."""
from bench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "round", ["client_train"])

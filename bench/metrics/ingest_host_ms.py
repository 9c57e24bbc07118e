"""The serve loop's host milliseconds to enqueue one ingest step
(``serve._Step.__call__`` on the host clock, the device idle before each
step: a synchronize before the call and after it), mean over the host
phase's steps."""


def read(trace):
    if trace.kind != "ingest":
        return None
    return trace.extra.get("host_step_ms")

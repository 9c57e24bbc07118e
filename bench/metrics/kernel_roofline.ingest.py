"""The hand-written kernels' share of their roofline in an ingest cell:
Σ over the profile phase's kernel calls of each call's bound,
max(bytes / 3.35 TB/s, operations / peak) from its shapes
(``bench/cost/kernels.py``), over Σ of the device time of every kernel that
ran under those calls, in percent. Nothing when no kernel ran on a
device."""


def read(trace):
    if trace.kind != "ingest":
        return None
    bound = sum(b for b, _, _ in trace.ops.values())
    dev = sum(d for _, d, _ in trace.ops.values())
    return 100.0 * bound / dev if dev > 0 else None

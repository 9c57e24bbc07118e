"""The round's model operations over the chip's peak: the operations the
round's forward and backward passes require (``bench/cost/models.py``, no
recompute), over the plain phase's seconds a round times the peak of the
model's compute precision (``bench/cost/peaks.py``), in percent."""


def read(trace):
    step_s = trace.plain_step_s()
    if trace.kind != "round" or not step_s or not trace.step_flops:
        return None
    return 100.0 * trace.step_flops / (step_s * trace.peak_flops)

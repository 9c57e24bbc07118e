"""Hand-written kernel launches a round (``kernels/_lib.LAUNCHES``, every
wrapper's count, read before and after the profile phase, never reset),
over the profile phase's rounds."""


def read(trace):
    n = trace.steps.get("profile", 0)
    if trace.kind != "round" or not n:
        return None
    return sum(trace.launches.values()) / n

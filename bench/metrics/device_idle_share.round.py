"""The device's idle share in an FL round cell: 1 − the union of the
kernels' intervals over the profile phase's wall seconds (a steady window
of whole rounds), in percent. Nothing when no kernel ran on a device."""


def read(trace):
    if trace.kind != "round" or not trace.busy_s or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

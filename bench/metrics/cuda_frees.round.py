"""The caching allocator's ``cudaFree`` calls and retried allocations a
round: the program's ``cuda_frees`` counter (the ``round`` span's change
in ``num_device_free`` plus ``num_alloc_retries`` of
``torch.cuda.memory_stats``), over the profile phase's rounds."""
from bench import program_spans


def read(trace):
    return program_spans.counter(trace, "round", "cuda_frees")

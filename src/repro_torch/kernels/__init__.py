"""The hand-written CUDA kernels and their plain PyTorch versions.

``COUNTED`` lists every kernel wrapper that counts its launches (its
``launches`` and, for the paged kernels, ``launches_by_dtype``), in the
order the kernel modules register them with `counted`.
"""

COUNTED: list = []


def counted(fn, by_dtype=None):
    """Give a kernel wrapper its launch counters at zero (``by_dtype``: the
    page dtypes it also counts by) and register it in ``COUNTED``."""
    fn.launches = 0
    if by_dtype is not None:
        fn.launches_by_dtype = dict.fromkeys(by_dtype, 0)
    COUNTED.append(fn)
    return fn

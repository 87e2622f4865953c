"""Hand-written Hopper kernels of the port, each with its plain torch version.

Importing this package builds nothing: a kernel compiles at its first
launch (``kernels/build.py``).
"""


def launch_counts() -> dict:
    """name -> launches counted so far by each kernel's wrapper."""
    from .murmur3 import murmur3_int32
    from .string_search import window_match
    return {w.__name__: w.launches for w in (murmur3_int32, window_match)}

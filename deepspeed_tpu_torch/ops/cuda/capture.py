"""Device buffers that a captured CUDA graph reads outside its own memory
pool.

Some wrappers hand their kernels buffers cached across calls: the
block-sparse lookup tables and work lists, and the cross-entropy forward's
arrival counters.  A graph captured over such a call holds raw pointers
into them, so they must live as long as the graph, however the cache that
made them evicts or replaces them.  While ``holding()`` is open (the
capture of ``runtime/step_graph.py``), every such buffer a wrapper hands
out is kept in the mapping it yields; the captured step keeps that
mapping, and frees what it alone held when it is dropped.
"""

import contextlib
from typing import Dict, Optional

_held: Optional[Dict[int, object]] = None


@contextlib.contextmanager
def holding():
    """Collect, by ``id``, every cached buffer that ``hold`` sees inside
    the block."""
    global _held
    outer, _held = _held, {}
    try:
        yield _held
    finally:
        _held = outer


def hold(obj):
    """``obj``, also kept by the collection ``holding`` has open, if any."""
    if _held is not None:
        _held[id(obj)] = obj
    return obj

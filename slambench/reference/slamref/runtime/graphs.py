"""No graphs: every function of the reference runs eagerly.

The port captures some functions as CUDA graphs (its ``runtime/graphs.py``);
the reference keeps their decorator so its copied modules read as the
port's did, and calls each function as written.
"""

from __future__ import annotations


def graphed(fn=None, *, static=()):
    """The function itself (``static`` names the arguments the port keys
    its graphs by; nothing is keyed here)."""
    if fn is None:
        return lambda f: f
    return fn

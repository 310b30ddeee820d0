"""The program's spans below its stages, from the window's records.

``PipelineResult.timings`` (a record's ``timings``) holds each stage's
host seconds and the spans the program records inside it, by dotted key
under the stage: ``frontend.wait``, ``bundles.build``,
``loop_closure.gate.wait``, ``bundles.graph:solve_windows``. A ``wait``
span is the host blocked on the card (an event synchronised, a read of a
device result). A key a sequence did not enter counts as 0 s; a program
that records no span below its stages (no dotted key in any record)
gives no reading.
"""

from __future__ import annotations


def recorded(records) -> bool:
    """True when the program recorded spans below its stages."""
    return any("." in k for r in records for k in r["timings"])


def seconds(records, *keys) -> float:
    """The seconds of ``keys`` summed over the records."""
    return sum(r["timings"].get(k, 0.0) for r in records for k in keys)


def waits(records, stage: str) -> float:
    """The seconds of every ``<stage>.….wait`` span summed over the
    records."""
    return sum(v for r in records for k, v in r["timings"].items()
               if k.startswith(stage + ".") and k.endswith(".wait"))

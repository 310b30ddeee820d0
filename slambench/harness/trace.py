"""Reading a torch.profiler trace of the card.

From the device events (kernels, copies, sets) of a profiled stretch:
the union of their intervals (overlapping work counts once, as in
``chip_smoke.py``'s ``_merge`` / ``_covered``, copied), the device's busy
seconds inside the stretch, the device functions by total time, and the
longest idle gaps, each named by the ``stage:<name>`` span the host was
in when the gap began.
"""

from __future__ import annotations

from dataclasses import dataclass, field

STAGE = "stage:"
SEQ_SPAN = "slambench:sequence"


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class Trace:
    device: list                  # DeviceEvent, inside the stretch
    spans: list                   # (name, start_us, end_us) host spans
    lo_us: float                  # the stretch: first to last sequence
    hi_us: float
    seq_spans: list = field(default_factory=list)  # (start_us, end_us)
    sequences: list = field(default_factory=list)  # per sequence profiled

    @property
    def window_s(self) -> float:
        return (self.hi_us - self.lo_us) * 1e-6

    def busy_s(self) -> float:
        return covered(merge([(e.start_us, e.end_us) for e in self.device]),
                       self.lo_us, self.hi_us) * 1e-6

    def sequence_of(self, ev: DeviceEvent) -> int | None:
        """The profiled sequence whose span holds the event's start."""
        for i, (a, b) in enumerate(self.seq_spans):
            if a <= ev.start_us < b:
                return i
        return None

    def kernels(self, patterns) -> list:
        """Device events whose name holds one of ``patterns``."""
        return [e for e in self.device if any(p in e.name for p in patterns)]


def merge(iv):
    """Union of [start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged, lo, hi) -> float:
    """Length of the merged intervals inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def from_profiler(prof) -> Trace:
    """The stretch between the first and the last sequence span of a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith((STAGE, "slambench:", "nccl:")):
                # user annotations mirrored on the device (``nccl:`` the
                # collectives' own, over their kernels)
                continue
            dev.append(DeviceEvent(name, start, end))
        elif name.startswith(STAGE) or name == SEQ_SPAN:
            spans.append((name, start, end))
    seqs = [s for s in spans if s[0] == SEQ_SPAN]
    if not seqs:
        raise RuntimeError("the trace holds no sequence span")
    lo, hi = min(s[1] for s in seqs), max(s[2] for s in seqs)
    dev = [e for e in dev if e.end_us > lo and e.start_us < hi]
    return Trace(dev, [s for s in spans if s[0] != SEQ_SPAN], lo, hi,
                 seq_spans=sorted((s[1], s[2]) for s in seqs))



def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[name, seconds] of the device functions with most time."""
    by = {}
    for e in tr.device:
        by[e.name] = by.get(e.name, 0.0) + e.dur_us
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us * 1e-6] for name, us in top]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[label, seconds] of the longest stretches with no device work,
    labelled by the innermost ``stage:`` span the host was in when the
    gap began (``between stages`` outside all of them)."""
    merged = merge([(e.start_us, e.end_us) for e in tr.device])
    edges = [tr.lo_us] + [x for iv in merged for x in iv] + [tr.hi_us]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, tr.lo_us), min(b, tr.hi_us)
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        inside = [s for s in tr.spans if s[1] <= a < s[2]]
        label = (min(inside, key=lambda s: s[2] - s[1])[0] if inside
                 else "between stages")
        out.append([label, (b - a) * 1e-6])
    return out

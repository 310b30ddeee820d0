"""One benchmark run of a cell with the program's spans kept: each stage
split into its child spans, per sequence.

Runs ``slambench/run.py``'s run (``harness.runner.main``, the same
arguments) and keeps every sequence of the timed window's
``PipelineResult.timings`` and ``counts``. Writes to ``--out`` a JSON
object: ``result``, the run's result line (with ``--trace 1`` its
per-layer metrics and ``breakdown.idle_gaps``); ``sequences``, the
window's sequences; ``seconds`` and ``entries``, each span key's mean
per sequence; ``self_s``, each key's mean seconds less its direct
children's that the host's clock timed (what no span below it covers;
a ``device:`` span is the card's time, beside the host's); ``graphs``,
the CUDA graphs' counts summed over the window; ``keypoints``, the
left images' kept keypoints per level or octave, summed over the
window.

    python3 scripts/span_breakdown.py --workload harris.loop80 \\
        --seed 12345 --seconds 30 --trace 1 --out chiprun_out/spans.json

Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "slambench"):
    sys.path.insert(0, str(p))

from harness import runner  # noqa: E402
from slam_tpu_torch.utils.profiling import is_device_key  # noqa: E402


def breakdown(kept: list) -> dict:
    """Means per sequence of the window's spans (``kept``: (timings,
    counts) of each sequence)."""
    n = len(kept)
    keys = list(dict.fromkeys(k for t, _ in kept for k in t))
    sec = {k: sum(t.get(k, 0.0) for t, _ in kept) / n for k in keys}
    ent = {k: sum(c["spans"].get(k, 0) for _, c in kept) / n for k in keys}

    def parent(k):
        return k.rsplit(".", 1)[0] if "." in k else None

    own = {k: v - sum(sec[c] for c in keys
                      if parent(c) == k and not is_device_key(c))
           for k, v in sec.items()}
    graphs = {}
    for _, c in kept:
        for k, v in c["graphs"].items():
            graphs[k] = graphs.get(k, 0) + v
    kps = [c["keypoints"] for _, c in kept if "keypoints" in c]
    keypoints = {"left_images": sum(k["left_images"] for k in kps),
                 "per_level": [sum(x) for x in zip(
                     *(k["per_level"] for k in kps))]} if kps else {}
    return {"sequences": n, "seconds": sec, "entries": ent, "self_s": own,
            "graphs": graphs, "keypoints": keypoints}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", type=Path, required=True)
    args, rest = ap.parse_known_args(argv)
    kept, results = [], []
    record, run = runner._record, runner.run

    def keep(res, seq, wall):
        if wall > 0:  # the window's sequences (the traced pass has 0)
            kept.append((dict(res.timings), json.loads(json.dumps(
                res.counts))))
        return record(res, seq, wall)

    def keep_result(*a, **k):
        results.append(run(*a, **k))
        return results[-1]

    runner._record, runner.run = keep, keep_result
    rc = runner.main(rest)
    if not kept or not results:
        return rc or 1
    out = {"result": results[-1], **breakdown(kept)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())

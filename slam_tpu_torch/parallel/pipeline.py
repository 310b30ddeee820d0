"""The frontend over stereo PNG sequences on disk, and multi-sequence runs.

Counterpart of ``slam_tpu/parallel/pipeline.py``. The frontend from disk
is a three-stage pipeline:

  [decode threads]  decode chunk c+1 to uint8  (runtime.StereoPrefetcher)
  [copy stream]     upload chunk c+1 from pinned staging buffers
  [compute stream]  detect / match / RANSAC chunk c

It is ``models.frontend.run_frames`` with a PNG frame source: the same
chunking, RANSAC streams, staging buffers and checkpoint format as
``run_frontend``, so a run from PNGs and a run from memory resume each
other's checkpoints. Frames are uint8 (a quarter of float32's bytes over
the host-to-device link); the device converts them as it converts uint8
frames given in memory, to u8 * (1/255f), which is also what
``runtime.load_png_gray`` returns. Without the native runtime the frames
are decoded on the calling thread (``utils.kitti._imread_gray``).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from ..models import frontend as frontend_mod
from ..utils import kitti


def default_io_threads() -> int:
    """Decode threads: all but two of the host's cores (the launching
    thread and the copies keep theirs), between 3 and 8: a chunk of 32
    stereo pairs takes the card a few tens of ms and one thread a few ms
    per frame (``chip_smoke.py`` prints both)."""
    return min(8, max(3, (os.cpu_count() or 4) - 2))


class PngFrames:
    """Stereo PNG path lists as the frontend's frame source, each frame
    decoded to uint8 and edge-replicate-padded to ``hw``. ``fill`` copies
    the chunk the prefetcher's threads decoded ahead into the given
    (pinned) buffers when it is the next in the stream, and decodes the
    frames on the calling thread otherwise (a descriptor chunk recomputed
    after a resume)."""

    dtype = torch.uint8

    def __init__(self, left_paths, right_paths, hw,
                 n_io_threads: int | None = None):
        if len(left_paths) != len(right_paths):
            raise ValueError("left and right path lists differ in length")
        self.left = [str(p) for p in left_paths]
        self.right = [str(p) for p in right_paths]
        self.num = len(self.left)
        self.hw = (int(hw[0]), int(hw[1]))
        self.n_io_threads = n_io_threads or default_io_threads()
        self.native = runtime.available()
        self._loader = None
        self._next = None

    @property
    def decoder(self) -> str:
        return ("native (runtime.StereoPrefetcher)" if self.native
                else "eager (utils.kitti._imread_gray)")

    def begin(self, first_start: int, chunk: int) -> None:
        if self.native and first_start < self.num:
            self._loader = runtime.StereoPrefetcher(
                self.left[first_start:], self.right[first_start:],
                self.hw[0], self.hw[1], chunk, self.n_io_threads)
            self._next = first_start

    def end(self) -> None:
        if self._loader is not None:
            self._loader.close()
        self._loader = self._next = None

    def fill(self, start: int, n: int, dst_left, dst_right) -> None:
        if self._loader is not None and start == self._next:
            self._loader.__next__(dst_left, dst_right)
            self._next += n
            return
        for paths, dst in ((self.left, dst_left), (self.right, dst_right)):
            for i in range(n):
                self.decode(paths[start + i], dst[i])
            dst[n:].zero_()

    def decode(self, path, out) -> None:
        """One frame into ``out`` ((H, W) uint8 host tensor)."""
        if self.native:
            runtime.load_png_u8_padded(path, self.hw, out=out)
            return
        img = kitti.pad_to_bucket(kitti._imread_gray(Path(path))[None],
                                  self.hw)[0]
        out.copy_(torch.from_numpy(np.ascontiguousarray(img)))


def run_frontend_pipelined(left_paths: list, right_paths: list,
                           hw: tuple[int, int], calib,
                           cfg: SlamConfig = SlamConfig(),
                           n_io_threads: int | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 500, resume: bool = False,
                           device="cuda") -> frontend_mod.FrontendResult:
    """The frontend over on-disk PNG sequences, on ``device``: decode
    threads (``default_io_threads()`` unless given) run ahead of the
    upload and the compute; images smaller than ``hw`` are
    edge-replicate-padded to it (bucket semantics). Descriptor chunks of a
    resumed run are recomputed from the PNGs."""
    frames = PngFrames(left_paths, right_paths, hw, n_io_threads)
    return frontend_mod.run_frames(frames, calib, cfg, device,
                                   checkpoint_path, checkpoint_every, resume)


def run_multi_sequence(sequences: dict, cfg: SlamConfig = SlamConfig(),
                       run_loop_closure: bool = True,
                       cache_root: str | Path | None = None,
                       verbose: bool = False, device="cuda") -> dict:
    """Several sequences in one process. ``sequences`` maps name ->
    (left (F, H, W), right, calib, T_gt or None). KITTI's resolutions
    differ between sequences (376x1241, 375x1242, 370x1226); every
    sequence is edge-replicate-padded bottom/right to one shared bucket
    (``utils.kitti.bucket_for``), so all run at the same shapes.

    Returns name -> evaluation report (artifacts cached per sequence under
    ``cache_root``)."""
    from .. import pipeline as pipeline_mod

    bucket = kitti.bucket_for([v[0].shape[1:] for v in sequences.values()])
    reports = {}
    for name, (L, R, calib, T_gt) in sequences.items():
        res = pipeline_mod.run_pipeline(
            kitti.pad_to_bucket(L, bucket), kitti.pad_to_bucket(R, bucket),
            calib, cfg,
            cache_dir=Path(cache_root) / name if cache_root else None,
            run_loop_closure=run_loop_closure, verbose=verbose, device=device)
        if T_gt is not None:
            reports[name] = pipeline_mod.evaluate(res, np.asarray(T_gt))
        else:
            reports[name] = {"timings_s": res.timings,
                             "db_stats": res.db.stats(),
                             "num_closures": len(res.closures)}
    return reports

"""Tensorized feature-track store.

The port's own copy of ``slam_tpu/models/trackstore.py``. Track ids are
chained by the port's native ``runtime.build_tracks`` (C++), or by the
numpy ``chain_tracks`` where the runtime cannot be built; both issue the
same ids by construction.

Replaces the reference's object/dict-based ``TrackingDB``
(final_project/backend/database/tracking_database.py:75-471: dict-of-dicts
linkId_to_link, trackId_to_frames, per-frame Link object lists) with a
structure-of-arrays design:

  * per frame, a fixed K-slot block of stereo links (xl, xr, y) + validity
    (already produced by the frontend);
  * ``track_ids`` (F, K) int32 — the track of each keypoint slot (-1 none);
  * a CSR index over (track -> [(frame, slot), ...]) built once by a single
    argsort, giving O(log N) queries with zero Python object overhead.

The reference's ``add_frame`` dedup logic (tracking_database.py:301-328 —
keep only the best-distance match per current feature, retract superseded
track heads) is unnecessary here by construction: the frontend's mutual
cross-check matching is injective per frame pair, so every current slot has
at most one previous slot. Track issue/extension semantics are otherwise
identical: an inlier match to an untracked previous slot issues a new track
covering both frames; an inlier match to a tracked slot extends it
(guaranteeing track length >= 2, the reference invariant at
tracking_database.py:464).

Serialization is a single compressed ``.npz`` (replaces pickle,
tracking_database.py:340-373).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

NO_ID = -1


def chain_tracks(track_ids, next_track, match_prev, inlier_prev, f0, f1):
    """Extend track-id chaining over frames [f0, f1) in place.

    The single source of the id-assignment rule (reference add_frame,
    tracking_database.py:301-328): an inlier match to a slot that already
    carries a track id extends that track; otherwise a new id is issued
    covering BOTH frames.
    """
    for f in range(max(f0, 1), f1):
        m = match_prev[f]                    # (K,) cur slot -> prev slot
        ok = inlier_prev[f] & (m >= 0)
        if not ok.any():
            continue
        cur = np.nonzero(ok)[0]
        prev = m[cur]
        prev_tids = track_ids[f - 1, prev]
        has = prev_tids != NO_ID             # extend existing tracks
        track_ids[f, cur[has]] = prev_tids[has]
        n_new = int((~has).sum())
        if n_new:                            # issue new tracks
            new_ids = np.arange(next_track, next_track + n_new,
                                dtype=np.int32)
            next_track += n_new
            track_ids[f - 1, prev[~has]] = new_ids
            track_ids[f, cur[~has]] = new_ids
    return next_track


@dataclass
class TrackStore:
    # core SoA
    links: np.ndarray         # (F, K, 3) = (x_left, x_right, y)
    link_valid: np.ndarray    # (F, K) bool
    xy: np.ndarray            # (F, K, 2) left keypoint pixel coords
    track_ids: np.ndarray     # (F, K) int32, NO_ID where untracked
    inliers_percent: np.ndarray  # (F,) frontend RANSAC inlier % per frame
    # CSR index: entries sorted by (track, frame)
    tr_sorted: np.ndarray     # (N,) track id per entry
    fr_sorted: np.ndarray     # (N,) frame id
    slot_sorted: np.ndarray   # (N,) keypoint slot
    track_offsets: np.ndarray  # (num_tracks + 1,) CSR row pointers
    num_tracks: int

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_frontend(front) -> "TrackStore":
        """Build from a FrontendResult in one vectorized pass.

        Track assignment is the only sequential-by-frame step (it chains
        ids through time): per-frame numpy vector ops (chain_tracks).
        """
        F, K = front.link_valid.shape
        track_ids = np.full((F, K), NO_ID, np.int32)
        next_track = chain_tracks(track_ids, 0, front.match_prev,
                                  front.inlier_prev, 1, F)
        return TrackStore._finalize(front, track_ids, next_track)

    @staticmethod
    def _finalize(front, track_ids, num_tracks) -> "TrackStore":
        fr, slot = np.nonzero(track_ids != NO_ID)
        tr = track_ids[fr, slot]
        order = np.lexsort((fr, tr))
        tr_s, fr_s, slot_s = tr[order], fr[order], slot[order]
        offsets = np.searchsorted(tr_s, np.arange(num_tracks + 1))
        return TrackStore(
            links=front.links,
            link_valid=front.link_valid,
            xy=front.xy,
            track_ids=track_ids,
            inliers_percent=np.asarray(front.inlier_frac) * 100.0,
            tr_sorted=tr_s.astype(np.int32),
            fr_sorted=fr_s.astype(np.int32),
            slot_sorted=slot_s.astype(np.int32),
            track_offsets=offsets.astype(np.int64),
            num_tracks=int(num_tracks),
        )

    # ------------------------------------------------------------------
    # query API (mirrors reference tracking_database.py:102-188)
    # ------------------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self.links.shape[0]

    def frames(self, track_id: int) -> np.ndarray:
        """Frames on which ``track_id`` appears (ref :103-104)."""
        a, b = self.track_offsets[track_id], self.track_offsets[track_id + 1]
        return self.fr_sorted[a:b]

    def track_slots(self, track_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(frames, keypoint slots) of a track."""
        a, b = self.track_offsets[track_id], self.track_offsets[track_id + 1]
        return self.fr_sorted[a:b], self.slot_sorted[a:b]

    def track(self, track_id: int) -> dict[int, np.ndarray]:
        """frame -> link (xl, xr, y) for a track (ref :107-113)."""
        frs, slots = self.track_slots(track_id)
        return {int(f): self.links[f, s] for f, s in zip(frs, slots)}

    def track_links(self, track_id: int) -> np.ndarray:
        """(L, 3) stacked links of a track, frame-ordered."""
        frs, slots = self.track_slots(track_id)
        return self.links[frs, slots]

    def last_frame_of_track(self, track_id: int) -> int:
        return int(self.frames(track_id)[-1])

    def tracks(self, frame_id: int) -> np.ndarray:
        """Sorted unique track ids observed on a frame (ref :116-121)."""
        t = self.track_ids[frame_id]
        return np.unique(t[t != NO_ID])

    def link(self, frame_id: int, track_id: int) -> np.ndarray:
        """The (xl, xr, y) link of a track on a frame (ref :139-141)."""
        slots = np.nonzero(self.track_ids[frame_id] == track_id)[0]
        if len(slots) == 0:
            raise KeyError((frame_id, track_id))
        return self.links[frame_id, slots[0]]

    def frame_links(self, frame_id: int) -> np.ndarray:
        """All valid links of a frame (ref all_frame_links :155-158)."""
        return self.links[frame_id][self.link_valid[frame_id]]

    def track_lengths(self) -> np.ndarray:
        return np.diff(self.track_offsets)

    def all_track_ids(self) -> np.ndarray:
        return np.arange(self.num_tracks)

    def tracks_alive_between(self, f0: int, f1: int) -> np.ndarray:
        """Track ids with at least one observation in [f0, f1] — the bundle
        window query (ref bundle.get_relevant_tracks_in_keyframes :22)."""
        sel = (self.fr_sorted >= f0) & (self.fr_sorted <= f1)
        return np.unique(self.tr_sorted[sel])

    def connectivity(self) -> np.ndarray:
        """Per frame: number of tracks shared with the next frame
        (reference analysis.py:109-132)."""
        F = self.num_frames
        out = np.zeros(F - 1, np.int64)
        for f in range(F - 1):
            a = self.track_ids[f]
            b = self.track_ids[f + 1]
            shared = np.intersect1d(a[a != NO_ID], b[b != NO_ID])
            out[f] = len(shared)
        return out

    # ------------------------------------------------------------------
    # consistency (ports reference _check_consistency :442-471)
    # ------------------------------------------------------------------
    def check_consistency(self) -> None:
        lengths = self.track_lengths()
        assert (lengths >= 2).all(), "every track must span >= 2 frames"
        # links referenced by tracks must be stereo-valid
        assert self.link_valid[self.fr_sorted, self.slot_sorted].all()
        # per-track frames strictly increasing (no duplicate frame in track)
        for t in range(min(self.num_tracks, 1000)):  # sample cap
            frs = self.frames(t)
            assert (np.diff(frs) > 0).all()
        # cross-reference: entry count equals nonzero track_id count
        assert len(self.tr_sorted) == int((self.track_ids != NO_ID).sum())

    # ------------------------------------------------------------------
    # serialization (npz replaces pickle; ref serialize/load :340-373)
    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            str(path),
            links=self.links,
            link_valid=self.link_valid,
            xy=self.xy,
            track_ids=self.track_ids,
            inliers_percent=self.inliers_percent,
            tr_sorted=self.tr_sorted,
            fr_sorted=self.fr_sorted,
            slot_sorted=self.slot_sorted,
            track_offsets=self.track_offsets,
            num_tracks=np.int64(self.num_tracks),
        )

    def save_frame(self, path: str | Path, frame_id: int) -> None:
        """Snapshot a single frame's links/tracks (reference
        serialize_frame, tracking_database.py:380-392)."""
        np.savez_compressed(
            str(path),
            frame_id=np.int64(frame_id),
            links=self.links[frame_id],
            link_valid=self.link_valid[frame_id],
            xy=self.xy[frame_id],
            track_ids=self.track_ids[frame_id],
        )

    @staticmethod
    def load_frame(path: str | Path) -> dict:
        """Load a single-frame snapshot (reference load_frame,
        tracking_database.py:395-408)."""
        z = np.load(str(path))
        return {k: z[k] for k in
                ("frame_id", "links", "link_valid", "xy", "track_ids")}

    @staticmethod
    def load(path: str | Path) -> "TrackStore":
        z = np.load(str(path))
        return TrackStore(
            links=z["links"],
            link_valid=z["link_valid"],
            xy=z["xy"],
            track_ids=z["track_ids"],
            inliers_percent=z["inliers_percent"],
            tr_sorted=z["tr_sorted"],
            fr_sorted=z["fr_sorted"],
            slot_sorted=z["slot_sorted"],
            track_offsets=z["track_offsets"],
            num_tracks=int(z["num_tracks"]),
        )

    # ------------------------------------------------------------------
    # summary statistics (reference analysis.py:70-106)
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        lengths = self.track_lengths()
        links_per_frame = self.link_valid.sum(axis=1)
        return {
            "num_frames": self.num_frames,
            "num_tracks": self.num_tracks,
            "mean_track_length": float(lengths.mean()) if len(lengths) else 0.0,
            "max_track_length": int(lengths.max()) if len(lengths) else 0,
            "min_track_length": int(lengths.min()) if len(lengths) else 0,
            "mean_links_per_frame": float(links_per_frame.mean()),
            "mean_inliers_percent": float(np.nanmean(self.inliers_percent[1:]))
            if self.num_frames > 1 else 0.0,
        }

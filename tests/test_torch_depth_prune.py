"""Depth pruning (``ops.ba.prune_depth_weights``) on padded observation
lanes, against the JAX package's ``prune_depth_weights``.

A padded lane carries w = 0 and points at landmark 0 from camera 0. The
JAX function counts it like an observation, so it prunes landmark 0
whenever landmark 0 lies behind camera 0, even where camera 0 never
observes it (ROADMAP.md queue C: a recorded defect of the reference,
which stays as it is). The port counts only lanes with w > 0. The case
below builds exactly that: three cameras on the z axis, camera 0 at the
origin and cameras 1 and 2 ten and eleven metres behind it, all looking
along +z; landmark 0 lies between them, behind camera 0 and ahead of
cameras 1 and 2, and only cameras 1 and 2 observe it. The dense windows
and the TP path's shards (``partition_megabundle``, whose padded lanes
point at each shard's first landmark) both go through the one function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import ba as jba
from slam_tpu_torch.ops import ba, stereo
from slam_tpu_torch.parallel import tp_megabundle as tp
from slam_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

CALIB = np.array([718.856, 718.856, 607.1928, 185.2157, 0.5372], np.float32)
# camera centres along the z axis (camera 0 at the origin), all looking
# along +z; landmarks at world depth z_w
CAM_Z = np.array([0.0, -10.0, -11.0], np.float32)


def poses() -> np.ndarray:
    T = np.tile(np.eye(4, dtype=np.float32), (len(CAM_Z), 1, 1))
    T[:, 2, 3] = -CAM_Z
    return T


def observations(points: np.ndarray, seen_by: list) -> tuple:
    """Exact stereo measurements of ``points`` (L, 3) by the cameras in
    ``seen_by[l]``: (cam_idx, lm_idx, meas, w), one lane each."""
    ci = np.array([c for lm, cams in enumerate(seen_by) for c in cams],
                  np.int64)
    li = np.array([lm for lm, cams in enumerate(seen_by) for _ in cams],
                  np.int64)
    T = torch.from_numpy(poses())[torch.from_numpy(ci)]
    Xc = (T[:, :3, :3] @ torch.from_numpy(points[li])[..., None])[..., 0] \
        + T[:, :3, 3]
    meas = stereo.project(torch.from_numpy(CALIB), Xc).numpy()
    return ci, li, meas, np.ones(len(ci), np.float32)


def window(pad: int) -> tuple:
    """One window: landmark 0 behind camera 0 (world z = -4 m) seen only
    by cameras 1 and 2, landmarks 1-3 ahead of every camera seen by all
    three, then ``pad`` padded lanes (camera 0, landmark 0, w = 0)."""
    pts = np.array([[0.5, 0.2, -4.0], [1.0, -0.5, 8.0], [-1.0, 0.3, 12.0],
                    [0.2, 0.1, 20.0]], np.float32)
    ci, li, meas, w = observations(pts, [[1, 2], [0, 1, 2], [0, 1, 2],
                                         [0, 1, 2]])
    ci, li = np.pad(ci, (0, pad)), np.pad(li, (0, pad))
    meas = np.pad(meas, ((0, pad), (0, 0)))
    w = np.pad(w, (0, pad))
    return poses(), pts, ci, li, meas, w


def both(pad: int):
    """(port's w, JAX's w) of ``window(pad)``, each printed."""
    P, X, ci, li, _, w = window(pad)
    w_t = ba.prune_depth_weights(
        *(torch.from_numpy(a)[None] for a in (P, X, ci, li, w))).numpy()[0]
    w_j = np.asarray(jba.prune_depth_weights(
        *(jnp.asarray(a) for a in (P, X, ci, li, w))))
    print(f"{pad} padded lanes: landmark of each lane {li.tolist()}\n"
          f"  port w {w_t.tolist()}\n  JAX  w {w_j.tolist()}")
    return li, w, w_t, w_j


def test_padded_lanes_do_not_prune_landmark_0():
    """With padded lanes: the port keeps landmark 0's two observations,
    the JAX package zeroes them (its recorded defect), and every other
    lane is the same in both."""
    li, w, w_t, w_j = both(pad=4)
    lm0 = (li == 0) & (w > 0)
    assert lm0.sum() == 2
    np.testing.assert_array_equal(w_t, w)
    assert np.all(w_j[lm0] == 0.0)
    np.testing.assert_array_equal(w_t[~lm0], w_j[~lm0])


def test_unpadded_batch_agrees_with_jax():
    """Without padded lanes both packages keep every observation, and a
    landmark really seen from behind a camera is pruned in both."""
    _, _, w_t, w_j = both(pad=0)
    np.testing.assert_array_equal(w_t, w_j)
    assert np.all(w_t > 0)
    # landmark 0 observed by camera 0 too: now a real lane sees it from
    # behind, and both packages prune all three of its lanes
    P, X, _, _, _, _ = window(0)
    ci, li, _, w = observations(X, [[0, 1, 2], [0, 1, 2], [0, 1, 2],
                                    [0, 1, 2]])
    w_t = ba.prune_depth_weights(
        *(torch.from_numpy(a)[None] for a in (P, X, ci, li, w))).numpy()[0]
    w_j = np.asarray(jba.prune_depth_weights(
        *(jnp.asarray(a) for a in (P, X, ci, li, w))))
    np.testing.assert_array_equal(w_t, w_j)
    assert np.all(w_t[li == 0] == 0) and np.all(w_t[li != 0] > 0)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_tp_shards_keep_their_first_landmark(n_dev):
    """The TP path (``optimize_megabundle_pruned``) on the same scene made
    a mega-bundle of 8 landmarks: the first landmark of every shard (0,
    and 4 with two shards) lies behind camera 0 and is seen only by
    cameras 1 and 2, and every shard's padded lanes point at it. Its
    observations keep their weights through the prune rounds; the
    landmarks ahead of every camera keep theirs too."""
    pts = np.array([[0.5, 0.2, -4.0], [1.0, -0.5, 8.0], [-1.0, 0.3, 12.0],
                    [0.2, 0.1, 20.0], [-0.4, 0.2, -3.0], [0.8, 0.6, 9.0],
                    [-0.7, -0.2, 14.0], [0.3, -0.4, 18.0]], np.float32)
    seen = [[1, 2] if p[2] < 0 else [0, 1, 2] for p in pts]
    ci, li, meas, w = observations(pts, seen)
    parts = tp.partition_megabundle(pts, ci, li, meas, w, n_dev, pad_to=32)
    assert (parts[4] == 0).any()  # padded lanes
    mesh = make_mesh(n_dev, axis="tp", device="cpu")
    _, _, w_sh, cost = tp.optimize_megabundle_pruned(
        mesh, poses(), *parts, CALIB, iters=3)
    kept = w_sh[parts[4] > 0]
    print(f"TP on {n_dev} shards: weights of the real lanes after pruning "
          f"{kept.tolist()}, cost {cost:.3e}")
    np.testing.assert_array_equal(kept, parts[4][parts[4] > 0])
    # the JAX package's function zeroes the first landmark of each shard
    # on the same shard arrays (the recorded defect)
    first = (parts[2] == 0) & (parts[4] > 0)
    for d in range(n_dev):
        w_j = np.asarray(jba.prune_depth_weights(
            jnp.asarray(poses()), jnp.asarray(parts[0][d]),
            jnp.asarray(parts[1][d]), jnp.asarray(parts[2][d]),
            jnp.asarray(parts[4][d])))
        assert np.all(w_j[first[d]] == 0.0) and first[d].sum() == 2

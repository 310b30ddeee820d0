"""Keyframe pose graph (stateful wrapper over ops/pose_graph.py).

Counterpart of ``slam_tpu/models/pose_graph.py``. Edges live in numpy
arrays on the host; optimization and covariance queries run dense on
``device``. Odometry-only graphs take the analytic host-float64 chain
(the exact zero-residual solution), and LM accepts only steps that cut
the cost by more than 0.1%. ``save``/``load`` use the JAX package's npz
format. Graphs above ``SPARSE_NODE_THRESHOLD`` nodes need the sparse
selected-inverse path, which is still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..ops import pose_graph as pg_ops

SPARSE_NODE_THRESHOLD = 1024


def sqrt_info_from_cov(cov: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Inverse matrix square root of a 6x6 covariance (whitening)."""
    cov = 0.5 * (cov + cov.T) + eps * np.eye(6)
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, eps)
    return (vecs * (1.0 / np.sqrt(vals))) @ vecs.T


@dataclass
class PoseGraph:
    nodes: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)[None])
    keyframes: list[int] = field(default_factory=lambda: [0])
    e_i: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    e_j: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    Z: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4, 4), np.float32))
    sqrt_info: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 6, 6), np.float32))
    is_loop: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    device: str = "cpu"

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.e_i)

    @staticmethod
    def from_bundles(bundle_result, device="cpu") -> "PoseGraph":
        """The odometry chain of a BundleResult."""
        B = bundle_result.rel_T.shape[0]
        return PoseGraph(
            nodes=bundle_result.T_w2c_keyframes.astype(np.float32).copy(),
            keyframes=list(bundle_result.keyframes),
            e_i=np.arange(B, dtype=np.int32),
            e_j=np.arange(1, B + 1, dtype=np.int32),
            Z=bundle_result.rel_T.astype(np.float32).copy(),
            sqrt_info=np.stack([sqrt_info_from_cov(c)
                                for c in bundle_result.rel_cov]
                               ).astype(np.float32),
            is_loop=np.zeros(B, bool), device=str(device))

    def add_edge(self, i: int, j: int, Z: np.ndarray, cov: np.ndarray,
                 loop: bool = True) -> None:
        """Insert a Between edge (loop-closure path)."""
        self.e_i = np.append(self.e_i, np.int32(i))
        self.e_j = np.append(self.e_j, np.int32(j))
        self.Z = np.concatenate([self.Z, Z[None].astype(np.float32)])
        self.sqrt_info = np.concatenate(
            [self.sqrt_info, sqrt_info_from_cov(cov)[None].astype(np.float32)])
        self.is_loop = np.append(self.is_loop, loop)

    def copy(self) -> "PoseGraph":
        return PoseGraph(nodes=self.nodes.copy(),
                         keyframes=list(self.keyframes), e_i=self.e_i.copy(),
                         e_j=self.e_j.copy(), Z=self.Z.copy(),
                         sqrt_info=self.sqrt_info.copy(),
                         is_loop=self.is_loop.copy(), device=self.device)

    def _chain_layout(self) -> bool:
        """True iff the non-loop edges are exactly (k, k+1) in order."""
        chain = ~self.is_loop
        return bool(
            np.array_equal(self.e_i[chain], np.arange(self.num_nodes - 1))
            and np.array_equal(self.e_j[chain], np.arange(1, self.num_nodes)))

    def _device_args(self):
        if self.num_nodes > SPARSE_NODE_THRESHOLD:
            raise NotImplementedError(
                f"{self.num_nodes} keyframes > SPARSE_NODE_THRESHOLD="
                f"{SPARSE_NODE_THRESHOLD}: the sparse selected-inverse pose "
                f"graph (pg_sparse) is still to be ported (ROADMAP.md)")
        dev = torch.device(self.device)

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)

        return (t(self.nodes), t(self.e_i, torch.int64),
                t(self.e_j, torch.int64), t(self.Z), t(self.sqrt_info))

    def optimize(self, iters: int = 15) -> float:
        """Re-optimize all nodes; returns the final cost.

        An odometry-only graph takes the analytic path: with node 0
        anchored and no loop edges, X_{k+1} = Z_k X_k is the exact
        zero-residual solution, computed in float64 on the host (LM in
        float32 from that optimum random-walks on cost noise)."""
        if not self.is_loop.any() and self._chain_layout():
            nodes = self.nodes.astype(np.float64)
            Z = self.Z.astype(np.float64)
            out = np.empty_like(nodes)
            out[0] = nodes[0]
            for k in range(self.num_nodes - 1):
                out[k + 1] = Z[k] @ out[k]
            self.nodes = out.astype(np.float32)
            return 0.0
        nodes, cost = pg_ops.optimize(*self._device_args(), iters=iters)
        self.nodes = nodes.cpu().numpy()
        return float(cost)

    def covariance_full(self) -> np.ndarray:
        """(N, 6, N, 6) posterior covariance."""
        return pg_ops.gn_hessian_inverse(*self._device_args()).cpu().numpy()

    def marginal_logdets(self) -> tuple[np.ndarray, np.ndarray]:
        loc, rot = pg_ops.marginal_logdets(*self._device_args())
        return loc.cpu().numpy(), rot.cpu().numpy()

    def gate_distances(self, pair_i: np.ndarray,
                       pair_j: np.ndarray) -> np.ndarray:
        """Mahalanobis gating distances (P,) of candidate pairs, in one
        device pass (posterior inverse + batched quadratic forms)."""
        args = self._device_args()
        dev = args[0].device
        d = pg_ops.gate_matrix(
            *args, torch.as_tensor(np.asarray(pair_i), device=dev).long(),
            torch.as_tensor(np.asarray(pair_j), device=dev).long())
        return d.cpu().numpy()

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            str(path), nodes=self.nodes, keyframes=np.asarray(self.keyframes),
            e_i=self.e_i, e_j=self.e_j, Z=self.Z, sqrt_info=self.sqrt_info,
            is_loop=self.is_loop)

    @staticmethod
    def load(path: str | Path, device="cpu") -> "PoseGraph":
        """Read a pose-graph npz written by either package."""
        with np.load(str(path)) as z:
            return PoseGraph(nodes=z["nodes"],
                             keyframes=[int(k) for k in z["keyframes"]],
                             e_i=z["e_i"], e_j=z["e_j"], Z=z["Z"],
                             sqrt_info=z["sqrt_info"], is_loop=z["is_loop"],
                             device=str(device))

"""Keyframe pose graph (stateful wrapper over ops/pose_graph.py).

Counterpart of ``slam_tpu/models/pose_graph.py``. Edges live in numpy
arrays on the host; optimization and covariance queries run on
``device``. Odometry-only graphs take the analytic host-float64 chain
(the exact zero-residual solution), and LM accepts only steps that cut
the cost by more than 0.1%. Above ``SPARSE_NODE_THRESHOLD`` nodes,
``optimize``, ``marginal_logdets`` and ``gate_distances`` take the sparse
selected-inverse path (ops/pg_sparse.py, float64 on ``device``), which
needs the odometry chain in node order; ``covariance_full``, ``marginal``
and ``relative_covariance`` stay dense at any size. ``save``/``load`` use
the JAX package's npz format.

The dense path pads the graph to the JAX package's static buckets: edges
to a multiple of ``_EDGE_PAD`` (identity Z, zero sqrt-information, masked
by ``e_valid``), nodes to a multiple of ``_NODE_PAD`` (identity, masked
by ``n_valid``) and the gate's pairs to a multiple of ``_PAIR_PAD``, and
slices the results back. So every refresh and re-optimisation of one
``find_loops`` call (N fixed, one edge more per closure) replays the
same CUDA graph of each op.

Spans (``utils.profiling``): ``build`` (``from_bundles``), ``optimize``
(the LM, or the odometry chain, and its read-back) and ``wait``, the
host blocked on each read-back of a result from the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_kernels, pg_sparse
from ..ops import pose_graph as pg_ops
from ..utils.profiling import span

_EDGE_PAD = 64     # edge capacity grows in blocks of this many
_NODE_PAD = 64     # node capacity too: one graph per bucket of nodes
_PAIR_PAD = 8192   # the gate's pair count, N(N-1)/2, padded the same way

# Above this node count optimize / gate / log-dets take the sparse path:
# the dense (6N)^2 inverse is O(N^3) work and ~0.9 GB of float32
# covariance at N = 2500; at the reference's ~650 keyframes its one
# batched solve beats the sparse path's sequential recurrences.
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
    device: str = "cuda"

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.e_i)

    @staticmethod
    def from_bundles(bundle_result, device="cuda") -> "PoseGraph":
        """The odometry chain of a BundleResult; its dense solves run on
        ``device`` (the card unless the caller names the CPU)."""
        with span("build"):
            device = cuda_kernels.resolve_device(device)
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

    def _use_sparse(self) -> bool:
        return self.num_nodes > SPARSE_NODE_THRESHOLD

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=cuda_kernels.resolve_device(self.device))

    def _padded_edges(self):
        """Edges padded to the _EDGE_PAD bucket: (e_i, e_j, Z, sqrt_info,
        e_valid), the padding joining node 0 to itself with identity Z and
        zero sqrt-information."""
        E = self.num_edges
        pad = -E % _EDGE_PAD
        e_i = np.concatenate([self.e_i, np.zeros(pad, np.int32)])
        e_j = np.concatenate([self.e_j, np.zeros(pad, np.int32)])
        Z = np.concatenate(
            [self.Z, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        si = np.concatenate([self.sqrt_info, np.zeros((pad, 6, 6),
                                                      np.float32)])
        valid = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
        return e_i, e_j, Z, si, valid

    def _padded_nodes(self):
        """Nodes padded to the _NODE_PAD bucket with identities, and
        n_valid."""
        N = self.num_nodes
        pad = -N % _NODE_PAD
        nodes = np.concatenate(
            [self.nodes, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        return nodes, np.concatenate([np.ones(N, bool), np.zeros(pad, bool)])

    @staticmethod
    def _padded_pairs(pair_i, pair_j):
        """The gate's pairs padded to the _PAIR_PAD bucket with the pair
        (0, 0): (pair_i, pair_j), int64."""
        P = len(pair_i)
        cap = max(_PAIR_PAD, P + -P % _PAIR_PAD)
        pi = np.zeros(cap, np.int64)
        pj = np.zeros(cap, np.int64)
        pi[:P] = pair_i
        pj[:P] = pair_j
        return pi, pj

    def _dense_args(self):
        """The dense path's inputs at the padded shapes: (nodes, e_i, e_j,
        Z, sqrt_info, e_valid) and n_valid."""
        t = self._tensor
        e_i, e_j, Z, si, e_valid = self._padded_edges()
        nodes, n_valid = self._padded_nodes()
        return ((t(nodes), t(e_i, torch.int64), t(e_j, torch.int64), t(Z),
                 t(si), t(e_valid)), t(n_valid))

    def _sparse_arrays(self):
        """The sparse path's inputs: the graph split into the odometry
        chain (edge k joins nodes k and k+1) and the loop edges (at least
        one slot: an invalid one when there is no loop)."""
        if not self._chain_layout():
            raise ValueError("sparse path requires a consecutive odometry "
                             "chain (from_bundles layout)")
        t, chain, loop = self._tensor, ~self.is_loop, self.is_loop
        if loop.any():
            li, lj, Zl, sil = (self.e_i[loop], self.e_j[loop], self.Z[loop],
                               self.sqrt_info[loop])
            lv = np.ones(len(li), bool)
        else:
            li = lj = np.zeros(1, np.int64)
            Zl = np.eye(4, dtype=np.float32)[None]
            sil = np.zeros((1, 6, 6), np.float32)
            lv = np.zeros(1, bool)
        return (t(self.nodes), t(self.Z[chain]), t(self.sqrt_info[chain]),
                t(li, torch.int64), t(lj, torch.int64), t(Zl), t(sil), t(lv),
                self.num_nodes)

    def optimize(self, iters: int = 15) -> float:
        """Re-optimize all nodes; returns the final cost. The span
        ``optimize``.

        An odometry-only graph takes the analytic path: with node 0
        anchored and no loop edges, X_{k+1} = Z_k X_k is the exact
        zero-residual solution, computed in float64 on the host (LM in
        float32 from that optimum random-walks on cost noise)."""
        with span("optimize"):
            return self._optimize(iters)

    def _optimize(self, iters: int) -> float:
        if not self.is_loop.any() and self._chain_layout():
            nodes = self.nodes.astype(np.float64)
            Z = self.Z.astype(np.float64)
            out = np.empty_like(nodes)
            out[0] = nodes[0]
            for k in range(self.num_nodes - 1):
                out[k + 1] = Z[k] @ out[k]
            self.nodes = out.astype(np.float32)
            return 0.0
        if self._use_sparse():
            nodes, cost = pg_sparse.optimize_sparse(*self._sparse_arrays(),
                                                    iters=iters)
        else:
            args, n_valid = self._dense_args()
            nodes, cost = pg_ops.optimize(*args, iters=iters,
                                          n_valid=n_valid)
        with span("wait"):
            self.nodes = nodes[:self.num_nodes].cpu().numpy()
            return float(cost)

    def covariance_full(self) -> np.ndarray:
        """(N, 6, N, 6) posterior covariance."""
        args, n_valid = self._dense_args()
        N = self.num_nodes
        C = pg_ops.gn_hessian_inverse(*args, n_valid=n_valid)
        with span("wait"):
            return C[:N, :, :N, :].cpu().numpy()

    def marginal(self, i: int, C: np.ndarray | None = None) -> np.ndarray:
        """Marginal 6x6 covariance of node ``i`` (from ``C``, the
        covariance_full of this graph, when given)."""
        C = self.covariance_full() if C is None else C
        return C[i, :, i, :]

    def relative_covariance(self, i: int, j: int,
                            C: np.ndarray | None = None) -> np.ndarray:
        """Covariance of the relative perturbation of node ``j`` against
        node ``i`` (from ``C`` when given)."""
        C = self.covariance_full() if C is None else C
        return pg_ops.relative_covariance(torch.from_numpy(np.asarray(C)),
                                          i, j).numpy()

    def marginal_logdets(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-node log-determinants of the 3x3 location and rotation
        marginal covariances, (N,) each."""
        if self._use_sparse():
            loc, rot = pg_sparse.marginal_logdets_sparse(
                *self._sparse_arrays())
        else:
            args, n_valid = self._dense_args()
            loc, rot = pg_ops.marginal_logdets(*args, n_valid=n_valid)
        N = self.num_nodes
        with span("wait"):
            return loc[:N].cpu().numpy(), rot[:N].cpu().numpy()

    def gate_distances(self, pair_i: np.ndarray,
                       pair_j: np.ndarray) -> np.ndarray:
        """Mahalanobis gating distances (P,) of candidate pairs, on the
        device (posterior covariance, dense or selected blocks, and batched
        quadratic forms): only the distances come back. The dense path
        pads the pairs to the _PAIR_PAD bucket."""
        if self._use_sparse():
            t = self._tensor
            d = pg_sparse.gate_matrix_sparse(*self._sparse_arrays(),
                                             t(pair_i, torch.int64),
                                             t(pair_j, torch.int64))
            with span("wait"):
                return d.cpu().numpy()
        pi, pj = self._padded_pairs(pair_i, pair_j)
        args, n_valid = self._dense_args()
        d = pg_ops.gate_matrix(*args, self._tensor(pi), self._tensor(pj),
                               n_valid=n_valid)
        with span("wait"):
            return d[:len(pair_i)].cpu().numpy()

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            str(path), nodes=self.nodes, keyframes=np.asarray(self.keyframes),
            e_i=self.e_i, e_j=self.e_j, Z=self.Z, sqrt_info=self.sqrt_info,
            is_loop=self.is_loop)

    @staticmethod
    def load(path: str | Path, device="cuda") -> "PoseGraph":
        """Read a pose-graph npz written by either package."""
        device = cuda_kernels.resolve_device(device)
        with np.load(str(path)) as z:
            return PoseGraph(nodes=z["nodes"],
                             keyframes=[int(k) for k in z["keyframes"]],
                             e_i=z["e_i"], e_j=z["e_j"], Z=z["Z"],
                             sqrt_info=z["sqrt_info"], is_loop=z["is_loop"],
                             device=str(device))

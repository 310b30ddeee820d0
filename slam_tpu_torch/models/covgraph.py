"""Covariance path graph: det-weighted shortest paths between keyframes.

Counterpart of ``slam_tpu/models/covgraph.py`` (host numpy, the port's
own copy): an undirected graph of keyframe nodes whose edges carry a 6x6
covariance weighted by its determinant, a dense Dijkstra, and the
path-summed covariance the reference uses to price loop-closure
candidates. The port's loop closure gates on the exact joint covariance
of the pose graph instead; this module exists to compare the two.
"""

from __future__ import annotations

import numpy as np


class CovarianceGraph:
    """Undirected graph of keyframe nodes; each edge carries a 6x6
    covariance, weighted by its determinant."""

    def __init__(self, num_nodes: int):
        self.n = num_nodes
        self.w = np.full((num_nodes, num_nodes), np.inf)
        np.fill_diagonal(self.w, 0.0)
        self.cov: dict[tuple[int, int], np.ndarray] = {}

    @staticmethod
    def _norm(cov: np.ndarray) -> float:
        """Edge weight = det(cov) (reference graph.py:11-13)."""
        return float(abs(np.linalg.det(cov)))

    def add_edge(self, i: int, j: int, cov: np.ndarray) -> None:
        w = self._norm(cov)
        if w < self.w[i, j]:
            self.w[i, j] = self.w[j, i] = w
            self.cov[(i, j)] = cov
            self.cov[(j, i)] = cov

    def update_edge(self, i: int, j: int, cov: np.ndarray) -> None:
        self.w[i, j] = self.w[j, i] = self._norm(cov)
        self.cov[(i, j)] = cov
        self.cov[(j, i)] = cov

    def get_cov(self, i: int, j: int) -> np.ndarray:
        return self.cov[(i, j)]

    # ------------------------------------------------------------------
    def dijkstra(self, src: int) -> tuple[np.ndarray, np.ndarray]:
        """Dense Dijkstra: (distances, predecessors) from src
        (reference graph.py:55-93, vectorized)."""
        dist = np.full(self.n, np.inf)
        prev = np.full(self.n, -1, np.int64)
        done = np.zeros(self.n, bool)
        dist[src] = 0.0
        for _ in range(self.n):
            u = int(np.argmin(np.where(done, np.inf, dist)))
            if not np.isfinite(dist[u]):
                break
            done[u] = True
            cand = dist[u] + self.w[u]
            better = (cand < dist) & ~done
            prev[better] = u
            dist[better] = cand[better]
        return dist, prev

    def shortest_path(self, src: int, dst: int) -> list[int]:
        """Node sequence src..dst (reference get_shortest_path :95-99)."""
        _, prev = self.dijkstra(src)
        path = [dst]
        while path[-1] != src:
            p = int(prev[path[-1]])
            if p < 0:
                return []
            path.append(p)
        return path[::-1]

    def path_covariance(self, src: int, dst: int) -> np.ndarray:
        """Sum of edge covariances along the det-weighted shortest path
        (reference get_path_cov :101-109) — the reference's approximation
        of the relative covariance between two keyframes."""
        path = self.shortest_path(src, dst)
        cov = np.zeros((6, 6))
        for a, b in zip(path[:-1], path[1:]):
            cov = cov + self.get_cov(a, b)
        return cov

    # ------------------------------------------------------------------
    @staticmethod
    def from_pose_graph(pg) -> "CovarianceGraph":
        """Build from a models.pose_graph.PoseGraph (edges carry
        sqrt-information; invert back to covariances)."""
        g = CovarianceGraph(pg.num_nodes)
        for i, j, si in zip(pg.e_i, pg.e_j, pg.sqrt_info):
            info = si.T @ si
            cov = np.linalg.inv(info + 1e-12 * np.eye(6))
            g.add_edge(int(i), int(j), cov)
        return g

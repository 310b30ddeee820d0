"""Which torch.linalg calls of the port's pose graph and BA covariances a
CUDA graph can capture, on the card.

Each case runs once eagerly, then is captured into a
``torch.cuda.CUDAGraph`` on a side stream (``capture_error_mode=
"thread_local"``, as ``slam_tpu_torch.runtime.graphs`` captures) and
replayed; a case prints ``captured`` with the largest difference of its
replay from the eager result, or ``refused`` with the error. The cases
are the shapes the main path gives: the pose graph's dense system at
the 64-node bucket (6N = 384) and at KITTI 00's 704-node bucket (4224),
the gate's (8192, 6, 6) quadratic forms, the window BA's covariance
systems (16, 144, 144) and the pair's (1, 12, 12), whole and one window
at a time, and the port's ``ops.ba._marginals`` at both.

    python3 scripts/probe_linalg_capture.py [--big]

``--big`` adds the 4224 cases (~1 s each). One card, ~30 s.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def spd(B, n, gen, dev):
    A = torch.randn((B, n, n), generator=gen, device=dev) / n ** 0.5
    return A @ A.transpose(1, 2) + 0.5 * torch.eye(n, device=dev)


def capture(fn, args):
    """(ok, max abs difference of the replay from eager, error)."""
    want = fn(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(*args)
        except Exception as e:  # the refusal is the finding
            try:
                g.capture_end()
            except RuntimeError:
                pass
            torch.cuda.synchronize()
            return False, None, f"{type(e).__name__}: {str(e)[:160]}"
        g.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    g.replay()
    torch.cuda.synchronize()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    wants = want if isinstance(want, (tuple, list)) else (want,)
    err = max(float((o.float() - w.float()).abs().nan_to_num(0).max())
              for o, w in zip(outs, wants))
    return True, err, None


def port_cases(dev, N=64, seed=0):
    """The port's dense pose-graph functions on a chain of N nodes with a
    loop edge, their bodies captured whole (``.fn``: the graphed function
    itself would capture its own graph)."""
    sys.path.insert(0, ".")
    from slam_tpu_torch.ops import pose_graph as pg, se3

    g = torch.Generator().manual_seed(seed)
    xi = torch.zeros((N, 6))
    xi[:, 3] = torch.arange(N) * 0.5
    xi[:, :3] = 0.01 * torch.randn((N, 3), generator=g)
    nodes = se3.se3_exp(xi)
    e_i = torch.cat([torch.arange(N - 1), torch.tensor([0])])
    e_j = torch.cat([torch.arange(1, N), torch.tensor([N - 1])])
    Z = nodes[e_j] @ se3.inverse(nodes[e_i])
    si = 100.0 * torch.eye(6).expand(len(e_i), 6, 6).contiguous()
    nodes = se3.retract(nodes, 0.01 * torch.randn((N, 6), generator=g))
    pi, pj = torch.tril_indices(N, N, -1)
    a = [t.to(dev) for t in (nodes, e_i, e_j, Z, si)]
    pairs = [t.to(dev) for t in (pj, pi)]
    return [
        (f"pose_graph.optimize N={N}",
         lambda *a: pg.optimize.fn(*a, iters=15), a),
        (f"pose_graph.gn_hessian_inverse N={N}", pg.gn_hessian_inverse.fn,
         a),
        (f"pose_graph.gate_matrix N={N} P={len(pi)}",
         lambda *a: pg.gate_matrix.fn(*a[:5], None, *a[5:]), a + pairs),
        (f"pose_graph.marginal_logdets N={N}", pg.marginal_logdets.fn, a),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    L = torch.linalg
    cases = []
    sizes = [384] + ([4224] if args.big else [])
    for n in sizes:
        A = spd(1, n, gen, dev)[0]
        b = torch.randn((n, 1), generator=gen, device=dev)
        cases += [
            (f"solve_ex ({n}, {n})", lambda A, b: L.solve_ex(A, b)[0], (A, b)),
            (f"inv_ex ({n}, {n})", lambda A: L.inv_ex(A)[0], (A,)),
            (f"cholesky_ex ({n}, {n})", lambda A: L.cholesky_ex(A)[0], (A,)),
            (f"cholesky_ex + cholesky_solve ({n}, {n})",
             lambda A, b: torch.cholesky_solve(b, L.cholesky_ex(A)[0]),
             (A, b)),
            (f"cholesky_ex + cholesky_inverse ({n}, {n})",
             lambda A: torch.cholesky_inverse(L.cholesky_ex(A)[0]), (A,)),
            (f"cholesky_ex + solve_triangular(L, I) ({n}, {n})",
             lambda A: L.solve_triangular(
                 L.cholesky_ex(A)[0], torch.eye(A.shape[-1], device=A.device),
                 upper=False), (A,)),
        ]
    for B, n in ((16, 144), (1, 12), (1, 144)):
        S = spd(B, n, gen, dev)
        eye = torch.eye(n, device=dev).expand(B, n, n)
        cases += [
            (f"cholesky_ex ({B}, {n}, {n})", lambda S: L.cholesky_ex(S)[0],
             (S,)),
            (f"cholesky_ex + solve_triangular(L, I) ({B}, {n}, {n})",
             lambda S, eye: L.solve_triangular(L.cholesky_ex(S)[0], eye,
                                               upper=False), (S, eye)),
        ]
        cases.append((f"inv_ex per window, {B} x ({n}, {n})",
                      lambda S: torch.stack([L.inv_ex(s)[0] for s in S]),
                      (S,)))
    sys.path.insert(0, ".")
    from slam_tpu_torch.ops import ba

    for B, n in ((16, 144), (1, 12)):
        cases.append((f"ops.ba._marginals ({B}, {n}, {n})", ba._marginals,
                      (spd(B, n, gen, dev),)))
    C = spd(8192, 6, gen, dev)
    D = torch.randn((8192, 6, 1), generator=gen, device=dev)
    M3 = spd(704, 3, gen, dev)
    cases += [
        ("solve_ex (8192, 6, 6)", lambda C, D: L.solve_ex(C, D)[0], (C, D)),
        ("cholesky_ex + cholesky_solve (8192, 6, 6)",
         lambda C, D: torch.cholesky_solve(D, L.cholesky_ex(C)[0]), (C, D)),
        ("det (704, 3, 3)", lambda M: L.det(M), (M3,)),
    ]
    cases += port_cases(dev)
    # last: refused captures (the batched LU of inv_ex at (16, 144, 144)
    # synchronises; MAGMA's batched cholesky_inverse aborts the process)
    S = spd(16, 144, gen, dev)
    cases.append(("inv_ex (16, 144, 144)", lambda S: L.inv_ex(S)[0], (S,)))
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}))
    for name, fn, a in cases:
        ok, err, msg = capture(fn, a)
        print(f"[capture] {name}: " + (f"captured, replay - eager {err:.3g}"
                                       if ok else f"refused ({msg})"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

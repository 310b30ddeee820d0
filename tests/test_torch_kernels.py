"""Kernels B1 (detect_maps), B2 (mutual_nearest), B3 (orientation_maps),
B4 (harris_response), B5 (akaze_octave) and B6 (cholesky_solve) of the
port; B7 (schur_reduce) has tests/test_torch_schur_reduce.py and is here
only where every wrapper takes its plain version on CPU tensors.

On the CPU the wrappers run their plain versions, which are held here
against the JAX package's Pallas kernels in interpret mode. The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card and skip without one. JAX is imported inside the parity tests only,
so the ``cuda`` tests also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import ba
from slam_tpu_torch.ops import cuda_kernels as ck
from slam_tpu_torch.ops import matching

torch.set_num_threads(2)

WINDOW = (-192.0, -2.0, 4.0)


def t(x, dtype=None, device="cpu"):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def images(seed, F, H, W):
    """Blob images with a smooth background: Harris corners and every
    gradient orientation."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((F, H, W), np.float32)
    for f in range(F):
        img = 0.05 + 0.02 * np.sin(yy / 7.0 + f)
        for cy, cx, a in zip(rng.uniform(0, H, 60), rng.uniform(0, W, 60),
                             rng.uniform(0.3, 1.0, 60)):
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0)
        out[f] = np.clip(img, 0, 1)
    return out


def desc_sets(seed, B, Ka, Kb, D=128, noise=0.1):
    """B's rows are noisy copies of A's rows; B's positions are A's
    shifted as a stereo pair would be."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ka, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    src = rng.integers(0, Ka, (B, Kb))
    b = np.take_along_axis(a, src[..., None], 1) + noise * rng.normal(
        size=(B, Kb, D)).astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    xa = rng.uniform([0, 0], [1241, 376], (B, Ka, 2)).astype(np.float32)
    xb = (np.take_along_axis(xa, src[..., None], 1)
          + rng.uniform([-150, -3], [-1, 3], (B, Kb, 2))).astype(np.float32)
    va = rng.uniform(size=(B, Ka)) > 0.05
    vb = rng.uniform(size=(B, Kb)) > 0.05
    return a, b.astype(np.float32), va, vb, xa, xb


def decided(base, pen, dim):
    """Entries whose best and second-best differ by more than 1e-5 (and
    whose best is a real distance): the argmin there is not a tie."""
    d = base + pen
    top2 = torch.topk(d, 2, dim=dim, largest=False).values
    first, second = top2.select(dim, 0), top2.select(dim, 1)
    return ((second - first) > 1e-5) & (first < 1e29)


def near_tie(resp):
    """Pixels whose response ties the runner-up of their 5x5 window
    within 1e-6 of max |resp|: there a last-bit difference may flip the
    NMS decision either way."""
    r = torch.as_tensor(resp)
    pad = torch.nn.functional.pad(r[:, None], (2, 2, 2, 2),
                                  value=-float("inf"))
    win = pad.unfold(2, 5, 1).unfold(3, 5, 1).reshape(*r.shape, 25).clone()
    win[..., 12] = -float("inf")
    runner = win.max(dim=-1).values
    return ((r - runner).abs() <= 1e-6 * float(r.abs().max())).numpy()


# ---------------------------------------------------------------------------
# plain versions against the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_b1_plain_matches_pallas_interior():
    """resp and maps within 1e-5 of their max, and the same NMS pattern,
    away from near-ties, on the interior >= 8 px from the edge (the Pallas
    kernel's zero canvas differs from the plain version's per-stage zero
    padding within 4-6 px of the edge)."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    imgs = images(0, 2, 70, 120)
    r_j, n_j, m_j = (np.asarray(x) for x in pk.detect_maps_batch(
        jnp.asarray(imgs), interpret=True))
    r_t, n_t, m_t = (x.numpy() for x in ck.detect_maps(t(imgs)))
    inner = (slice(None), slice(8, -8), slice(8, -8))
    np.testing.assert_allclose(r_t[inner], r_j[inner],
                               atol=1e-5 * np.abs(r_j).max())
    np.testing.assert_allclose(m_t[:, :, 8:-8, 8:-8], m_j[:, :, 8:-8, 8:-8],
                               atol=1e-5 * np.abs(m_j).max())
    mism = np.isfinite(n_t) != np.isfinite(n_j)
    assert not (mism & ~near_tie(r_t))[inner].any()


@pytest.mark.parametrize("window", [None, WINDOW])
def test_b2_plain_matches_pallas(window):
    """Row and column distances within 1e-5 (summation order); indices
    equal wherever the best and second-best differ by more than 1e-5."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    a, b, va, vb, xa, xb = desc_sets(1, 1, 1024, 1024)
    rd_j, ri_j, cd_j, ci_j = (np.asarray(x) for x in pk.mutual_nearest(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(va[0]),
        jnp.asarray(vb[0]), interpret=True, xy_a=jnp.asarray(xa[0]),
        xy_b=jnp.asarray(xb[0]), window=window))
    rd, ri, cd, ci = ck.mutual_nearest(t(a), t(b), t(va), t(vb), t(xa),
                                       t(xb), window)
    base = ck.window_distances(t(a), t(b), t(xa), t(xb), window)
    row_ok = decided(base, torch.where(t(vb), 0.0, ck.BIG)[:, None, :], 2)[0]
    col_ok = decided(base, torch.where(t(va), 0.0, ck.BIG)[:, :, None], 1)[0]
    assert row_ok.sum() > 500 and col_ok.sum() > 500
    np.testing.assert_allclose(rd[0].numpy()[row_ok], rd_j[row_ok],
                               atol=1e-5)
    np.testing.assert_array_equal(ri[0].numpy()[row_ok], ri_j[row_ok])
    np.testing.assert_allclose(cd[0].numpy()[col_ok], cd_j[col_ok],
                               atol=1e-5)
    np.testing.assert_array_equal(ci[0].numpy()[col_ok], ci_j[col_ok])


def test_mutual_match_matches_pallas_wrapper():
    """The port's cross-checked matches equal the JAX package's one-pass
    kernel's on the same descriptors (no ties among random vectors)."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    a, b, va, vb, xa, xb = desc_sets(2, 1, 1024, 1024)
    out_j = pk.mutual_match_pallas(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(va[0]),
        jnp.asarray(vb[0]), max_dist=0.6, interpret=True,
        xy_a=jnp.asarray(xa[0]), xy_b=jnp.asarray(xb[0]), window=WINDOW)
    out_t = matching.mutual_match(t(a), t(b), t(va), t(vb), max_dist=0.6,
                                  xy_a=t(xa), xy_b=t(xb), window=WINDOW)
    np.testing.assert_array_equal(out_t["matched"][0].numpy(),
                                  np.asarray(out_j["matched"]))
    np.testing.assert_array_equal(out_t["target_idx"][0].numpy(),
                                  np.asarray(out_j["target_idx"]))
    assert int(out_t["matched"].sum()) > 100


# ---------------------------------------------------------------------------
# B2's reduction schedule (csrc/mutual_nearest.cu), written out in torch
# ---------------------------------------------------------------------------

def f2key(d):
    """The kernel's order-preserving float -> uint32 key (-0 folded to
    +0), as int64."""
    d = torch.where(d == 0, 0.0, d).float()
    u = d.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def key2f(k):
    u = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    return u.int().view(torch.float32)


def pack(d, idx):
    """The kernel's 64-bit (key << 32 | index), shifted by -2^63 so that
    int64 order is its unsigned order."""
    return (f2key(d) - 2 ** 31) * 2 ** 32 + idx


def unpack(k):
    return key2f(k // 2 ** 32 + 2 ** 31), k % 2 ** 32


def strict_less_scan(d, idx):
    """Minimum over the last axis visited in order with strict-less
    updates (a thread's running minimum), and the index it keeps."""
    best = torch.full(d.shape[:-1], float("inf"))
    arg = torch.zeros(d.shape[:-1], dtype=torch.int64)
    for i in range(d.shape[-1]):
        upd = d[..., i] < best
        best = torch.where(upd, d[..., i], best)
        arg = torch.where(upd, idx[..., i], arg)
    return best, arg


def b2_schedule(base, valid_a, valid_b, BM=128, BN=64):
    """Both reductions of B2 over the (B, Ka, Kb) window distances, in the
    kernel's order: CTAs of BM rows, column tiles of BN, 32 x 32 warp
    tiles, each thread holding rows 8q + g (q < 4) and columns 8 ni + 2t
    + e (ni < 4, e < 2) of its warp tile (g = lane / 4, t = lane % 4).
    Rows and columns past Ka, Kb get an infinite penalty.
      rows: each thread's strict-less minimum over its columns in every
        tile, in order; then packed (key, column) minima over the quad
        (xor 1, 2) and over the column warps;
      columns, per tile: each thread's strict-less minimum over its 4
        rows; the 8 lanes of equal t reduce-scatter packed (key, row)
        keys (xor 16, 8, 4: lane g keeps slot g); the row warps' minimum;
        then the minimum over the CTAs (the kernel's atomicMin).
    Returns (rdist, ridx, cdist, cidx) as the kernel does."""
    B, Ka, Kb = base.shape
    nc, nt = -(-Ka // BM), -(-Kb // BN)
    wm_n, wn_n = BM // 32, BN // 32
    inf = float("inf")
    pa = torch.nn.functional.pad(torch.where(valid_a, 0.0, ck.BIG),
                                 (0, nc * BM - Ka), value=inf)
    pb = torch.nn.functional.pad(torch.where(valid_b, 0.0, ck.BIG),
                                 (0, nt * BN - Kb), value=inf)
    base = torch.nn.functional.pad(base, (0, nt * BN - Kb, 0, nc * BM - Ka),
                                   value=2.0)
    # axes: b, cta, wm, q, g | tile, wn, ni, t, e
    shape = (B, nc, wm_n, 4, 8, nt, wn_n, 4, 4, 2)
    rows = torch.arange(nc * BM)[:, None].expand(-1, nt * BN).reshape(
        shape[1:])
    cols = torch.arange(nt * BN)[None, :].expand(nc * BM, -1).reshape(
        shape[1:])
    d_row = (base + pb[:, None, :]).reshape(shape)
    d_col = (base + pa[:, :, None]).reshape(shape)

    # rows: thread (b, cta, wm, q, g, wn, t) over (tile, ni, e)
    perm = (0, 1, 2, 3, 4, 6, 8, 5, 7, 9)
    d = d_row.permute(perm).flatten(-3)
    best, arg = strict_less_scan(d, cols[None].permute(perm).flatten(-3)
                                 .expand_as(d))
    k = pack(best, arg)                       # (..., wn, t)
    for m in (1, 2):
        k = torch.minimum(k, k[..., torch.arange(4) ^ m])
    k = k[..., 0].min(dim=-1).values          # the two column warps
    rdist, ridx = unpack(k.reshape(B, nc * BM)[:, :Ka])

    # columns: thread (b, cta, wm, g, tile, wn, ni, t, e) over q
    perm = (0, 1, 2, 4, 5, 6, 7, 8, 9, 3)
    d = d_col.permute(perm)
    best, arg = strict_less_scan(d, rows[None].permute(perm).expand_as(d))
    # slots s = 2 ni + e: axes b, cta, wm, tile, wn, t, g, s
    k = pack(best, arg).permute(0, 1, 2, 4, 5, 7, 3, 6, 8).flatten(-2)
    g = torch.arange(8)
    for half, m in ((4, 4), (2, 2), (1, 1)):
        hi = (g // m) % 2                      # lane bit: xor 16, 8, 4
        s = torch.arange(half)[None, :] + half * hi[:, None]   # (g, half)
        keep = torch.gather(k, -1, s.expand(k.shape[:-2] + s.shape))
        recv = torch.gather(k[..., g ^ m, :], -1,
                            s.expand(k.shape[:-2] + s.shape))
        k = torch.minimum(keep, recv)
    k = k[..., 0]                              # lane g: slot g
    # slot g of lane (g, t) is warp column 8 (g // 2) + 2 t + g % 2
    col = (8 * (g // 2)[None, :] + 2 * torch.arange(4)[:, None]
           + (g % 2)[None, :])                 # (t, g)
    out = torch.empty(k.shape[:-2] + (32,), dtype=torch.int64)
    out[..., col.flatten()] = k.flatten(-2)
    out = out.min(dim=2).values                # the row warps
    out = out.flatten(-3)                      # (b, cta, tile * wn * 32)
    out = out.min(dim=1).values                # over CTAs: atomicMin
    cdist, cidx = unpack(out[:, :Kb])
    return rdist, ridx, cdist, cidx


def lowest_argmin(d, dim):
    m = d.min(dim=dim, keepdim=True).values
    idx = torch.arange(d.shape[dim]).view([-1 if i == dim % d.dim() else 1
                                           for i in range(d.dim())])
    return torch.where(d == m, idx, d.shape[dim]).min(dim=dim).values


@pytest.mark.parametrize("window", [None, WINDOW])
def test_b2_schedule_on_hamming_ties_matches_pallas(window):
    """On +-1 signs (integer distances, many ties) the schedule's
    distances equal the Pallas kernel's (interpret mode) exactly, and
    every row and column index equals the lowest-index argmin, as the
    Pallas kernel's do."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    a, b, va, vb, xa, xb = desc_sets(13, 1, 1024, 1024)
    a = np.where(a > a.mean(-1, keepdims=True), 1.0, -1.0).astype(np.float32)
    b = np.where(b > b.mean(-1, keepdims=True), 1.0, -1.0).astype(np.float32)
    out_j = [np.asarray(x) for x in pk.mutual_nearest(
        jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(va[0]),
        jnp.asarray(vb[0]), interpret=True, xy_a=jnp.asarray(xa[0]),
        xy_b=jnp.asarray(xb[0]), window=window)]
    base = ck.window_distances(t(a), t(b), t(xa), t(xb), window)
    rd, ri, cd, ci = b2_schedule(base, t(va), t(vb))
    d_row = base + torch.where(t(vb), 0.0, ck.BIG)[:, None, :]
    d_col = base + torch.where(t(va), 0.0, ck.BIG)[:, :, None]
    tied = sum(int(((d == d.min(dim, keepdim=True).values).sum(dim) > 1)
                   .sum()) for d, dim in ((d_row, 2), (d_col, 1)))
    assert tied > 50
    assert torch.equal(ri, lowest_argmin(d_row, 2))
    assert torch.equal(ci, lowest_argmin(d_col, 1))
    for got, want in zip((rd, ri, cd, ci), out_j):
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("tiles", [(128, 64), (64, 32), (32, 96)])
@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("sizes", [(2, 300, 200), (1, 1, 65), (2, 130, 3)])
def test_b2_schedule_ragged_matches_plain(sizes, window, tiles):
    """Ragged Ka and Kb (the Pallas kernel needs multiples of 1024): the
    schedule's distances equal the plain version's exactly (the same
    distance matrix, only reduced in another order), and its indices are
    the lowest-index argmin, on real-valued and on +-1 descriptors."""
    a, b, va, vb, xa, xb = (t(x) for x in desc_sets(14, *sizes, D=32))
    for sign in (False, True):
        if sign:
            a, b = (torch.where(x > x.mean(-1, keepdim=True), 1.0, -1.0)
                    for x in (a, b))
        base = ck.window_distances(a, b, xa, xb, window)
        rd, ri, cd, ci = b2_schedule(base, va, vb, *tiles)
        rd_p, _, cd_p, _ = ck.mutual_nearest_plain(a, b, va, vb, xa, xb,
                                                   window)
        assert torch.equal(rd, rd_p) and torch.equal(cd, cd_p)
        d_row = base + torch.where(vb, 0.0, ck.BIG)[:, None, :]
        d_col = base + torch.where(va, 0.0, ck.BIG)[:, :, None]
        assert torch.equal(ri, lowest_argmin(d_row, 2))
        assert torch.equal(ci, lowest_argmin(d_col, 1))


# ---------------------------------------------------------------------------
# B1's marching schedule (csrc/detect_maps.cu), written out in torch
# ---------------------------------------------------------------------------

def sobel(a, b, c):
    """The kernel's Sobel taps / 8 on rows a, b, c, each [x - 1, x, x + 1]."""
    gx = ((a[2] - a[0]) + 2.0 * (b[2] - b[0]) + (c[2] - c[0])) * 0.125
    gy = ((c[0] - a[0]) + 2.0 * (c[1] - a[1]) + (c[2] - a[2])) * 0.125
    return gx, gy


def blur5(taps, kept, v):
    s = torch.zeros_like(v)
    for u in range(4):
        s = s + taps[u] * kept[u]
    return s + taps[4] * v


def atan2_poly(y, x):
    """The kernel's atan2: the octant's ratio, the odd polynomial of
    Cephes' atanf on [0, tan(pi / 8)], (t - 1) / (t + 1) above that."""
    ax, ay = x.abs(), y.abs()
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-37)
    big = t > 0.41421356237
    u = torch.where(big, (t - 1.0) / (t + 1.0), t)
    z = u * u
    a = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * u + u
    a = torch.where(big, a + np.float32(np.pi / 4), a)
    a = torch.where(ay > ax, np.float32(np.pi / 2) - a, a)
    a = torch.where(x < 0, np.float32(np.pi) - a, a)
    return torch.where(y < 0, -a, a)


def max5(vals):
    return torch.stack(list(vals)).max(dim=0).values


def b1_schedule(imgs, k=0.05, chunk_rows=96, warps=8):
    """B1 over (F, H, W) images in the kernel's order. A block of
    ``32 * warps`` threads owns as many image columns side by side (a
    5-column halo on each side; the blocks' stored columns are of equal
    width ``pitch``) and a chunk of at most ``chunk_rows`` rows, and takes
    in one image row per iteration (output row = input row - 13 + 5). A
    thread keeps its column's vertical windows: the separable blurs' last 4
    rows, the row maxima of the separable 5x5 NMS, the last 3 rows'
    8-channel vectors of the box sums (a pixel's vector built once; column
    sums, then row sums, ((v0 + v1) + v2) + v3). What a stage reads of its
    neighbours' columns it reads from the line the stage before wrote an
    iteration earlier: every stage lags the one before it by one more row,
    the lines are kept twice, and one barrier an iteration does. Lines
    start as zeros and have 2 cells of padding that stay zero; a warp whose
    columns all lie past the halo writes none. Every block marches at once
    here, as tensors of shape (F, chunks, blocks, threads). Returns (resp,
    nms, maps) and fails unless every value was stored once."""
    from slam_tpu_torch.ops import features

    F, H, W = imgs.shape
    HALO, PAD, LAG = 5, 2, 13
    NT = 32 * warps
    SPAN = NT - 2 * HALO
    nchunks = -(-H // chunk_rows)
    rows = -(-H // nchunks)
    nblocks = -(-W // SPAN)
    pitch = -(-W // nblocks)
    th = features.gaussian_kernel1d(1.5, 2)
    to = features.gaussian_kernel1d(1.0, 2)
    q = torch.arange(NT)
    x0 = torch.arange(nblocks) * pitch
    x = x0[:, None] - HALO + q                                 # (B, NT)
    q0 = q & ~31
    active = (q0 < pitch + 2 * HALO) & (x0[:, None] - HALO + q0 < W + HALO)
    stores = (q >= HALO) & (q < HALO + pitch) & (x < W)
    ys = torch.arange(nchunks) * rows                          # (C,)
    nrows = torch.clamp(ys + rows, max=H) - ys
    col_in = ((x >= 0) & (x < W))[None, None]
    inf = float("inf")

    def row_in(y):
        return ((y >= 0) & (y < H))[None, :, None, None] & col_in

    def load(y):
        v = imgs[:, y.clamp(0, H - 1)][:, :, x.clamp(0, W - 1)]
        return torch.where(row_in(y), v, 0.0)

    zero = torch.zeros((F, nchunks, nblocks, NT))
    names = ["img", "gx", "gy", "r", "bv"] + [f"cs{c}" for c in range(8)]
    lines = {n: [torch.zeros((F, nchunks, nblocks, NT + 2 * PAD))
                 for _ in range(2)] for n in names}

    def write(name, buf, v):
        cells = lines[name][buf][..., PAD:PAD + NT]
        cells[:] = torch.where(active, v, cells)

    prev, pgx, pgy, pbv = zero, zero, zero, zero
    ia, ib = [zero] * 3, [zero] * 3
    hxx, hyy, hxy = [zero] * 4, [zero] * 4, [zero] * 4
    rv, rm, bh = [zero] * 3, [zero] * 4, [zero] * 4
    ba, bb = [zero] * 3, [zero] * 3
    vw = [[zero] * 8 for _ in range(3)]
    pcs = [zero] * 8
    out = [torch.full((F, n, H, W), float("nan")) for n in (1, 1, 8)]
    stored = [torch.zeros((n, H, W), dtype=torch.int64) for n in (1, 1, 8)]

    def emit(j, planes):
        for c in range(nchunks):
            if not 0 <= j < int(nrows[c]):
                continue
            for b in range(nblocks):
                cols = x[b][stores[b]]
                for p, v in enumerate(planes):
                    tsr, pl = (p, 0) if p < 2 else (2, p - 2)
                    out[tsr][:, pl, int(ys[c]) + j, cols] = \
                        v[:, c, b][:, stores[b]]
                    stored[tsr][pl, int(ys[c]) + j, cols] += 1

    for step in range(rows + LAG):
        w, r_ = step & 1, (step & 1) ^ 1   # this iteration's lines, the last's

        def read(name, d):
            return lines[name][r_][..., PAD + d:PAD + d + NT].clone()

        yi = ys - HALO + step
        cur = load(yi)
        write("img", w, cur)
        ic = [read("img", -1), prev, read("img", 1)]           # row yi-1
        planes = []

        # Harris phase
        gx, gy = sobel(ia, ib, ic)                             # row yi-2
        in2 = row_in(yi - 2)
        gx, gy = torch.where(in2, gx, 0.0), torch.where(in2, gy, 0.0)
        write("gx", w, gx)
        write("gy", w, gy)
        a5 = [read("gx", -2), read("gx", -1), pgx, read("gx", 1),
              read("gx", 2)]                                   # row yi-3
        b5 = [read("gy", -2), read("gy", -1), pgy, read("gy", 1),
              read("gy", 2)]
        sxx, syy, sxy = zero, zero, zero
        for u in range(5):
            sxx = sxx + th[u] * (a5[u] * a5[u])
            syy = syy + th[u] * (b5[u] * b5[u])
            sxy = sxy + th[u] * (a5[u] * b5[u])
        cxx, cyy, cxy = blur5(th, hxx, sxx), blur5(th, hyy, syy), \
            blur5(th, hxy, sxy)                                # row yi-5
        det, tr = cxx * cyy - cxy * cxy, cxx + cyy
        r = torch.where(row_in(yi - 5), det - k * tr * tr, -inf)
        write("r", w, r)
        m = max5([read("r", -2), read("r", -1), read("r", 1), read("r", 2),
                  rv[2]])                                      # row yi-6
        mm = max5(rm + [m])
        c = rv[0]                                              # row yi-8
        planes += [c, torch.where(c >= mm, c, -inf)]
        pgx, pgy = gx, gy
        hxx, hyy, hxy = hxx[1:] + [sxx], hyy[1:] + [syy], hxy[1:] + [sxy]
        rv, rm = rv[1:] + [r], rm[1:] + [m]

        # orientation phase
        i5 = [read("img", -2), ic[0], prev, ic[2], read("img", 2)]
        s = zero
        for u in range(5):
            s = s + to[u] * i5[u]                              # row yi-1
        bv = torch.where(row_in(yi - 3), blur5(to, bh, s), 0.0)
        write("bv", w, bv)
        bc = [read("bv", -1), pbv, read("bv", 1)]              # row yi-4
        gx, gy = sobel(ba, bb, bc)                             # row yi-5
        sq = gx * gx + gy * gy + 1e-12
        mag = sq * torch.rsqrt(sq)
        bin_f = (atan2_poly(gy, gx) + np.pi) * np.float32(8.0 / (2.0 * np.pi))
        fl = torch.floor(bin_f)
        w1 = bin_f - fl
        in5 = row_in(yi - 5)
        b0 = fl.long() & 7
        m0 = torch.where(in5, mag * (1.0 - w1), 0.0)
        m1 = torch.where(in5, mag * w1, 0.0)
        new, sums = [], []
        for ch in range(8):
            v = torch.where(b0 == ch, m0,
                            torch.where(b0 == (ch + 7) % 8, m1, 0.0))
            cs = ((vw[0][ch] + vw[1][ch]) + vw[2][ch]) + v     # out row yi-7
            write(f"cs{ch}", w, cs)
            planes.append(((read(f"cs{ch}", -1) + pcs[ch])
                           + read(f"cs{ch}", 1)) + read(f"cs{ch}", 2))
            new.append(v)
            sums.append(cs)
        vw, pcs = vw[1:] + [new], sums
        bh, pbv = bh[1:] + [s], bv
        ba, bb = bb, bc
        ia, ib = ib, ic
        prev = cur
        emit(step - LAG, planes)
    assert all((n == 1).all() for n in stored)
    return out[0][:, 0], out[1][:, 0], out[2]


def check_b1_outputs(got, want, inner=None):
    """B1's tolerances (chip_smoke.check_b1): resp within 1e-5 of max
    |resp| (summation order), at most 0.1% of map values beyond 1e-5 of
    max |maps| (pixels on an 8-bin boundary, where gradients that differ
    in their last bit fall into different bins), the NMS pattern equal
    away from near-ties. ``inner`` restricts the comparison to an index
    of the trailing (H, W) axes."""
    (r_g, n_g, m_g), (r_w, n_w, m_w) = got, want
    tie = near_tie(r_w)
    pick = (Ellipsis,) + (inner or (slice(None), slice(None)))
    r_g, n_g, m_g, r_w, n_w, m_w, tie = (
        np.asarray(v)[pick] for v in (r_g, n_g, m_g, r_w, n_w, m_w, tie))
    assert np.isfinite(r_g).all() and np.isfinite(m_g).all()
    np.testing.assert_allclose(r_g, r_w, rtol=0,
                               atol=1e-5 * np.abs(r_w).max())
    assert (np.abs(m_g - m_w) > 1e-5 * np.abs(m_w).max()).mean() <= 1e-3
    assert not ((np.isfinite(n_g) != np.isfinite(n_w)) & ~tie).any()
    kept = np.isfinite(n_g)
    np.testing.assert_array_equal(n_g[kept], r_g[kept])


def test_b1_schedule_matches_pallas_interior():
    """The marching schedule against the Pallas kernel in interpret mode,
    on the interior >= 8 px from the edge (its zero canvas differs from
    the per-stage zero padding nearer the edge), with B1's tolerances."""
    import jax.numpy as jnp
    from slam_tpu.ops import pallas_kernels as pk

    imgs = images(0, 2, 70, 120)
    want = [np.asarray(v) for v in pk.detect_maps_batch(jnp.asarray(imgs),
                                                        interpret=True)]
    got = b1_schedule(t(imgs), chunk_rows=32, warps=2)
    check_b1_outputs(got, want, inner=(slice(8, -8), slice(8, -8)))


@pytest.mark.parametrize("shape, chunk_rows, warps", [
    ((2, 70, 120), 96, 8), ((1, 37, 41), 16, 8), ((1, 95, 53), 96, 2),
    ((1, 96, 54), 96, 2), ((1, 97, 55), 96, 2), ((1, 47, 107), 24, 2),
    ((1, 48, 108), 24, 2), ((1, 49, 109), 24, 2), ((1, 12, 245), 96, 8),
    ((1, 12, 246), 96, 8), ((1, 12, 247), 96, 8), ((1, 9, 493), 96, 8),
    ((1, 20, 130), 96, 4), ((2, 9, 7), 96, 8), ((1, 3, 100), 2, 4)])
def test_b1_schedule_matches_plain(shape, chunk_rows, warps):
    """The marching schedule against the plain version over the whole
    image (both read zero outside per stage and -inf for NMS), with B1's
    tolerances: widths one less, equal and one more than one and two
    blocks' most columns (246 and 492 at 8 warps, 54 and 108 at 2),
    heights around one and two chunks of rows, blocks whose last warps lie
    outside the image, an image narrower than a warp and one smaller than
    the halo, chunks shorter than the stages' lag."""
    x = t(images(15, *shape))
    got = b1_schedule(x, chunk_rows=chunk_rows, warps=warps)
    check_b1_outputs(got, ck.detect_maps_plain(x))


# ---------------------------------------------------------------------------
# wrappers on the CPU: dispatch, counters, input checks
# ---------------------------------------------------------------------------

def spd_systems(seed, B, N, bad=()):
    """SPD systems with the gauge rows (tests/test_pallas_parity.py's
    construction; fewer than 6 gauge rows for N < 7); the systems in
    ``bad`` get an eigenvalue of -1 below the gauge block."""
    G = min(6, N - 1)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N))
    S = A @ np.transpose(A, (0, 2, 1)) + 3.0 * np.eye(N)
    for b in bad:
        low = np.linalg.eigvalsh(S[b, G:, G:]).min()
        S[b, G:, G:] -= (low + 1.0) * np.eye(N - G)
    S[:, :G, :] = 0.0
    S[:, :, :G] = 0.0
    S[:, range(G), range(G)] = 1.0
    g = rng.standard_normal((B, N))
    g[:, :G] = 0.0
    return S.astype(np.float32), g.astype(np.float32)


def test_cpu_tensors_take_the_plain_versions():
    ck.reset_counters()
    x = t(images(3, 1, 40, 50))
    ck.detect_maps(x)
    ck.harris_response(x)
    ck.orientation_maps(x)
    ck.akaze_octave(x, torch.ones(1))
    a, b, va, vb, xa, xb = desc_sets(3, 2, 30, 40)
    ck.mutual_nearest(t(a), t(b), t(va), t(vb))
    ck.cholesky_solve(*(t(v) for v in spd_systems(3, 2, 12)))
    # B7 on one window of two poses and three landmarks, each seen by both
    cam = torch.tensor([[0, 1, 0, 1, 0, 1]])
    lm = torch.tensor([[0, 0, 1, 1, 2, 2]])
    w = torch.ones((1, 6))
    ck.schur_reduce(torch.eye(4).repeat(1, 2, 1, 1),
                    torch.tensor([[[0.0, 0.0, 5.0], [1.0, 0.5, 8.0],
                                   [-1.0, 0.2, 6.0]]]),
                    cam, lm, torch.full((1, 6, 3), 600.0), w,
                    torch.tensor([718.856, 718.856, 607.1928, 185.2157,
                                  0.5372]),
                    ba._slot_table(cam, lm, w, 2, 3), torch.full((1,), 1e-4))
    ck.stamp(torch.zeros(2, dtype=torch.int64), 1)
    assert ck.PLAIN_CALLS == dict.fromkeys(ck.KERNELS, 1)
    assert ck.LAUNCHES == dict.fromkeys(ck.KERNELS, 0)


def test_cpu_stamps_rise():
    """The clock stamp on the CPU writes the host's perf_counter_ns into
    its slot and leaves the others: stamps taken in turn do not fall."""
    buf = torch.full((4,), -1, dtype=torch.int64)
    for i in (0, 2, 3):
        ck.stamp(buf, i)
    assert buf[1] == -1
    assert 0 < buf[0] <= buf[2] <= buf[3]


BAD_STAMPS = {"dtype": (torch.zeros(3, dtype=torch.float64), 0),
              "ndim": (torch.zeros((3, 1), dtype=torch.int64), 0),
              "slot": (torch.zeros(3, dtype=torch.int64), 3),
              "negative": (torch.zeros(3, dtype=torch.int64), -1)}


@pytest.mark.parametrize("case", sorted(BAD_STAMPS))
def test_stamp_rejects(case):
    buf, i = BAD_STAMPS[case]
    with pytest.raises(ValueError, match="stamp"):
        ck.stamp(buf, i)


BAD_IMAGES = {"ndim": torch.zeros((4, 5)),
              "dtype": torch.zeros((1, 8, 8), dtype=torch.float64),
              "device": torch.zeros((1, 8, 8), device="meta")}


@pytest.mark.parametrize("case", ["ndim", "dtype", "device"])
def test_detect_maps_rejects_bad_input(case):
    with pytest.raises(ValueError):
        ck.detect_maps(BAD_IMAGES[case])


@pytest.mark.parametrize("kernel", ["harris_response", "orientation_maps",
                                    "akaze_octave"])
@pytest.mark.parametrize("case", ["ndim", "dtype", "device"])
def test_image_kernels_reject_bad_input(case, kernel):
    args = (torch.ones(1),) if kernel == "akaze_octave" else ()
    with pytest.raises(ValueError):
        getattr(ck, kernel)(BAD_IMAGES[case], *args)


@pytest.mark.parametrize("case", ["shape", "mask", "window", "device"])
def test_mutual_nearest_rejects_bad_input(case):
    a, b, va, vb, xa, xb = (t(x) for x in desc_sets(4, 2, 10, 12))
    args = {"shape": (a, b[:, :, :64], va, vb),
            "mask": (a, b, va.float(), vb),
            "window": (a, b, va, vb, None, None, WINDOW),
            "device": (a.to("meta"), b.to("meta"), va.to("meta"),
                       vb.to("meta"))}[case]
    with pytest.raises(ValueError):
        ck.mutual_nearest(*args)


@pytest.mark.parametrize("case", ["shape", "rhs", "dtype", "device"])
def test_cholesky_solve_rejects_bad_input(case):
    S, g = (t(v) for v in spd_systems(4, 2, 12))
    args = {"shape": (S[:, :, :6], g), "rhs": (S, g[:, :6]),
            "dtype": (S.double(), g.double()),
            "device": (S.to("meta"), g.to("meta"))}[case]
    with pytest.raises(ValueError):
        ck.cholesky_solve(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.build()


def test_probe_script_finds_its_cut_points():
    """scripts/probe_kernels_cuda.py measures copies of the kernels'
    sources, rewritten at fixed lines: every line it rewrites is still
    there (B6's barriers, B2's and B1's cuts, a mark after each barrier of
    B5 and of B1), and without a card it exits 1
    before building anything."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "probe_kernels_cuda.py"
    spec = importlib.util.spec_from_file_location("probe_kernels_cuda", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    marks = probe.instrumented_b6().count("clock64()")
    assert marks == 1 + len(probe.B6_PHASES)
    for cuts in probe.B2_CUTS.values():
        src = probe.b2_variant(cuts)
        assert all(new in src for _, new in cuts)
    for cuts in probe.B1_CUTS.values():
        src = probe.cut_variant("detect_maps.cu", cuts)
        assert all(new in src for _, new in cuts)
    want = {"detect_maps.cu": ["lines zeroed", "lines of iteration t written",
                               "of t + 1", "of t + 2", "of t + 3", "end"],
            "akaze_octave.cu": ["load", "diffusion steps", "Hessian response",
                                "end"]}
    for name, phases in want.items():
        src, labels = probe.with_barrier_marks(
            (probe.CSRC / name).read_text())
        assert [l.split(" ", 1)[-1] for l in labels] == phases
        assert src.count("PROF_MARK(") == 1 + len(phases)  # and the macro
        assert src.count("PROF_START;") == 1
    if not torch.cuda.is_available():
        assert probe.main([]) == 1


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# widths around one and two of B1's blocks of at most 246 columns, heights
# around one and two of its chunks of at least 32 rows, an image narrower
# than a warp, and one frame at the frontend's size
MAPS_SHAPES = [(2, 100, 333), (3, 64, 64), (1, 37, 41), (1, 31, 245),
               (1, 32, 246), (1, 33, 247), (2, 63, 491), (1, 64, 492),
               (1, 65, 493), (1, 40, 9), (1, 376, 1241)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAPS_SHAPES)
def test_cuda_detect_maps_matches_plain(cuda, shape):
    """Over the whole image (the kernel follows the plain version's edge
    semantics): resp within 1e-5 of max |resp|, maps within 1e-5 of max
    |maps| for all but 0.1% of values (8-bin boundary flips), NMS equal
    away from ties."""
    x = t(images(5, *shape), device=cuda)
    ck.reset_counters()
    r_k, n_k, m_k = ck.detect_maps(x)
    assert ck.LAUNCHES["detect_maps"] == 1
    r_p, n_p, m_p = ck.detect_maps_plain(x)
    torch.cuda.synchronize()
    scale = float(r_p.abs().max())
    assert float((r_k - r_p).abs().max()) <= 1e-5 * scale
    m_bad = ((m_k - m_p).abs() > 1e-5 * float(m_p.abs().max())).float()
    assert float(m_bad.mean()) <= 1e-3
    mism = (torch.isfinite(n_k) != torch.isfinite(n_p)).cpu().numpy()
    assert not (mism & ~near_tie(r_p.cpu())).any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("sizes", [(4, 2048, 2048, 128), (3, 1500, 1777, 128),
                                   (2, 1, 65, 128), (1, 130, 3, 128),
                                   (2, 300, 200, 32), (2, 200, 300, 256),
                                   (2, 300, 200, 16), (3, 100, 700, 128),
                                   (3, 700, 40, 64), (2, 2500, 2500, 128)])
def test_cuda_mutual_nearest_matches_plain(cuda, window, sizes):
    """Distances within 1e-5, indices equal where not tied, for ragged
    sizes (Ka or Kb below one tile of 128 rows or 64 columns, and the
    SIFT configuration's K = 2500, no multiple of a tile) and descriptor
    widths 16 to 256."""
    a, b, va, vb, xa, xb = (t(x, device=cuda) for x in desc_sets(6, *sizes))
    rd, ri, cd, ci = ck.mutual_nearest(a, b, va, vb, xa, xb, window)
    rd_p, ri_p, cd_p, ci_p = ck.mutual_nearest_plain(a, b, va, vb, xa, xb,
                                                     window)
    torch.cuda.synchronize()
    assert float((rd - rd_p).abs().max()) <= 1e-5
    assert float((cd - cd_p).abs().max()) <= 1e-5
    base = ck.window_distances(a, b, xa, xb, window)
    if sizes[2] > 1:
        row_ok = decided(base, torch.where(vb, 0.0, ck.BIG)[:, None, :], 2)
        assert torch.equal(ri[row_ok], ri_p[row_ok])
    if sizes[1] > 1:
        col_ok = decided(base, torch.where(va, 0.0, ck.BIG)[:, :, None], 1)
        assert torch.equal(ci[col_ok], ci_p[col_ok])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAPS_SHAPES)
def test_cuda_harris_and_orientation_match_plain(cuda, shape):
    """B4 and B3, B1's phases alone, with B1's tolerances over the whole
    image; each launches once."""
    x = t(images(7, *shape), device=cuda)
    ck.reset_counters()
    r_k, n_k = ck.harris_response(x)
    m_k = ck.orientation_maps(x)
    assert ck.LAUNCHES["harris_response"] == ck.LAUNCHES[
        "orientation_maps"] == 1
    r_p, n_p = ck.harris_response_plain(x)
    m_p = ck.orientation_maps_plain(x)
    torch.cuda.synchronize()
    assert float((r_k - r_p).abs().max()) <= 1e-5 * float(r_p.abs().max())
    mism = (torch.isfinite(n_k) != torch.isfinite(n_p)).cpu().numpy()
    assert not (mism & ~near_tie(r_p.cpu())).any()
    m_bad = ((m_k - m_p).abs() > 1e-5 * float(m_p.abs().max())).float()
    assert float(m_bad.mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", [(2, 100, 333), (2, 47, 156), (1, 13, 9),
                                   (1, 63, 71), (1, 64, 72), (1, 65, 73),
                                   (2, 127, 143), (1, 128, 144),
                                   (1, 129, 145), (1, 30, 20),
                                   (1, 376, 1241)])
def test_cuda_akaze_octave_matches_plain(cuda, shape, steps):
    """B5 over the whole image, wrap included (images smaller than the
    halo'd tile wrap more than once): L within 1e-5 of max |L|, resp
    within 1e-4 of max |resp|, the NMS pattern equal away from near-ties.
    Sizes around one and two of its 72 x 64 tiles, narrower than a tile,
    and one frame at the frontend's size; 6 steps take the compile-time
    path, the other counts the run-time one."""
    x = t(images(8, *shape), device=cuda)
    k = torch.linspace(0.05, 0.2, shape[0], device=cuda)
    ck.reset_counters()
    L_k, r_k, n_k = ck.akaze_octave(x, k, steps, sigma=3.2)
    assert ck.LAUNCHES["akaze_octave"] == 1
    L_p, r_p, n_p = ck.akaze_octave_plain(x, k, steps, sigma=3.2)
    torch.cuda.synchronize()
    assert float((L_k - L_p).abs().max()) <= 1e-5 * float(L_p.abs().max())
    assert float((r_k - r_p).abs().max()) <= 1e-4 * float(r_p.abs().max())
    mism = (torch.isfinite(n_k) != torch.isfinite(n_p)).cpu().numpy()
    assert not (mism & ~near_tie(r_p.cpu())).any()


@pytest.mark.cuda
def test_cuda_akaze_octave_rejects_too_many_steps(cuda):
    x = torch.rand((1, 40, 60), device=cuda)
    k = torch.ones(1, device=cuda)
    top = ck.build().slam_akaze_max_steps()
    assert top == ck.akaze_max_steps >= 13
    ck.akaze_octave(x, k, top)
    with pytest.raises(ValueError, match="shared memory"):
        ck.akaze_octave(x, k, top + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 144, 144), (1, 12, 12), (7, 48, 48),
                                   (5, 1, 1), (3, 16, 16), (3, 17, 17),
                                   (3, 32, 32), (3, 33, 33), (3, 145, 145),
                                   (3, "max_n", "max_n")])
def test_cuda_cholesky_solve_matches_plain(cuda, shape):
    """B6 against the float64 solution: its error relative to max |x| per
    system at most 4x the plain version's + 1e-6; one launch. N from 1
    to the largest N it takes, on both sides of the one-warp variant's
    N <= 32 and of its 32-wide blocks."""
    N = shape[1]
    if N == "max_n":
        ck.build()
        N = ck.cholesky_max_n
    S, g = (t(v, device=cuda) for v in spd_systems(9, shape[0], N))
    ck.reset_counters()
    x_k = ck.cholesky_solve(S, g)
    assert ck.LAUNCHES["cholesky_solve"] == 1
    x_p = ck.cholesky_solve_plain(S, g)
    x_64 = torch.linalg.solve(S.double(), g.double())
    torch.cuda.synchronize()
    scale = x_64.abs().amax(-1)
    e_k = float(((x_k - x_64).abs().amax(-1) / scale).max())
    e_p = float(((x_p - x_64).abs().amax(-1) / scale).max())
    assert e_k <= 4.0 * e_p + 1e-6, (e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("N, pivot", [(48, None), (144, 10), (144, 140),
                                      (12, 9)])
def test_cuda_cholesky_solve_nan_row(cuda, N, pivot):
    """A system that is not positive definite gets an all-NaN row, as in
    the plain version; the other rows equal B6's solve of them alone. It
    fails part way (an eigenvalue of -1), or at a decoupled pivot of -1 in
    the first or the last 32-wide block, or in the one-warp variant."""
    S, g = spd_systems(10, 8, N, bad=(3,) if pivot is None else ())
    if pivot is not None:
        S[3, pivot, :] = 0.0
        S[3, :, pivot] = 0.0
        S[3, pivot, pivot] = -1.0
    S, g = t(S, device=cuda), t(g, device=cuda)
    x = ck.cholesky_solve(S, g)
    x_p = ck.cholesky_solve_plain(S, g)
    keep = [0, 1, 2, 4, 5, 6, 7]
    x_rest = ck.cholesky_solve(S[keep].contiguous(), g[keep].contiguous())
    torch.cuda.synchronize()
    nan_rows = torch.isnan(x).all(-1).nonzero().flatten().tolist()
    assert nan_rows == [3]
    assert torch.isnan(x_p[3]).all()
    assert torch.equal(x[keep], x_rest)


@pytest.mark.cuda
def test_cuda_cholesky_solve_rejects_large_n(cuda):
    top = ck.build().slam_cholesky_max_n()
    assert top == ck.cholesky_max_n >= 152
    S = torch.eye(top + 1, device=cuda)[None].contiguous()
    g = torch.ones((1, top + 1), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ck.cholesky_solve(S, g)
    x = ck.cholesky_solve(S[:, :top, :top].contiguous(), g[:, :top])
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones_like(x))


@pytest.mark.cuda
def test_cuda_wrappers_reject_non_contiguous(cuda):
    x = torch.rand((2, 40, 60), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        ck.detect_maps(x)
    a = torch.rand((1, 128, 8), device=cuda).transpose(1, 2)
    v = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        ck.mutual_nearest(a, a, v, v)
    S = torch.rand((2, 12, 12), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        ck.cholesky_solve(S, torch.ones((2, 12), device=cuda))


@pytest.mark.cuda
def test_cuda_slice_runs_through_the_kernels(cuda):
    """A small scene through run_pipeline on the card: B1, B2 and, in
    every LM iteration of BA, B6 launched; no plain version run."""
    from slam_tpu_torch import pipeline
    from slam_tpu_torch.config import (BundleConfig, FeatureConfig,
                                       KeyframeConfig, RuntimeConfig,
                                       SlamConfig)
    from slam_tpu_torch.utils import synthetic

    scene = synthetic.make_scene(seed=2, num_frames=12, num_landmarks=3000,
                                 hw=(128, 256))
    L, R = synthetic.render_sequence(scene)
    cfg = SlamConfig(features=FeatureConfig(max_kp=512),
                     runtime=RuntimeConfig(chunk_frames=6),
                     keyframes=KeyframeConfig(min_gap=2, max_gap=6),
                     bundle=BundleConfig(max_poses=8, max_landmarks=256,
                                         max_obs=1024, lm_iters=5))
    ck.reset_counters()
    res = pipeline.run_pipeline(L, R, scene.calib, cfg, verbose=False,
                                run_loop_closure=False, device=cuda)
    assert ck.LAUNCHES["detect_maps"] == 2
    assert ck.LAUNCHES["mutual_nearest"] == 4
    assert ck.LAUNCHES["cholesky_solve"] > 0
    assert ck.LAUNCHES["cholesky_solve"] % cfg.bundle.lm_iters == 0
    assert not any(ck.PLAIN_CALLS.values())
    assert np.isfinite(res.T_frontend).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 752, 2482), (8, 94, 311),
                                   (3, 96, 160)])
def test_cuda_orientation_maps_at_sift_octaves(cuda, shape):
    """B3 on SIFT's octave bases (the x2-upsampled, pre-blurred image at
    KITTI's 752 x 2482, the fourth octave at 94 x 311, a small one) with
    B1's tolerances, and the SIFT detector through B3 on the card: B3
    launched once per octave, no plain version run, and >= 99% of its
    keypoints within 1e-3 px of the CPU run's on the same images (cuDNN's
    blurs round otherwise than the CPU's, which may flip a near-tie)."""
    from slam_tpu_torch.ops import features, sift

    imgs = t(images(11, shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2))
    pre = float((sift.SIGMA0 ** 2 - 1.0) ** 0.5)
    base = features.gaussian_blur(sift.upsample2(imgs.to(cuda)), pre,
                                  sift._blur_radius(pre))
    x = base[..., :shape[1], :shape[2]].contiguous()
    ck.reset_counters()
    m_k = ck.orientation_maps(x)
    m_p = ck.orientation_maps_plain(x)
    torch.cuda.synchronize()
    m_bad = ((m_k - m_p).abs() > 1e-5 * float(m_p.abs().max())).float()
    assert float(m_bad.mean()) <= 1e-3
    if shape[1] > 100:
        return
    ck.reset_counters()
    out = sift.detect_and_describe_sift_batch(imgs.to(cuda), max_kp=512,
                                              octaves=3)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["orientation_maps"] == 3
    assert not any(ck.PLAIN_CALLS.values())
    ref = sift.detect_and_describe_sift_batch(imgs, max_kp=512, octaves=3)
    for f in range(shape[0]):
        a = out["xy"][f][out["valid"][f]].cpu()
        b = ref["xy"][f][ref["valid"][f]]
        assert len(a) > 20 and abs(len(a) - len(b)) <= 0.01 * len(b) + 1
        assert (torch.cdist(a, b).min(dim=1).values < 1e-3).float().mean(
        ) >= 0.99


@pytest.mark.cuda
def test_cuda_sparse_pose_graph_matches_dense_at_2560(cuda):
    """chip_smoke.py's 2560-node stiff graph on the card: the selected
    blocks (every diagonal block but the gauge's, cross blocks of pairs 499
    apart) within 1e-5 of the dense float64 inverse, relative to each
    block's largest entry; optimize moves the nodes, every gate distance
    finite and positive."""
    import chip_smoke
    from slam_tpu_torch.ops import pg_sparse

    N = chip_smoke.PG_NODES
    pg = chip_smoke.stiff_loop_graph(N, "cuda")
    args = pg._sparse_arrays()
    pi = np.arange(17, N - 500, 17)
    qi = torch.as_tensor(np.concatenate([pi, pi + 499]), device=cuda)
    qj = torch.as_tensor(np.concatenate([pi + 499, pi]), device=cuda)
    Cdiag, Cq = pg_sparse.selected_blocks(*args, qi, qj)
    C, _ = chip_smoke.dense_cov64(pg_sparse, args)
    k = torch.arange(1, N, device=cuda)
    for got, want in ((Cdiag[1:], C[k, :, k, :]), (Cq, C[qi, :, qj, :])):
        err = (got.double() - want).abs().amax((1, 2)) / want.abs().amax(
            (1, 2))
        assert float(err.max()) <= 1e-5
    del C
    before = pg.nodes.copy()
    assert np.isfinite(pg.optimize(iters=3))
    assert np.abs(pg.nodes[:, :3, 3] - before[:, :3, 3]).max() > 0.05
    d = pg.gate_distances(pi, pi + 499)
    assert np.isfinite(d).all() and (d > 0).all()

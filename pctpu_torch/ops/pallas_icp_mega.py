"""Whole-loop ICP: every fixed iteration in one launch (port of
`pctpu/ops/pallas_icp_mega.py`). Two TPU kernels share one body there,
`_mega_body`, and so do their ports: `csrc/icp_mega.cu` serves both.

  K4 `icp_mega_batch`: a batch of pairs (`_icp_mega_kernel_batch`);
  kernel 5 `icp_mega`: one pair (`_icp_mega_kernel`), the same CUDA entry
     launched with B = 1.

Each wrapper counts its own launches. One launch is one persistent
cooperative grid over the whole card: `unit_plan` cuts every pair's query
tiles into units that the CTAs share, and a pair's next iteration waits
for the pose its last unit solves (the design is in the source's note).

Each iteration, for each query tile: transform the tile by the current
pose, pick the db window from the LUT (the tile's transformed centre),
associate every query to its nearest db point in the window by
`d2 = pen2 - 2 b.q` (tie-averaged within a `block`-sized db block, strict
`<` across blocks), gate it by `d2 + |q|^2 + qpen < thresh^2`, and add
its homogeneous moments to a 4x4 matrix. After the last tile the 3x3
Procrustes problem is solved in scalars (Newton polar + adjugate flip,
`_s_procrustes_from_moments`) and composed into the pose, unless fewer
than 3 correspondences passed the gate.

The plain version below (of both) runs the same formulas on [B]-batched
tensors, including the same scalar-form Procrustes (not `register.procrustes`'s
matrix form), so kernel and plain agree tightly.
"""
from __future__ import annotations

import ctypes

import torch

from pctpu_torch import kernels
from pctpu_torch.ops.pallas_banded import LUT_BINS

BIG = 1e30


# ---------------------------------------------------------------------------
# scalar-form 3x3 linear algebra on [B] tensors (tuples of tensors),
# a line-for-line transcription of the reference's scalar-register code
# ---------------------------------------------------------------------------

def _s_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _s_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _s_fro2(M):
    return sum(M[i][j] * M[i][j] for i in range(3) for j in range(3))


def _s_matmul(A, B):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3))
                       for j in range(3)) for i in range(3))


def _s_matvec(A, v):
    return tuple(sum(A[i][k] * v[k] for k in range(3)) for i in range(3))


def _s_inv_transpose(X):
    c0 = _s_cross(X[1], X[2])
    c1 = _s_cross(X[2], X[0])
    c2 = _s_cross(X[0], X[1])
    det = _s_dot(X[0], c0)
    safe = torch.where(torch.abs(det) > 1e-30, det,
                       torch.full_like(det, 1e-30))
    inv = 1.0 / safe
    return (tuple(c * inv for c in c0),
            tuple(c * inv for c in c1),
            tuple(c * inv for c in c2)), det


def _s_rotation_polar3(H, newton_iters: int = 6):
    fn = torch.sqrt(torch.clamp_min(_s_fro2(H), 1e-30))
    X = tuple(tuple(h / fn for h in row) for row in H)
    Hn = X
    for _ in range(newton_iters):
        Xit, _ = _s_inv_transpose(X)
        g = torch.sqrt(torch.sqrt(
            _s_fro2(Xit) / torch.clamp_min(_s_fro2(X), 1e-30)))
        gi = 0.5 / g
        gh = 0.5 * g
        X = tuple(tuple(gh * X[i][j] + gi * Xit[i][j] for j in range(3))
                  for i in range(3))
    d = _s_dot(X[0], _s_cross(X[1], X[2]))
    S = tuple(tuple(sum(X[k][i] * Hn[k][j] for k in range(3))
                    for j in range(3)) for i in range(3))
    S = tuple(tuple(0.5 * (S[i][j] + S[j][i]) for j in range(3))
              for i in range(3))
    # least eigenvalue of the SPD S: Newton on the characteristic cubic
    # from 0, which converges monotonically from below
    a = S[0][0] + S[1][1] + S[2][2]
    b = (S[0][0] * S[1][1] - S[0][1] * S[0][1] + S[0][0] * S[2][2]
         - S[0][2] * S[0][2] + S[1][1] * S[2][2] - S[1][2] * S[1][2])
    c = _s_dot(S[0], _s_cross(S[1], S[2]))
    lam = torch.zeros_like(a)
    for _ in range(12):
        f = ((lam - a) * lam + b) * lam - c
        fp = (3.0 * lam - 2.0 * a) * lam + b
        fp = torch.where(torch.abs(fp) > 1e-30, fp,
                         torch.full_like(fp, 1e-30))
        lam = lam - f / fp
    # adj(S - lam I) is rank 1, its columns parallel to the least
    # eigenvector: take the largest-norm cofactor row
    B2 = tuple(tuple(S[i][j] - lam if i == j else S[i][j]
                     for j in range(3)) for i in range(3))
    a0 = _s_cross(B2[1], B2[2])
    a1 = _s_cross(B2[2], B2[0])
    a2 = _s_cross(B2[0], B2[1])
    n0, n1, n2 = _s_dot(a0, a0), _s_dot(a1, a1), _s_dot(a2, a2)
    use0 = (n0 >= n1) & (n0 >= n2)
    use1 = n1 >= n2
    v = tuple(torch.where(use0, a0[i], torch.where(use1, a1[i], a2[i]))
              for i in range(3))
    vn = torch.sqrt(torch.clamp_min(_s_dot(v, v), 1e-30))
    v = tuple(c / vn for c in v)
    Uf = tuple(tuple(X[i][j] - 2.0 * _s_dot(X[i], v) * v[j]
                     for j in range(3)) for i in range(3))
    neg = d < 0
    return tuple(tuple(torch.where(neg, Uf[i][j], X[i][j])
                       for j in range(3)) for i in range(3))


def _s_procrustes_from_moments(m, newton_iters: int = 6):
    """(R, t) from the 16 moments m[a][b] = sum w [p;1]_a [q;1]_b."""
    sw = torch.clamp_min(m[3][3], 1e-12)
    inv_sw = 1.0 / sw
    sp = (m[0][3], m[1][3], m[2][3])
    sq = (m[3][0], m[3][1], m[3][2])
    H = tuple(tuple(m[j][i] - sq[i] * sp[j] * inv_sw for j in range(3))
              for i in range(3))
    R = _s_rotation_polar3(H, newton_iters=newton_iters)
    src_c = tuple(c * inv_sw for c in sp)
    dst_c = tuple(c * inv_sw for c in sq)
    Rs = _s_matvec(R, src_c)
    return R, tuple(dst_c[i] - Rs[i] for i in range(3))


# ---------------------------------------------------------------------------
# the plain version of K4
# ---------------------------------------------------------------------------

def _window_base(pose, scal, centers, lut, i, block, wb, nb):
    """[B] first window block of query tile i (reference `_mega_body`
    :202-218): the tile's transformed centre through the bucket LUT."""
    r = pose
    c0, c1, c2 = (centers[:, 3 * i + k] for k in range(3))
    cx = r[0] * c0 + r[1] * c1 + r[2] * c2 + r[9]
    cy = r[3] * c0 + r[4] * c1 + r[5] * c2 + r[10]
    cz = r[6] * c0 + r[7] * c1 + r[8] * c2 + r[11]
    lo, hi, axf = scal[:, 12], scal[:, 13], scal[:, 14]
    val = torch.where(axf < 0.5, cx, torch.where(axf < 1.5, cy, cz))
    binf = (val - lo) / torch.clamp_min(hi - lo, 1e-12) * LUT_BINS
    bin_ = torch.clamp(binf, 0, LUT_BINS).long()   # trunc of the clipped
    pos = torch.gather(lut, 1, bin_[:, None])[:, 0].long()
    base = torch.div(pos - (wb * block) // 2 + block // 2, block,
                     rounding_mode="floor")
    return torch.clamp(base, 0, nb - wb)


def icp_mega_plain(dbt5, lut, scal, src3, spen, centers, iters: int,
                   thresh2: float, block: int, wb: int, query_tile: int,
                   newton_iters: int = 6) -> torch.Tensor:
    """Plain PyTorch version of K4 -> pose [B,12] (R row-major, t).
    dbt5 [B,5,Np], lut [B,L] i32, scal [B,16], src3 [B,3,Mp],
    spen [B,Mp], centers [B,3*ntiles]. Memory is bounded by one
    [B, block, query_tile] distance tile."""
    b, _, np_ = dbt5.shape
    mp = src3.shape[2]
    tq = query_tile
    nb = np_ // block
    dev = dbt5.device
    pose = [scal[:, s] for s in range(12)]
    ar_blk = torch.arange(block, device=dev)
    for _ in range(iters):
        # f64 moment sums (exact products), rounded once to f32: the
        # result does not depend on the summation order, so the kernel
        # and this version stay on one trajectory
        m44 = torch.zeros((b, 4, 4), dtype=torch.float64, device=dev)
        r = pose
        for i in range(mp // tq):
            base = _window_base(pose, scal, centers, lut, i, block, wb, nb)
            q3 = src3[:, :, i * tq:(i + 1) * tq]
            xt = (r[0][:, None] * q3[:, 0] + r[1][:, None] * q3[:, 1]
                  + r[2][:, None] * q3[:, 2] + r[9][:, None])
            yt = (r[3][:, None] * q3[:, 0] + r[4][:, None] * q3[:, 1]
                  + r[5][:, None] * q3[:, 2] + r[10][:, None])
            zt = (r[6][:, None] * q3[:, 0] + r[7][:, None] * q3[:, 1]
                  + r[8][:, None] * q3[:, 2] + r[11][:, None])
            qn = xt * xt + yt * yt + zt * zt
            qpen = spen[:, i * tq:(i + 1) * tq]
            a0, a1, a2 = -2.0 * xt, -2.0 * yt, -2.0 * zt
            minv = torch.full((b, tq), BIG, dtype=torch.float32, device=dev)
            macc = torch.cat([torch.zeros((b, 3, tq), device=dev),
                              torch.ones((b, 1, tq), device=dev)], dim=1)
            for j in range(wb):
                cols = ((base + j) * block)[:, None] + ar_blk[None, :]
                win = torch.gather(dbt5, 2, cols[:, None, :].expand(b, 5,
                                                                    block))
                wx, wy, wz, wp = (win[:, k, :, None] for k in range(4))
                d2 = ((wx * a0[:, None, :] + wy * a1[:, None, :])
                      + wz * a2[:, None, :]) + wp             # [B,blk,TQ]
                tmin = torch.amin(d2, dim=1)
                sel = (d2 <= tmin[:, None, :]).float()
                win4 = win[:, (0, 1, 2, 4)]
                ext = torch.bmm(win4, sel)                    # [B,4,TQ]
                better = tmin < minv
                minv = torch.where(better, tmin, minv)
                macc = torch.where(better[:, None, :], ext, macc)
            cnt = torch.clamp_min(macc[:, 3], 1.0)
            matched = macc[:, 0:3] / cnt[:, None, :]
            w = ((minv + qn + qpen) < thresh2).float()
            ones = torch.ones_like(xt)
            hp = torch.stack([xt, yt, zt, ones], dim=1) * w[:, None, :]
            hq = torch.cat([matched, ones[:, None, :]], dim=1)
            m44 = m44 + torch.bmm(hp.double(), hq.transpose(1, 2).double())
        m44 = m44.float()
        m = tuple(tuple(m44[:, a, c] for c in range(4)) for a in range(4))
        R, t = _s_procrustes_from_moments(m, newton_iters=newton_iters)
        Told = ((r[0], r[1], r[2]), (r[3], r[4], r[5]), (r[6], r[7], r[8]))
        told = (r[9], r[10], r[11])
        Rn = _s_matmul(R, Told)
        Rt = _s_matvec(R, told)
        tn = tuple(Rt[a] + t[a] for a in range(3))
        # degenerate-iteration guard: Procrustes needs >= 3 correspondences
        ok = m[3][3] >= 3.0
        pose = ([torch.where(ok, Rn[a][c], Told[a][c])
                 for a in range(3) for c in range(3)]
                + [torch.where(ok, tn[a], told[a]) for a in range(3)])
    return torch.stack(pose, dim=1)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

# the kernel's CTA shape (csrc/icp_mega.cu kThreads, kQ): a unit holds
# THREADS * QUERIES_PER_THREAD / lanes queries
THREADS, QUERIES_PER_THREAD, MAX_LANES = 256, 2, 32
# the least units a launch aims for, per SM: on an H100 (4 CTAs per SM)
# `tools/icp_mega_sweep.py` found the fastest lanes at 3.6-3.9 units per
# SM on five of the paths' six shapes
UNITS_PER_SM = 3

_capacity: dict = {}


def card_capacity(device: torch.device) -> tuple:
    """(SMs, CTAs of the kernel the card holds at once) of a CUDA device:
    the largest grid a cooperative launch of it takes."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _capacity:
        fn = kernels.library("icp_mega.cu").pct_icp_mega_capacity
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        ctas = ctypes.c_int(0)
        with torch.cuda.device(idx):
            kernels.check(fn(idx, ctypes.byref(ctas)), "icp_mega capacity")
        _capacity[idx] = (kernels.sm_count(torch.device("cuda", idx)),
                          ctas.value)
    return _capacity[idx]


def unit_plan(bsz: int, mp: int, query_tile: int, sms: int,
              ctas: int) -> dict:
    """How one launch spreads `bsz` pairs of `mp` queries (tiles of
    `query_tile`) over a card of `sms` SMs that holds `ctas` CTAs at once.

    `lanes` (a power of two up to 32) lanes share a query, so a unit holds
    `slice` = THREADS * QUERIES_PER_THREAD / lanes queries of one tile.
    `lanes` is first raised until `slice` divides the tile (no dead query
    slots), then until there are UNITS_PER_SM units per SM. A tile is
    `slices` units, a pair `units_per_pair`; the grid is the units or the
    card's CTAs, whichever is fewer."""
    slots = THREADS * QUERIES_PER_THREAD
    ntiles = mp // query_tile
    lanes = 1
    while lanes < MAX_LANES and query_tile % (slots // lanes):
        lanes *= 2

    def units(ln):
        return bsz * ntiles * -(-query_tile // (slots // ln))
    while lanes < MAX_LANES and units(lanes) < UNITS_PER_SM * sms:
        lanes *= 2
    slc = slots // lanes
    spt = -(-query_tile // slc)
    return dict(lanes=lanes, slice=slc, slices=spt,
                units_per_pair=ntiles * spt, units=units(lanes),
                grid=min(units(lanes), ctas), sms=sms)


def unit_queries(plan: dict, query_tile: int, unit: int) -> list:
    """The query columns (of its pair) that unit `unit` of a pair holds,
    in the kernel's thread order: slice q0 of tile t, query
    q0 + s * (THREADS / lanes) + group for s < QUERIES_PER_THREAD, where
    it lies in the tile."""
    groups = THREADS // plan["lanes"]
    tile, sl = divmod(unit, plan["slices"])
    q0 = sl * plan["slice"]
    return [tile * query_tile + q0 + s * groups + g
            for s in range(QUERIES_PER_THREAD) for g in range(groups)
            if q0 + s * groups + g < query_tile]


def launch_plan(args) -> dict:
    """`unit_plan` of one launch, from the argument tuple of
    `icp_mega_plain` / `_launch_icp_mega` on a CUDA device."""
    dbt5, src3, tq = args[0], args[3], args[10]
    sms, ctas = card_capacity(dbt5.device)
    return unit_plan(src3.shape[0], src3.shape[2], tq, sms, ctas)


def _launch_icp_mega(dbt5, lut, scal, src3, spen, centers, iters: int,
                     thresh2: float, block: int, wb: int, query_tile: int,
                     newton_iters: int = 6) -> torch.Tensor:
    """Launch `csrc/icp_mega.cu` on CUDA tensors (the layouts of
    `icp_mega_plain`) -> pose [B,12]: one cooperative launch of
    `launch_plan`'s grid; raises if the card refuses it."""
    b, _, np_ = dbt5.shape
    mp = src3.shape[2]
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda("icp_mega", dbt5, src3, spen, lut, centers, scal,
                         dtypes=(f32, f32, f32, i32, f32, f32))
    dev = dbt5.device
    plan = unit_plan(b, mp, query_tile, *card_capacity(dev))
    out = torch.empty((b, 16), dtype=f32, device=dev)
    part = torch.empty((b, plan["units_per_pair"], 16), dtype=torch.float64,
                       device=dev)
    poses = torch.empty((b, 12), dtype=f32, device=dev)
    cnt = torch.empty((2, b), dtype=i32, device=dev)    # counts, versions
    fn = kernels.entry("icp_mega.cu", "pct_icp_mega", n_ptr=11, n_int=11,
                       n_float=1)
    kernels.check(fn(dbt5.data_ptr(), src3.data_ptr(), spen.data_ptr(),
                     lut.data_ptr(), centers.data_ptr(), scal.data_ptr(),
                     out.data_ptr(), part.data_ptr(), poses.data_ptr(),
                     cnt[0].data_ptr(), cnt[1].data_ptr(), b, np_, mp,
                     block, wb, query_tile, iters, newton_iters,
                     LUT_BINS + 1, plan["lanes"], plan["grid"], thresh2,
                     kernels.stream_ptr(dev)),
                  "icp_mega")
    return out[:, :12]


def _mega_args(dbt5, lut, lo, hi, axis, src3, spen, centers, init_T,
               iters, dist_thresh, block, window_blocks, query_tile,
               newton_iters):
    """The [B]-batched argument tuple of `icp_mega_plain` and
    `_launch_icp_mega`; raises on shapes the kernel does not take."""
    bsz, five, np_ = dbt5.shape
    mp = src3.shape[2]
    dev = src3.device
    scal = torch.cat([
        init_T[:, :3, :3].reshape(bsz, 9), init_T[:, :3, 3],
        lo.reshape(bsz, 1), hi.reshape(bsz, 1),
        axis.float().reshape(bsz, 1),
        torch.zeros((bsz, 1), dtype=torch.float32, device=dev)],
        dim=1).float().contiguous()
    nb = np_ // block
    wb = min(window_blocks, nb)
    args = (dbt5.float().contiguous(),
            lut.reshape(bsz, -1).int().contiguous(), scal,
            src3.float().contiguous(),
            spen.reshape(bsz, -1).float().contiguous(),
            centers.reshape(bsz, -1).float().contiguous(),
            iters, float(dist_thresh) ** 2, block, wb, query_tile,
            newton_iters)
    if (five != 5 or np_ % block or mp % query_tile or wb < 1
            or src3.shape != (bsz, 3, mp) or args[4].shape != (bsz, mp)
            or args[1].shape != (bsz, LUT_BINS + 1)
            or args[5].shape != (bsz, 3 * (mp // query_tile))):
        raise ValueError("icp_mega: bad shapes or tiling")
    return args


def _pose_to_T(pose: torch.Tensor) -> torch.Tensor:
    """[B,12] (R row-major, t) -> [B,4,4]."""
    bsz = pose.shape[0]
    T = torch.eye(4, dtype=torch.float32, device=pose.device).repeat(bsz, 1, 1)
    T[:, :3, :3] = pose[:, :9].reshape(bsz, 3, 3)
    T[:, :3, 3] = pose[:, 9:12]
    return T


def pack_dbt5(bdb) -> torch.Tensor:
    """[5,Np] (or [B,5,Np]) packed db for the mega kernels: rows x, y, z,
    pen2, ones."""
    return torch.cat([bdb.dbt, bdb.pen2, torch.ones_like(bdb.pen2)], dim=-2)


def _single_args(bdb, src3, spen, centers, init_T, iters=30,
                 dist_thresh=5.0, block=512, window_blocks=4,
                 query_tile=256, newton_iters=6):
    """`icp_mega`'s arguments as the B = 1 tuple of `icp_mega_plain`."""
    return _mega_args(pack_dbt5(bdb)[None], bdb.lut[None], bdb.lo, bdb.hi,
                      bdb.axis, src3[None], spen, centers, init_T[None],
                      iters, dist_thresh, block, window_blocks, query_tile,
                      newton_iters)


def icp_mega(bdb, src3: torch.Tensor, spen: torch.Tensor,
             centers: torch.Tensor, init_T: torch.Tensor, iters: int = 30,
             dist_thresh: float = 5.0, block: int = 512,
             window_blocks: int = 4, query_tile: int = 256,
             newton_iters: int = 6) -> torch.Tensor:
    """Kernel 5: `iters` full ICP iterations of ONE pair in one launch;
    returns T [4,4].

    bdb: the single-db `BandedDB`; src3 [3,Mp] SORTED source points
    (pre-transform, padded to a query_tile multiple); spen [1,Mp] 0 valid
    / BIG pad; centers [1,3*ntiles] per-tile centre source coords. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    persistent grid) or raise."""
    args = _single_args(bdb, src3, spen, centers, init_T, iters,
                        dist_thresh, block, window_blocks, query_tile,
                        newton_iters)
    if src3.device.type == "cpu":
        pose = icp_mega_plain(*args)
    else:
        pose = _launch_icp_mega(*args)
        icp_mega.launches += 1
    return _pose_to_T(pose)[0]


icp_mega.launches = 0


def icp_mega_batch(dbt5: torch.Tensor, lut: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, axis: torch.Tensor,
                   src3: torch.Tensor, spen: torch.Tensor,
                   centers: torch.Tensor, init_T: torch.Tensor,
                   iters: int = 30, dist_thresh: float = 5.0,
                   block: int = 512, window_blocks: int = 4,
                   query_tile: int = 256,
                   newton_iters: int = 6) -> torch.Tensor:
    """K4: batched whole-loop ICP, one launch for the whole pair sweep.

    Layouts (leading B on everything, as the reference): dbt5 [B,5,Np]
    packed db (x, y, z, pen2, ones), lut [B,1,LUT_BINS+1], lo/hi [B]
    band-axis range, axis [B] sort axis, src3 [B,3,Mp], spen [B,1,Mp],
    centers [B,1,3*ntiles], init_T [B,4,4]. Returns [B,4,4]. CPU tensors
    take the plain version; CUDA tensors launch the kernel (one
    persistent grid over all pairs) or raise."""
    args = _mega_args(dbt5, lut, lo, hi, axis, src3, spen, centers,
                      init_T.float(), iters, dist_thresh, block,
                      window_blocks, query_tile, newton_iters)
    if src3.device.type == "cpu":
        pose = icp_mega_plain(*args)
    else:
        pose = _launch_icp_mega(*args)
        icp_mega_batch.launches += 1
    return _pose_to_T(pose)


icp_mega_batch.launches = 0

"""Line-feature frontend: detection + LBD descriptors + matching.

Counterpart of `plslam/models/frontend_lines.py` (the reference's
`linefeature_tracker.cpp` + `LSDDetector::detect`, `BinaryDescriptor::compute`,
`BinaryDescriptorMatcher`), function by function under the same names:
  1. Scharr gradients → magnitude, orientation and a thin (NMS) edge mask;
  2. a tiled windowed Hough detector: 64×64 tiles at stride 48 (cut with one
     gather), an edge-weighted [θ × ρ] accumulator per tile as one batched
     matmul, the top-4 peaks of every tile evaluated as one batch, then
     near-duplicate suppression across tiles and octaves;
  3. a band LBD float descriptor (9 bands × 8 statistics), optionally
     binarized to 256 bits and matched by packed Hamming distance through
     `plslam_torch.ops.kernels.hamming` (the Hopper kernel on the card, its
     plain version on the CPU), else matched by cosine;
  4. mutual-best + geometric gating and line-id propagation on the device.

Numerics kept equal to the JAX package: the Hough weights are rounded
through bfloat16 when the frontend runs in float32 (the JAX matmul takes
bf16 inputs with an f32 result) and multiplied in float32, so only the
summation order differs; top-k and argsort break ties by the lower index
(stable sorts); the LBD std is the population std; the 256 test pairs come
from the same `default_rng(31)` permutation.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as tnf

from plslam_torch.models.frontend_points import build_pyramid
from plslam_torch.ops.cameras import PinholeRadTan, cam_to, lift
from plslam_torch.ops.kernels.hamming import hamming_matrix
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy, resolve_device

TILE = 64
TILE_STRIDE = 48
N_THETA = 32
N_RHO = 40
TOP_K = 4
N_BANDS = 9
BAND_W = 3  # pixels per band across the line
LBD_SAMPLES = 32  # samples along the line
_RHO_MAX = float(TILE) * 0.75
_DRHO = float(2 * _RHO_MAX / N_RHO)


def _pymod(x, m: float):
    """Python-style float modulo, computed as `jnp.remainder` does (fmod,
    then + m where the signs differ)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _norm(x):
    """Euclidean norm over the last axis (sqrt of the sum of squares)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


# ---------------------------------------------------------------- gradients
def _scharr(img):
    kx = [[-3.0 / 32, 0.0, 3.0 / 32], [-10.0 / 32, 0.0, 10.0 / 32], [-3.0 / 32, 0.0, 3.0 / 32]]
    ky = [list(r) for r in zip(*kx)]
    pad = tnf.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return _conv3(pad, kx, img.shape), _conv3(pad, ky, img.shape)


def _conv3(padded, k, shape):
    H, W = shape
    out = torch.zeros(shape, dtype=padded.dtype, device=padded.device)
    for dy in range(3):
        for dx in range(3):
            out = out + k[dy][dx] * padded[dy:dy + H, dx:dx + W]
    return out


def _edge_map(img):
    """`edge_map` plus the Scharr gradients it starts from."""
    gx, gy = _scharr(img)
    mag = torch.hypot(gx, gy)
    # direction-quantized non-max suppression (4 directions)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    d = torch.round(ang / (math.pi / 4.0)).to(torch.int32) % 4  # 0:E 1:NE 2:N 3:NW
    pm = tnf.pad(mag, (1, 1, 1, 1))
    H, W = img.shape
    na = torch.where(d == 0, pm[1:H + 1, 2:], torch.where(
        d == 1, pm[2:, 2:], torch.where(d == 2, pm[2:, 1:W + 1], pm[2:, :W])))
    nb = torch.where(d == 0, pm[1:H + 1, :W], torch.where(
        d == 1, pm[:H, :W], torch.where(d == 2, pm[:H, 1:W + 1], pm[:H, 2:])))
    thin = (mag >= na) & (mag >= nb)
    edge = thin & (mag > 4.0 * torch.mean(mag))
    return mag, ang, edge, gx, gy


def edge_map(img):
    """Gradient magnitude + orientation + thin (NMS) edge mask."""
    return _edge_map(img)[:3]


# ------------------------------------------------------------------- Hough
def _tile_starts(size, tile, stride):
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] != size - tile and size > tile:
        starts.append(size - tile)
    return starts


@functools.lru_cache(maxsize=None)
def _hough_consts(dtype, device):
    """θ grid, ρ bin edges, the tile's centred pixel grid and the static
    one-hot ρ-bin membership [NT, NR, P] of every (θ, pixel)."""
    thetas = torch.as_tensor(np.linspace(0.0, np.pi, N_THETA, endpoint=False), device=device)
    thetas = thetas.to(dtype)
    ct, st = torch.cos(thetas), torch.sin(thetas)
    rho_edges = torch.as_tensor(np.linspace(-_RHO_MAX, _RHO_MAX, N_RHO + 1), device=device)
    rho_edges = rho_edges.to(dtype)
    ar = torch.arange(TILE, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    xc = (xx - TILE / 2.0).reshape(-1)
    yc = (yy - TILE / 2.0).reshape(-1)
    rho = xc[:, None] * ct[None, :] + yc[:, None] * st[None, :]  # [P,NT]
    rbin = torch.clamp(((rho + _RHO_MAX) / _DRHO).to(torch.int32), 0, N_RHO - 1)
    onehot = (rbin[:, :, None] == torch.arange(N_RHO, device=device)).to(dtype).permute(1, 2, 0)
    return thetas, ct, st, rho_edges, xc, yc, onehot.contiguous()


@functools.lru_cache(maxsize=None)
def _tile_grid(h: int, w: int, device):
    """Row/column gather indices of the [T,TILE,TILE] tiles of an h×w image
    and the tiles' top-left corners ty, tx [T] (made once: a host list
    copied to the card would wait for the queue)."""
    ys = _tile_starts(h, TILE, TILE_STRIDE)
    xs = _tile_starts(w, TILE, TILE_STRIDE)
    ty = torch.as_tensor([y for y in ys for _ in xs], device=device)
    tx = torch.as_tensor([x for _ in ys for x in xs], device=device)
    r = torch.arange(TILE, device=device)
    return (ty[:, None] + r)[:, :, None], (tx[:, None] + r)[:, None, :], ty, tx


def _suppress_similar(segs, score, ok, mid_thresh: float, tie_by_index: bool):
    """Drop every candidate that a strictly better valid one (ties: lower
    index, when `tie_by_index`) lies near in angle and midpoint."""
    mid = 0.5 * (segs[:, 0:2] + segs[:, 2:4])
    dvec = segs[:, 2:4] - segs[:, 0:2]
    angs = _pymod(torch.atan2(dvec[:, 1], dvec[:, 0]), math.pi)
    d_mid = _norm(mid[:, None, :] - mid[None, :, :])
    d_ang = torch.abs(_pymod(angs[:, None] - angs[None, :] + math.pi / 2, math.pi) - math.pi / 2)
    similar = (d_mid < mid_thresh) & (d_ang < 0.12)
    better = score[None, :] > score[:, None]
    if tie_by_index:
        idx = torch.arange(segs.shape[0], device=segs.device)
        better = better | ((score[None, :] == score[:, None]) & (idx[None, :] < idx[:, None]))
    return ok & ~torch.any(similar & better & ok[None, :], dim=1)


def detect_segments(mag, ang, edge, h: int, w: int, max_out: int = 96,
                    min_support: float = 18.0, min_len: float = 24.0):
    """Tiled Hough line-segment detection. Returns (segs [max_out,4] pixel
    endpoints (sx,sy,ex,ey), score [max_out], valid [max_out])."""
    dtype, dev = mag.dtype, mag.device
    thetas, ct, st, rho_edges, xc, yc, onehot = _hough_consts(dtype, dev)
    rows, cols, ty, tx = _tile_grid(h, w, dev)
    tile_mag = (mag * edge)[rows, cols]  # [T,TILE,TILE], one gather
    tile_ang = ang[rows, cols]
    T = tile_mag.shape[0]

    # edge-pixel weights, orientation-gated per θ: a line at angle θ_line has
    # its gradient ⟂ to it, so the gradient angle ≈ θ (the normal)
    pix_w = tile_mag.reshape(T, -1)  # [T,P]
    pa = tile_ang.reshape(T, -1)
    dth = torch.abs(_pymod((pa[..., None] - thetas) + math.pi / 2, math.pi) - math.pi / 2)
    gate = dth < (np.pi / N_THETA) * 1.5
    if dtype == torch.float32:  # the JAX matmul's bf16 inputs, f32 result
        pix_w = pix_w.to(torch.bfloat16).to(dtype)
    wgt_all = pix_w[..., None] * gate.to(dtype)  # [T,P,NT]
    # acc[θ,r,t] = Σ_p 1[rbin(p,θ)=r]·wgt[t,p,θ]: one batched matmul over θ
    acc = torch.bmm(onehot, wgt_all.permute(2, 1, 0))  # [NT,NR,T]
    flat = acc.permute(2, 0, 1).reshape(T, -1)
    top = torch.sort(flat, dim=1, descending=True, stable=True).indices[:, :TOP_K]  # [T,K]
    th_i = top // N_RHO
    rh_i = top % N_RHO

    # every (tile, peak) candidate as one batch [T,K,·]
    rho0 = (rho_edges[rh_i] + 0.5 * _DRHO)[..., None]
    c, s = ct[th_i][..., None], st[th_i][..., None]
    w_tk = torch.gather(wgt_all.permute(0, 2, 1), 1,
                        th_i[:, :, None].expand(T, TOP_K, wgt_all.shape[1]))  # [T,K,P]
    # supporting pixels: near the line & orientation-gated
    d_line = xc * c + yc * s - rho0
    sup = (torch.abs(d_line) < 1.5) * w_tk
    pos = sup > 0
    sup_cnt = torch.sum(pos, dim=-1)
    # extent along the line direction (-s, c)
    tpos = -xc * s + yc * c
    wsum = torch.sum(sup, dim=-1)
    big = 1e9
    tmin = torch.amin(torch.where(pos, tpos, torch.full_like(tpos, big)), dim=-1)
    tmax = torch.amax(torch.where(pos, tpos, torch.full_like(tpos, -big)), dim=-1)
    rho0, c, s = rho0[..., 0], c[..., 0], s[..., 0]
    offx = (tx.to(dtype) + TILE / 2)[:, None]
    offy = (ty.to(dtype) + TILE / 2)[:, None]
    segs = torch.stack([rho0 * c - tmin * s + offx, rho0 * s + tmin * c + offy,
                        rho0 * c - tmax * s + offx, rho0 * s + tmax * c + offy], dim=-1)
    length = tmax - tmin
    # density gate: supporting pixels per unit length (thin edges → ≈1)
    dens = sup_cnt / torch.clamp(length, min=1.0)
    ok = (length > min_len) & (sup_cnt > min_support) & (dens > 0.6)
    segs, score, ok = segs.reshape(-1, 4), wsum.reshape(-1), ok.reshape(-1)

    # cross-tile near-duplicate suppression
    keep = _suppress_similar(segs, score, ok, 16.0, tie_by_index=False)
    order = torch.argsort(-(score * keep), stable=True)[:max_out]
    return segs[order], score[order], keep[order]


def merge_candidates(segs, score, valid, max_out: int):
    """Cross-octave near-duplicate suppression (strictly better, ties by the
    lower index). Returns (segs [max_out,4], score [max_out], valid
    [max_out]) sorted by score."""
    keep = _suppress_similar(segs, score, valid, 20.0, tie_by_index=True)
    order = torch.argsort(-(score * keep), stable=True)[:max_out]
    return segs[order], score[order] * keep[order], keep[order]


# --------------------------------------------------------------------- LBD
@functools.lru_cache(maxsize=None)
def _lbd_grid(dtype, device):
    t = torch.as_tensor(np.linspace(0.05, 0.95, LBD_SAMPLES), device=device).to(dtype)
    offs = (torch.arange(N_BANDS, dtype=dtype, device=device) - (N_BANDS - 1) / 2.0) * BAND_W
    return t, offs


def _band_stats(x):
    """[N,B,S] → [N,B,4]: mean⁺, mean⁻, population std, mean |x|."""
    return torch.stack([torch.mean(torch.clamp(x, min=0.0), dim=-1),
                        torch.mean(torch.clamp(-x, min=0.0), dim=-1),
                        torch.std(x, dim=-1, correction=0),
                        torch.mean(torch.abs(x), dim=-1)], dim=-1)


def lbd_descriptors(mag_gx, mag_gy, segs, valid):
    """Band-based LBD float descriptor per segment [N, 8*N_BANDS]: LBD_SAMPLES
    points along the line × N_BANDS rows across it; gradients rotated into
    the line frame (d∥, d⊥); per band (mean⁺, mean⁻, std, mean|·|) of d⊥
    then of d∥; L2-normalised."""
    n, dtype = segs.shape[0], segs.dtype
    g2 = torch.stack([mag_gx, mag_gy])  # [2,H,W]
    Himg, Wimg = mag_gx.shape
    t, offs = _lbd_grid(dtype, segs.device)
    p0 = segs[:, 0:2]
    d = segs[:, 2:4] - p0
    L = torch.clamp(_norm(d), min=1e-6)
    u = d / L[:, None]  # along the line
    v = torch.stack([-u[:, 1], u[:, 0]], dim=-1)  # normal
    base = p0[:, None, :] + t[None, :, None] * d[:, None, :]  # [N,S,2]
    pts = base[:, None, :, :] + offs[None, :, None, None] * v[:, None, None, :]  # [N,B,S,2]
    px = pts[..., 0].reshape(n, -1)
    py = pts[..., 1].reshape(n, -1)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    dx = (px - x0)[None]
    dy = (py - y0)[None]
    x0i = torch.clamp(x0.to(torch.int64), 0, Wimg - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, Himg - 2)
    i00 = g2[:, y0i, x0i]
    i01 = g2[:, y0i, x0i + 1]
    i10 = g2[:, y0i + 1, x0i]
    i11 = g2[:, y0i + 1, x0i + 1]
    gs = (i00 * (1 - dx) * (1 - dy) + i01 * dx * (1 - dy)
          + i10 * (1 - dx) * dy + i11 * dx * dy)  # [2,N,B*S]
    gxx = gs[0].reshape(n, N_BANDS, LBD_SAMPLES)
    gyy = gs[1].reshape(n, N_BANDS, LBD_SAMPLES)
    d_par = gxx * u[:, 0, None, None] + gyy * u[:, 1, None, None]
    d_perp = gxx * v[:, 0, None, None] + gyy * v[:, 1, None, None]
    f = torch.cat([_band_stats(d_perp), _band_stats(d_par)], dim=-1).reshape(n, -1)  # [N,B*8]
    desc = f / torch.clamp(_norm(f), min=1e-9)[:, None]
    return desc * valid[:, None]


# fixed band-pair comparison tests (the reference's binary LBD compares the
# SAME statistic between band pairs): 8 stats × C(9,2) = 288 tests, a fixed
# random 256-subset — the same `default_rng(31)` draw as the JAX package
_N_LBD_BITS = 256


def _lbd_pairs():
    pa, pb = [], []
    for s in range(8):
        for b1 in range(N_BANDS):
            for b2 in range(b1 + 1, N_BANDS):
                pa.append(b1 * 8 + s)
                pb.append(b2 * 8 + s)
    pa = np.asarray(pa, np.int32)
    pb = np.asarray(pb, np.int32)
    sel = np.random.default_rng(31).permutation(len(pa))[:_N_LBD_BITS]
    return pa[sel], pb[sel]


_LBD_PA, _LBD_PB = _lbd_pairs()


@functools.lru_cache(maxsize=None)
def _lbd_pair_index(device):
    return (torch.as_tensor(_LBD_PA, dtype=torch.int64, device=device),
            torch.as_tensor(_LBD_PB, dtype=torch.int64, device=device),
            torch.arange(32, device=device))


def binarize_lbd(desc):
    """Float LBD [N,72] → packed 256-bit binary descriptor [N,8] int32
    words carrying the uint32 bit patterns (bit b of word w is test 32w+b)."""
    pa, pb, shifts = _lbd_pair_index(desc.device)
    bits = (desc[:, pa] > desc[:, pb]).to(torch.int64).reshape(-1, _N_LBD_BITS // 32, 32)
    words = torch.sum(bits << shifts, dim=-1)  # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _line_gate(segs1, segs2):
    """Midpoint within 60 px and direction within 0.25 rad."""
    mid1 = 0.5 * (segs1[:, 0:2] + segs1[:, 2:4])
    mid2 = 0.5 * (segs2[:, 0:2] + segs2[:, 2:4])
    d1 = segs1[:, 2:4] - segs1[:, 0:2]
    d2 = segs2[:, 2:4] - segs2[:, 0:2]
    a1 = _pymod(torch.atan2(d1[:, 1], d1[:, 0]), math.pi)
    a2 = _pymod(torch.atan2(d2[:, 1], d2[:, 0]), math.pi)
    d_mid = _norm(mid1[:, None] - mid2[None, :])
    d_ang = torch.abs(_pymod(a1[:, None] - a2[None, :] + math.pi / 2, math.pi) - math.pi / 2)
    return (d_mid < 60.0) & (d_ang < 0.25)


def _mutual(best12, best21, good):
    mutual = best21[best12] == torch.arange(best12.shape[0], device=best12.device)
    return torch.where(mutual & good, best12, torch.full_like(best12, -1))


def match_lbd_binary(desc1, segs1, valid1, desc2, segs2, valid2, max_dist: int = 80):
    """Binary variant of `match_lbd`: packed-bit Hamming distances (the
    Hopper kernel on the card), then the same mutual-best and geometric
    gates, distance < `max_dist`. Ties go to the lower index."""
    dist = hamming_matrix(desc1, desc2)  # [N1,N2] int32
    ok = (valid1[:, None] > 0) & (valid2[None, :] > 0)
    dist = torch.where(ok & _line_gate(segs1, segs2), dist, torch.full_like(dist, 999))
    good = (torch.amin(dist, dim=1) < max_dist) & (valid1 > 0)
    return _mutual(torch.argmin(dist, dim=1), torch.argmin(dist, dim=0), good)


def match_lbd(desc1, segs1, valid1, desc2, segs2, valid2):
    """Mutual-best cosine matching + geometric gating. Returns idx2 [N1]
    (match in frame 2, −1 = none)."""
    sim = desc1 @ desc2.T  # cosine (descriptors are L2-normalised)
    ok = (valid1[:, None] > 0) & (valid2[None, :] > 0)
    sim = torch.where(ok & _line_gate(segs1, segs2), sim, torch.full_like(sim, -2.0))
    good = (torch.amax(sim, dim=1) > 0.75) & (valid1 > 0)
    return _mutual(torch.argmax(sim, dim=1), torch.argmax(sim, dim=0), good)


# ------------------------------------------------------ host orchestration
def tick(cam, img, oct1, state, max_lines: int, octaves: int, binary: bool):
    """One line frame on the device: detection over `octaves` (octave 1 is
    `oct1` when given, else `build_pyramid`'s next level: the 5-tap blur +
    decimation the JAX package computes as a shifted-add convolution),
    merge, LBD, match against the previous frame and id propagation.
    `state` is (segs, desc, valid, ids, next_id). Returns
    (state_new, (bundle [L,5], ids [L]))."""
    prev_segs, prev_desc, prev_valid, prev_ids, next_id = state
    dtype = img.dtype
    all_segs, all_scores, all_valid = [], [], []
    cur = img
    for o in range(octaves):
        mag, ang, edge, gx, gy = _edge_map(cur)
        if o == 0:
            gx0, gy0 = gx, gy
        segs_o, score_o, valid_o = detect_segments(mag, ang, edge, *cur.shape, max_out=max_lines)
        sc = float(2 ** o)
        all_segs.append(segs_o * sc)
        all_scores.append(score_o * sc)
        all_valid.append(valid_o)
        if o + 1 < octaves:
            cur = oct1 if (o == 0 and oct1 is not None) else build_pyramid(cur, 2)[1]
    segs, score, valid = merge_candidates(torch.cat(all_segs), torch.cat(all_scores),
                                          torch.cat(all_valid), max_out=max_lines)
    valid_f = valid.to(dtype)
    desc = lbd_descriptors(gx0, gy0, segs, valid_f)
    if binary:
        desc = binarize_lbd(desc)
        m = match_lbd_binary(prev_desc, prev_segs, prev_valid, desc, segs, valid_f)
    else:
        m = match_lbd(prev_desc, prev_segs, prev_valid, desc, segs, valid_f)
    # id propagation: prev line i matched to cur j carries its id (slot L
    # takes the unmatched and is dropped); unmatched valid cur lines get
    # fresh consecutive ids
    L = max_lines
    ok_m = (m >= 0) & (prev_ids >= 0) & (prev_valid > 0)
    tgt = torch.where(ok_m, m, torch.full_like(m, L))
    ids = torch.full((L + 1,), -1, dtype=torch.int32, device=img.device)
    ids = ids.scatter(0, tgt, prev_ids)[:L]
    newly = valid & (ids < 0)
    rank = (torch.cumsum(newly, 0) - 1).to(torch.int32)
    ids = torch.where(newly, next_id + rank, ids)
    ids = torch.where(valid, ids, torch.full_like(ids, -1))
    next1 = next_id + torch.sum(newly).to(torch.int32)
    # both endpoints in one lift: its Newton undistortion is ~450 small
    # kernels a call, whatever the number of points
    seg_n = lift(cam, segs.reshape(-1, 2)).reshape(-1, 4)
    bundle = torch.cat([seg_n, valid_f[:, None]], dim=1)  # [L,5]
    return (segs, desc, valid_f, ids, next1), (bundle, ids)


def unpack_bundle(bundle: np.ndarray, ids: np.ndarray):
    """(ids, normalized segments [n,4]) of the valid, id-carrying lines."""
    b = bundle.astype(np.float64)
    ids = ids.astype(np.int64)
    out = (b[:, 4] > 0) & (ids >= 0)
    return ids[out], b[out, 0:4]


class FrontendLines:
    """Host orchestration (`LineFeatureTracker` equivalent). Segments,
    descriptors, validity and line ids stay on `device` between frames;
    `process` reads back one bundle when asked to."""

    def __init__(self, cam: PinholeRadTan, max_lines=64, dtype=torch.float32, octaves=2,
                 binary_desc: bool = False, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cam = cam_to(cam, dtype, self.device)
        self.max_lines = max_lines
        self.octaves = octaves  # LSDDetector's scale pyramid (`numOctaves`)
        # binary_desc: match 256-bit binarized LBD by packed Hamming (the
        # reference's BinaryDescriptorMatcher path) instead of float cosine
        self.binary_desc = binary_desc
        self.prev = None  # (segs, desc, valid, ids, next_id)

    def reset(self):
        """Restart the tracker (timestamp-jump restart handshake): no line
        track survives the gap."""
        self.prev = None

    def _initial_state(self):
        L, dev = self.max_lines, self.device
        if self.binary_desc:
            desc0 = torch.zeros((L, _N_LBD_BITS // 32), dtype=torch.int32, device=dev)
        else:
            desc0 = torch.zeros((L, N_BANDS * 8), dtype=self.dtype, device=dev)
        return (torch.zeros((L, 4), dtype=self.dtype, device=dev), desc0,
                torch.zeros((L,), dtype=self.dtype, device=dev),
                torch.full((L,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    def process(self, img, t: float, oct1=None, want_output=True):
        """One frame tick. `img`: a host array or a tensor already on the
        device (the point frontend's pyramid level 0); `oct1`: optional
        shared half-resolution device image (its level 1). Returns (ids,
        normalized segments [n,4]) with `want_output=True`, a `HostCopy`
        handle whose `get()` returns them with `want_output="defer"`, and
        None with `want_output=False`."""
        with timers.span("lines.process"):
            img_d = torch.as_tensor(img).to(device=self.device, dtype=self.dtype)
            oct1_d = None if oct1 is None else oct1.to(device=self.device, dtype=self.dtype)
            if self.prev is None:
                self.prev = self._initial_state()
            self.prev, bundle = tick(self.cam, img_d, oct1_d, self.prev, self.max_lines,
                                     self.octaves, self.binary_desc)
            if not want_output:
                return None
            h = HostCopy(*bundle, unpack=unpack_bundle)
            return h if want_output == "defer" else h.get()

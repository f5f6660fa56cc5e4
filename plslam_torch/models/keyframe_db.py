"""Keyframe database: Shi-Tomasi corners + BRIEF descriptors, the global
place-recognition descriptor, descriptor matching and the PnP-RANSAC check.

Counterpart of `plslam/models/keyframe_db.py` (the reference's
`KeyFrame::computeBRIEFPoint`, `searchByBRIEFDes`, `PnPRANSAC` and the
DBoW2 query, replaced there by a train-free global descriptor: the mean of
sign-random-projected BRIEF bits, L2-normalised, searched exhaustively).

Split of work: the corners, BRIEF tests and global descriptor run on the
image's device as tensor ops; the descriptor distances go through the
Hamming kernel (`plslam_torch.ops.kernels.hamming`) on the card and its
plain version on the CPU; PnP RANSAC and the database query stay host
numpy, as in the JAX package, so that both packages draw the same RANSAC
hypotheses and sort candidates the same way.

Descriptors are [N,8] words of 32 bits. On the host they are uint32 arrays
(the map file's format, the JAX package's); as tensors they are int32
carrying the same bits (`desc_tensor`), which is what the kernel reads.
"""
from __future__ import annotations

import numpy as np
import torch

from plslam_torch.models.frontend_points import _bilinear, _sep_conv, shi_tomasi_grid
from plslam_torch.ops.kernels import hamming as hamming_ops
from plslam_torch.utils import timers

N_BRIEF_BITS = 256
N_BRIEF_WORDS = N_BRIEF_BITS // 32
GDESC_DIM = 128
MAX_KP = 256
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)  # binomial, σ ≈ 1


def _brief_pattern(dtype=np.float32, seed=11, radius=15.0):
    """The fixed random BRIEF test pattern, drawn from the JAX package's seed."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, radius / 2.5, (N_BRIEF_BITS, 2)).clip(-radius, radius)
    b = rng.normal(0, radius / 2.5, (N_BRIEF_BITS, 2)).clip(-radius, radius)
    return a.astype(dtype), b.astype(dtype)


_PAT_A, _PAT_B = _brief_pattern()
_PROJ = np.random.default_rng(23).choice([-1.0, 1.0], (N_BRIEF_BITS, GDESC_DIM)).astype(np.float32)


def desc_tensor(words, device=None) -> torch.Tensor:
    """uint32 descriptor words [N,8] (host) → a contiguous int32 tensor with
    the same bits, the Hamming kernel's input."""
    arr = np.ascontiguousarray(np.asarray(words, np.uint32).reshape(-1, N_BRIEF_WORDS))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def desc_words(t: torch.Tensor) -> np.ndarray:
    """The inverse of `desc_tensor`: int32 tensor → host uint32 words (a
    `host_wait` of the tracer)."""
    timers.count("host_wait")
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def _brief_tests(img, uv):
    """(va, vb): the pre-blurred image sampled at every keypoint's 256 test
    pairs, [N,256] each; bit = va < vb."""
    img = _sep_conv(_sep_conv(img, _K5), _K5)
    pa = torch.as_tensor(_PAT_A, dtype=img.dtype, device=img.device)
    pb = torch.as_tensor(_PAT_B, dtype=img.dtype, device=img.device)
    ax = uv[:, 0:1] + pa[None, :, 0]
    ay = uv[:, 1:2] + pa[None, :, 1]
    bx = uv[:, 0:1] + pb[None, :, 0]
    by = uv[:, 1:2] + pb[None, :, 1]
    return _bilinear(img, ax, ay), _bilinear(img, bx, by)


def brief_descriptors(img, uv, valid):
    """Packed 256-bit BRIEF a keypoint → (int32 words [N,8] carrying the
    uint32 bits, bits [N,256] bool). The image is blurred by two 5-tap
    binomial passes first (σ ≈ 1.5, the cv::BRIEF convention), so that a
    pixel of localisation noise flips few test bits."""
    va, vb = _brief_tests(img, uv)
    bits = (va < vb) & (valid[:, None] > 0)
    words = bits.reshape(-1, N_BRIEF_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, device=img.device, dtype=torch.int64)
    packed = torch.sum(words << shifts, dim=-1)  # [N,8] in [0, 2^32)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)
    return packed, bits


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N1,8] × [N2,8] int32 words → [N1,N2] int32 Hamming distances: the
    hand kernel for CUDA tensors, its plain version for CPU ones. Kept under
    the reference's name (`keyframe_db.hamming_matrix`), which the loop
    search calls."""
    return hamming_ops.hamming_matrix(d1, d2)


def global_descriptor(bits, valid):
    """Mean sign-random-projection of the local BRIEF bit vectors, L2-normalised."""
    f = (bits.to(torch.float32) * 2.0 - 1.0) * (valid[:, None] > 0)
    g = torch.sum(f @ torch.as_tensor(_PROJ, device=bits.device), dim=0)
    return g / torch.clamp(torch.linalg.norm(g), min=1e-9)


def extract_keyframe_features(img, extra_uv=None):
    """Shi-Tomasi corners + BRIEF for a new keyframe (`computeBRIEFPoint`;
    `computeWindowBRIEFPoint` when `extra_uv` carries the estimator's window
    points). `img` is a float32 [H,W] tensor on the device that computes.
    Window points take the first slots of one of two buckets (MAX_KP/4 or
    MAX_KP/2 slots, the JAX package's compiled shapes) and the detector's
    best corners fill the rest, so the bucket decides which corners survive.
    Returns host arrays (uv [MAX_KP,2] float32, valid bool, desc uint32
    [MAX_KP,8], gdesc float32 [128])."""
    dev, dt = img.device, img.dtype
    uv, score = shi_tomasi_grid(img, torch.zeros((1, 2), dtype=dt, device=dev),
                                torch.zeros((1,), dtype=dt, device=dev), cell=16, max_out=MAX_KP)
    valid = (score > 1e-5).to(dt)
    if extra_uv is not None and len(extra_uv):
        nmax = MAX_KP // 4 if len(extra_uv) <= MAX_KP // 4 else MAX_KP // 2
        cnt = min(len(extra_uv), nmax)
        buf = np.zeros((nmax, 2), np.float32)
        buf[:cnt] = np.asarray(extra_uv[:cnt], np.float32)
        vbuf = np.zeros((nmax,), np.float32)
        vbuf[:cnt] = 1.0
        uv = torch.cat([torch.as_tensor(buf, dtype=dt, device=dev), uv[: MAX_KP - nmax]])
        valid = torch.cat([torch.as_tensor(vbuf, dtype=dt, device=dev), valid[: MAX_KP - nmax]])
    desc, bits = brief_descriptors(img, uv, valid)
    gdesc = global_descriptor(bits, valid)
    timers.count("host_wait", 3)  # uv, valid and gdesc; desc_words counts its own
    return (uv.cpu().numpy(), valid.cpu().numpy() > 0, desc_words(desc),
            gdesc.cpu().numpy())


# ----------------------------------------------------------------- PnP RANSAC
def _dlt_batch(X, x):
    """Batched DLT pose from points. X [..., M, 3] world, x [..., M, 2]
    normalized observations → (R [...,3,3], t [...,3]) with x_c = R x_w + t:
    one batched 2M×12 SVD for the projection matrix, one batched 3×3 SVD to
    project it onto SO(3)."""
    Xh = np.concatenate([X, np.ones(X.shape[:-1] + (1,))], axis=-1)  # [...,M,4]
    zeros = np.zeros_like(Xh)
    r0 = np.concatenate([Xh, zeros, -x[..., 0:1] * Xh], axis=-1)  # [...,M,12]
    r1 = np.concatenate([zeros, Xh, -x[..., 1:2] * Xh], axis=-1)
    A = np.concatenate([r0, r1], axis=-2)  # [...,2M,12]
    _, _, Vt = np.linalg.svd(A)
    P = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    Mm = P[..., :3]
    U, S, Vt2 = np.linalg.svd(Mm)
    scale = np.mean(S, axis=-1)
    R = U @ Vt2
    det = np.linalg.det(R)
    R = R * np.sign(det)[..., None, None]
    scale = scale * np.sign(det)
    t = P[..., 3] / scale[..., None]
    return R, t


def pnp_ransac(pts3d, pts2d_norm, iters=128, thresh=10.0 / 460.0, seed=0, min_inliers=12,
               return_best=False):
    """`cv::solvePnPRansac` equivalent: all DLT-6pt hypotheses built, solved
    (batched SVD) and scored at once, drawn by `default_rng(seed)` exactly
    as the JAX package draws them, then two refits on the inliers.

    pts3d [N,3] world, pts2d_norm [N,2] normalized obs in the query camera;
    `thresh` is in normalized units (pixel tolerance / fx). Returns (R_cw,
    t_cw, inlier_mask) with x_c = R_cw x_w + t_cw, or None; with
    `return_best=True` the best hypothesis comes back even below
    `min_inliers`."""
    n = len(pts3d)
    if n < 6:
        return None
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 6, replace=False) for _ in range(iters)])  # [I,6]

    def score(R, t):
        pc = np.einsum("...ij,nj->...ni", R, pts3d) + t[..., None, :]
        z = pc[..., 2]
        proj = pc[..., :2] / np.where(np.abs(z[..., None]) > 1e-6, z[..., None], 1e-6)
        err = np.linalg.norm(proj - pts2d_norm, axis=-1)
        return (err < thresh) & (z > 0.1)

    with np.errstate(all="ignore"):
        R, t = _dlt_batch(pts3d[idx], pts2d_norm[idx])  # [I,3,3],[I,3]
    ok = np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
    inl = score(R, t) & ok[:, None]  # [I,N]
    best_i = int(np.argmax(inl.sum(axis=1)))
    best = (R[best_i], t[best_i], inl[best_i])
    if best[2].sum() < min_inliers and not return_best:
        return None
    R, t, inl = best
    if inl.sum() < 6:
        return (R, t, inl) if return_best else None
    for _ in range(2):  # refit on the inliers (cv's iterative refinement)
        sel = np.nonzero(inl)[0][:48]
        try:
            with np.errstate(all="ignore"):
                R2, t2 = _dlt_batch(pts3d[sel], pts2d_norm[sel])
        except np.linalg.LinAlgError:
            break
        if not (np.isfinite(R2).all() and np.isfinite(t2).all()):
            break
        inl2 = score(R2, t2)
        if inl2.sum() < inl.sum():
            break
        R, t, inl = R2, t2, inl2
    if inl.sum() < min_inliers and not return_best:
        return None
    return R, t, inl


class KeyframeDB:
    """Fixed-capacity keyframe store with an exhaustive global-descriptor
    search (`BriefDatabase::query`, thresholds of `detectLoop`). Host numpy:
    at most 2048 × 128 float32 descriptors, one matrix-vector product a query."""

    def __init__(self, capacity=2048):
        self.capacity = capacity
        self.gdescs = np.zeros((capacity, GDESC_DIM), np.float32)
        self.n = 0
        self.entries = []  # one dict a keyframe: uv, valid, desc, window points, camera
        self.recent = []  # each query's best candidate (or None): the temporal history
        self.last_candidates = []  # strong candidates of the last ACCEPTED query

    def add(self, entry, gdesc):
        if self.n >= self.capacity:
            return -1
        self.gdescs[self.n] = gdesc
        self.entries.append(entry)
        self.n += 1
        return self.n - 1

    def query(self, gdesc, exclude_last=50, min_score=0.15, top_k=4, always_include=0,
              consistency=1, consistency_gap=12):
        """Top-k cosine candidates older than `exclude_last` keyframes, with
        detectLoop's relative-threshold check (a strong best AND a second
        candidate present) and its temporal consistency: with `consistency`
        > 1 a candidate is returned only when the previous (consistency − 1)
        queries also produced candidates within ±consistency_gap of it.
        Entries [0, always_include) are a loaded map: always searchable and
        exempt from the consistency check. On acceptance `last_candidates`
        holds the strong candidates oldest first (detectLoop's min index);
        the caller verifies each geometrically in that order."""
        self.last_candidates = []
        hi = max(self.n - exclude_last, min(always_include, self.n))
        if hi <= 0:
            self.recent.append(None)
            return None
        sims = self.gdescs[:hi] @ gdesc
        # rank depth 2×top_k: clones of the true place can crowd the oldest
        # qualifying candidate out of a shallow top-k (aliased scenes)
        order = np.argsort(-sims)[: 2 * top_k]
        cand = None
        if sims[order[0]] >= min_score and not (
                len(order) > 1 and sims[order[1]] < min_score * 0.45):
            cand = int(order[0])
        accepted = cand
        if cand is not None and cand >= always_include and consistency > 1:
            hist = self.recent[-(consistency - 1):]
            if len(hist) < consistency - 1 or not all(
                    p is not None and abs(p - cand) <= consistency_gap for p in hist):
                accepted = None
        self.recent.append(cand)
        if accepted is not None:
            self.last_candidates = sorted(int(i) for i in order if sims[i] >= min_score)
        return accepted

"""Offline burst replay: the real per-frame pipeline as a step loop on the
device, with one readback a chunk.

Counterpart of `plslam/models/burst.py`. Streaming (`runner.run_euroc`)
reads a bundle back for every published frame and runs the feature-table
surgery, the factor packing and the keyframe bookkeeping on the host. EuRoC
evaluation replays a recording, so this module runs the same data flow —
point and line frontends → device feature tables (`device_table.py`) →
factors → triangulation → LM/Schur window solve → FEJ marginalization →
outlier gating → slide — for B published frames in a row on device tensors,
and the runner reads the chunk's outputs back once. Only images and IMU
samples go to the device, only the trajectory and the keyframe payload
come back.

The JAX package runs the B steps as one `lax.scan`; here they are a Python
loop over the same step. The step is not free of host waits: it reads its
keyframe flag back and runs only the marginalization and slide the flag
picks (the JAX scan picks the branch on the device with `lax.cond`;
computing both branches and selecting with `torch.where`, built and
measured on an H100, was slower: PERF.md, §6), and the library's own error
checks wait for the device, `torch.linalg.svd` (triangulation, two a step)
checking its `info` on the host. The marginalization's eigendecompositions
(two or three a step) leave theirs on the card, as a flag among the step's
outputs (`eigh_failed`) that the chunk's readback checks. Apart from those,
a step reads nothing back: no `.item()`, no shape that depends on data, no
tensor made from host data.

The step's bodies are the streaming ones (`frontend_points.tick` /
`tick_light`, `frontend_lines.tick`, `estimator.backend_tick`) and the
table state machine is the host one's (tests/test_torch_device_table.py).
What streaming computes on the host in float64 the step computes on the
device in float64 with the host's formulas, cast where the host casts: the
keyframe decision, the dead-reckoned guess of the newest slot, the anchor
transfer of MARGIN_OLD and failure detection. So a step gives streaming's
numbers bit for bit on the CPU, in float32 too; a window solve in float32
turns a one-ulp difference into millimetres within a frame (the
marginalization's eigenvalue floor), so nothing less holds the two
together. What differs from streaming, as in the JAX package:
  * the keyframe flag is decided on the device and read back, not decided
    on the host;
  * with `estimate_td` the chunk pairs its IMU at the chunk-start td; each
    frame's factors record that pairing td (`td_pair`), so the solver
    corrects only td − td_pair, as in streaming;
  * failure detection is a sticky latch: it freezes the estimator state and
    lets the frontends run on; the runner falls back to streaming, which
    clears and re-initializes; the post-init health gate (the first 8
    solves) is not applied in a step;
  * loop closure runs a chunk at a time on the host from the keyframe
    payload of each step (window points as pixel uv, world 3D and ids);
    a loop that wants the relocalization round trip hands back to streaming.
What differs from the JAX burst (ROADMAP §3 lists each): the JAX scan
preintegrates the chunk's intervals at once at the chunk-start bias,
corrects them to first order and predicts the newest slot from that delta
in the working dtype (a batched pass its scan needed to be fast); here each
step preintegrates its interval at slot W-1's live bias, as
`_close_interval` does, and predicts in float64 as the host does; and
`sync_back` sets the point frontend's clock to the last camera frame it
tracked, where the JAX one sets it to the last published frame. The
frontend's RANSAC draws come from its `torch.Generator`, which the steps
advance in place, so there is no frame counter to carry.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from plslam_torch.models import device_table as dtab
from plslam_torch.models import frontend_lines as flm
from plslam_torch.models import frontend_points as fpm
from plslam_torch.models import marginalization as marg
from plslam_torch.models import residuals as res
from plslam_torch.models.estimator import _PRE_KEYS, IMU_PAD, ImuBuffer, backend_tick
from plslam_torch.models.state import WindowState, cam_poses
from plslam_torch.ops import imu as imu_ops
from plslam_torch.ops.cameras import normalized_to_pixel
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy
from plslam_torch.utils.geometry import quat_identity


class BurstCarry(NamedTuple):
    pt_fe: tuple  # point frontend slots (uv, valid, norm, ids, cnt, next_id)
    pyr: tuple  # the previous camera frame's pyramid
    ln_fe: Optional[tuple]  # line frontend state (segs, desc, valid, ids, next_id); None: no lines
    st: WindowState
    ptab: dtab.DevPointTable
    ltab: dtab.DevLineTable
    prior: marg.Prior
    imu: dict  # the factors' preintegrations, `_PRE_KEYS` [W,...] and "valid" [W]
    raw_acc: torch.Tensor  # [IMU_PAD+1,3] float64 raw samples of the interval W-2 → W-1
    raw_gyr: torch.Tensor
    raw_dts: torch.Tensor  # [IMU_PAD] float64
    raw_n: torch.Tensor  # [] int64
    td_pair: torch.Tensor  # [NW] the IMU-pairing td of each slot
    fail: torch.Tensor  # [] bool, the sticky failure latch


def _tree_where(c, a, b):
    """Leaf-wise `torch.where(c, a, b)` over two trees of one structure
    (None leaves, the absent line state, stay None)."""
    return pytree.tree_map(lambda x, y: x if x is None else torch.where(c, x, y), a, b)


def _pre_fields(pre) -> dict:
    return {"alpha": pre.alpha, "beta": pre.beta, "gamma": pre.gamma, "jac": pre.jac,
            "sqrt_info": imu_ops.sqrt_info_from_cov(pre.cov), "dt_sum": pre.dt_sum,
            "ba": pre.ba, "bg": pre.bg}


def _set_last(a, v):
    """`a` with its last row replaced by `v`."""
    return torch.cat([a[:-1], v[None]])


def _set_row(a, i, v):
    return torch.cat([a[:i], v[None], a[i + 1:]])


def _roll1(a):
    """Rows shifted up by one, the last row kept (the MARGIN_OLD slide)."""
    return torch.cat([a[1:], a[-1:]])


def _copy_new(a):
    """Row W-1 ← row W (the SECOND_NEW slide)."""
    return torch.cat([a[:-2], a[-1:], a[-1:]])


class ImuChunkPacker:
    """`ImuFeeder`'s pairing (boundary-interpolated at t_img + td) producing
    padded arrays of each interval for the burst steps instead of feeding an
    estimator."""

    def __init__(self, imu_t, acc, gyr, i0, prev_t, prev_acc, prev_gyr):
        self.t = np.asarray(imu_t, np.float64)
        self.acc = np.asarray(acc, np.float64)
        self.gyr = np.asarray(gyr, np.float64)
        self.i = i0
        self.prev_t = prev_t
        self.prev_acc = prev_acc
        self.prev_gyr = prev_gyr

    def interval(self, t_img, td):
        """Padded (acc [PAD+1,3], gyr [PAD+1,3], dts [PAD], n) of the interval
        ending at t_img + td, seeded with the previous boundary sample."""
        t_b = float(t_img) + float(td)
        accs, gyrs, ts = [self.prev_acc], [self.prev_gyr], [self.prev_t]
        n = len(self.t)
        while self.i < n and self.t[self.i] < t_b - 1e-9:
            accs.append(self.acc[self.i])
            gyrs.append(self.gyr[self.i])
            ts.append(self.t[self.i])
            self.i += 1
        if self.i < n:
            t1 = self.t[self.i]
            if t1 <= t_b + 1e-9:  # a sample on the boundary is consumed verbatim
                accs.append(self.acc[self.i])
                gyrs.append(self.gyr[self.i])
                ts.append(t1)
                self.i += 1
            else:
                w = (t_b - ts[-1]) / (t1 - ts[-1])
                accs.append((1.0 - w) * accs[-1] + w * self.acc[self.i])
                gyrs.append((1.0 - w) * gyrs[-1] + w * self.gyr[self.i])
                ts.append(t_b)
        self.prev_t, self.prev_acc, self.prev_gyr = ts[-1], accs[-1], gyrs[-1]
        m = min(len(ts) - 1, IMU_PAD)
        acc_p = np.zeros((IMU_PAD + 1, 3))
        gyr_p = np.zeros((IMU_PAD + 1, 3))
        dts_p = np.zeros(IMU_PAD)
        acc_p[: m + 1] = np.stack(accs[: m + 1])
        gyr_p[: m + 1] = np.stack(gyrs[: m + 1])
        acc_p[m + 1:] = acc_p[m]
        gyr_p[m + 1:] = gyr_p[m]
        dts_p[:m] = np.diff(ts[: m + 1])
        return acc_p, gyr_p, dts_p, m


def make_carry(est, fp, fl) -> BurstCarry:
    """Hand the streaming estimator and frontends over to the burst steps.
    Raises ValueError without a live marginalization prior or a running
    point tracker."""
    if est.prior is None:
        raise ValueError("burst handoff requires a live marginalization prior")
    if fp.prev_pyr is None:
        raise ValueError("burst handoff requires a running point tracker")
    nw = est.cfg.window_size
    dtype, dev = est.dtype, est.device
    stk, valid = est.window_pres()
    imu = dict(stk, valid=est._t(np.asarray(valid, np.float64)))
    buf = est.imu_bufs[nw - 1]
    raw_acc, raw_gyr, raw_dts = buf.padded(torch.float64, dev)
    ln_fe = None
    if fl is not None:
        ln_fe = fl.prev if fl.prev is not None else fl._initial_state()
    return BurstCarry(
        pt_fe=fp._state, pyr=tuple(fp.prev_pyr), ln_fe=ln_fe,
        # the tables hold the host's raw truth (inv_depth < 0 = unsolved);
        # each step substitutes 0.2 itself
        st=est._device_state(),
        ptab=dtab.from_host_point_table(est.pt_table, dtype, dev),
        ltab=dtab.from_host_line_table(est.ln_table, est.line_w, dtype, dev),
        prior=est.prior, imu=imu, raw_acc=raw_acc, raw_gyr=raw_gyr, raw_dts=raw_dts,
        raw_n=torch.full((), len(buf.dt), dtype=torch.int64, device=dev),
        td_pair=est._t(est.td_pair), fail=torch.zeros((), dtype=torch.bool, device=dev))


def sync_back(est, fp, fl, carry: BurstCarry, ts_win, last_cam_t: float):
    """Write the carry back into the host estimator and frontends so that
    streaming (or a save) continues where the burst ended. One wait for
    everything read back.

    The factor side must come back complete: window states, both tables,
    the prior, the preintegration of each interval (`est.pres`) and the raw
    samples of the newest closed interval (`est.imu_bufs`, the source of a
    SECOND_NEW merge right after the handback). The JAX package once left
    out `est.pres`: the streamed solves then ran against the pre-burst IMU
    factors, the first one's cost0 was ~8e5, and the trajectory walked off
    at ~0.27 m a frame until the stale window flushed. The timestamps of
    each slot (`ts_win`) are tracked on the host by the runner from the
    publish times and keyframe flags; `last_cam_t` is the last camera frame
    the point frontend tracked (its velocity reference)."""
    nw = est.cfg.window_size
    st = carry.st
    head = [st.p, st.q, st.v, st.ba, st.bg, st.p_bc, st.q_bc, st.td, carry.raw_acc,
            carry.raw_gyr, carry.raw_dts, carry.raw_n, carry.imu["valid"], carry.td_pair]
    pulled = HostCopy(*head, *carry.ptab, *carry.ltab).get()
    (p, q, v, ba, bg, p_bc, q_bc, td, raw_acc, raw_gyr, raw_dts, raw_n, imu_valid,
     td_pair) = pulled[: len(head)]
    pt = dtab.DevPointTable(*pulled[len(head): len(head) + 6])
    ln = dtab.DevLineTable(*pulled[len(head) + 6:])
    est.p, est.q, est.v, est.ba, est.bg = [a.astype(np.float64) for a in (p, q, v, ba, bg)]
    est.p_bc, est.q_bc, est.td = p_bc.astype(np.float64), q_bc.astype(np.float64), float(td)
    est.td_pair[:] = td_pair.astype(np.float64)
    dtab.to_host_point_table(est.pt_table, pt)
    est.line_w = dtab.to_host_line_table(est.ln_table, ln)
    est.prior = carry.prior
    # carry row i is the interval (i → i+1) after the slide: rows 0..W-2
    # closed ↦ est.pres[1..W-1]; est.pres[W] is the open interval (row W-1
    # is a stale copy that the next step would overwrite)
    est.pres = [None] + [{k: carry.imu[k][i] for k in _PRE_KEYS} if imu_valid[i] > 0 else None
                         for i in range(nw - 1)] + [None]
    n_raw = int(raw_n)
    newest = ImuBuffer()
    newest.acc = [raw_acc[i].astype(np.float64) for i in range(n_raw + 1)]
    newest.gyr = [raw_gyr[i].astype(np.float64) for i in range(n_raw + 1)]
    newest.dt = [float(d) for d in raw_dts[:n_raw]]
    est.imu_bufs = [ImuBuffer() for _ in range(nw - 1)] + [newest, ImuBuffer()]
    est.timestamps[:] = np.asarray(ts_win, np.float64)
    fp._state = carry.pt_fe
    fp.prev_pyr = list(carry.pyr)
    fp.prev_t = last_cam_t
    if fl is not None:
        fl.prev = carry.ln_fe


class BurstStep:
    """The step of one burst: the constants it closes over, read once from
    the estimator and the frontends it was handed, and `run_chunk`, which
    runs B steps on the device and returns the stacked outputs (still on the
    device)."""

    OUTPUTS = ("p", "q", "keyframe", "cost", "fail", "long_tracked", "n_pts", "td", "ids",
               "kf_points", "uv", "p_w", "eigh_failed")

    def __init__(self, est, fp, fl, stride: int):
        self.est, self.fp, self.fl = est, fp, fl
        self.stride = stride
        cfg = est.cfg
        self.W = cfg.window_size
        self.min_par = cfg.keyframe_parallax / cfg.focal_length
        self.kw = dict(ee=est.config.extrinsic.estimate_extrinsic > 0,
                       etd=est.config.temporal.estimate_td, iters=cfg.max_num_iterations)
        self.f0 = res.empty_factors(cfg, est.lay, est.dtype, est.device)._replace(g=est.g)
        tc, camc = est.config.temporal, est.config.camera
        # the rolling-shutter row factor of the streaming `_factors` (0 when off)
        self.rs = ((camc.fy, camc.cy, max(camc.image_height, 1), tc.rolling_shutter_tr)
                   if tc.rolling_shutter else None)
        self.rs_tr = torch.full((), self.rs[3] if self.rs else 0.0, dtype=est.dtype,
                                device=est.device)
        self.relo_p = torch.zeros(3, dtype=est.dtype, device=est.device)
        self.relo_q = quat_identity(est.dtype, est.device)
        # gravity as the host's dead-reckoning has it (est.g is in est.dtype)
        self.g64 = torch.cat([torch.zeros(2, dtype=torch.float64, device=est.device),
                              torch.full((1,), est.config.imu.g_norm, dtype=torch.float64,
                                         device=est.device)])

    # ----------------------------------------------------------- frontends
    def _frontends(self, carry, imgs, img_dts):
        """Track every camera frame of the stride group; the first one is
        published (full tick and the line tick), the rest run the light
        tick, as streaming does."""
        fp, fl = self.fp, self.fl
        pyr, pt_fe, ln_fe = list(carry.pyr), carry.pt_fe, carry.ln_fe
        kw = dict(fisheye=fp.fisheye, fov_mask=fp._mask_img, tracker=fp.tracker)
        for s in range(self.stride):
            img_s = fpm.dev_image(imgs[s], fp.dtype)
            if s == 0:
                pyr, pt_fe, pt_out = fpm.tick(fp.cam, pyr, img_s, pt_fe, fp.f_thresh, img_dts[0],
                                              fp.min_score, fp.min_dist, fp.max_cnt,
                                              generator=fp.generator, **kw)
                ln_out = None
                if fl is not None:
                    ln_fe, ln_out = flm.tick(fl.cam, img_s, pyr[1] if len(pyr) > 1 else None,
                                             ln_fe, fl.max_lines, fl.octaves, fl.binary_desc)
            else:
                pyr, pt_fe = fpm.tick_light(fp.cam, pyr, img_s, pt_fe, **kw)
        return tuple(pyr), pt_fe, ln_fe, pt_out, ln_out

    # ---------------------------------------------------------------- step
    def step(self, carry: BurstCarry, imgs, img_dts, acc, gyr, dts, n_imu: int, td0: float):
        """One published frame. imgs [stride,H,W] uint8 on the device,
        img_dts the host camera-frame gaps, (acc, gyr, dts, n_imu) the
        padded raw samples (float64) of the interval it closes, td0 their
        pairing td. Returns (carry, outputs)."""
        W, est = self.W, self.est
        dtype, dev = est.dtype, est.device
        pyr, pt_fe, ln_fe, (bf, pt_ids), ln_out = self._frontends(carry, imgs, img_dts)

        # ---- publish: the frame's column of both tables (cast at the
        # frontend → backend boundary, as streaming's readback does)
        fe_valid = (bf[:, 6] > 0) & (pt_ids >= 0)
        ptab = dtab.pt_add_frame(carry.ptab, W, pt_ids, bf[:, 2:4].to(dtype),
                                 bf[:, 4:6].to(dtype), fe_valid)
        ltab = carry.ltab
        if ln_out is not None:
            lb, ln_ids = ln_out
            ltab = dtab.ln_add_frame(ltab, W, ln_ids, lb[:, 0:4].to(dtype),
                                     (lb[:, 4] > 0) & (ln_ids >= 0))
        long_tracked = torch.sum((ptab.mask[:, W] > 0) & (torch.sum(ptab.mask, dim=1) >= 2))

        # ---- keyframe decision (in float64, as the host table decides); a
        # SECOND_NEW merge that would overflow IMU_PAD forces a keyframe
        kf = (dtab.pt_parallax_keyframe(ptab._replace(obs=ptab.obs.double()), W, self.min_par)
              | (carry.raw_n + n_imu > IMU_PAD))

        # ---- close the interval (`_close_interval`: preintegrated at slot
        # W-1's bias) and predict the newest slot as the host dead-reckons
        # it: from slot W at its bias, in float64, cast once
        st = carry.st
        npre = _pre_fields(imu_ops.preintegrate(acc.to(dtype), gyr.to(dtype), dts.to(dtype),
                                                st.ba[W - 1], st.bg[W - 1], est.noise))
        p_pred, v_pred, q_pred = imu_ops.dead_reckon(
            st.p[W].double(), st.v[W].double(), st.q[W].double(), acc, gyr, dts,
            st.ba[W].double(), st.bg[W].double(), self.g64)
        st = st._replace(p=_set_last(st.p, p_pred.to(dtype)), q=_set_last(st.q, q_pred.to(dtype)),
                         v=_set_last(st.v, v_pred.to(dtype)))
        imu_f = {k: _set_last(carry.imu[k], npre[k]) for k in _PRE_KEYS}
        imu_f["valid"] = _set_last(carry.imu["valid"], torch.ones((), dtype=dtype, device=dev))
        td_pair = _set_last(carry.td_pair, torch.full((), td0, dtype=dtype, device=dev))

        # ---- factors (`Estimator._factors` from the device tables)
        if self.rs is None:
            rowf = torch.zeros_like(ptab.obs[..., 1])
        else:
            fy, cy, h, _ = self.rs
            rowf = torch.clamp((fy * ptab.obs[..., 1] + cy) / h, 0.0, 1.0)
        f = self.f0._replace(
            imu_alpha=imu_f["alpha"], imu_beta=imu_f["beta"], imu_gamma=imu_f["gamma"],
            imu_jac=imu_f["jac"], imu_sqrt_info=imu_f["sqrt_info"], imu_dt=imu_f["dt_sum"],
            imu_ba=imu_f["ba"], imu_bg=imu_f["bg"], imu_valid=imu_f["valid"],
            pt_obs=ptab.obs, pt_vel=ptab.vel, pt_mask=ptab.mask, pt_start=ptab.start.long(),
            pt_td_ref=td_pair, pt_rowf=rowf, rs_tr=self.rs_tr,
            ln_obs=ltab.obs, ln_mask=ltab.mask, ln_start=ltab.start.long())
        active = ptab.ids >= 0
        nobs = torch.sum(ptab.mask, dim=1)
        solvable = (active & (nobs >= 2)).to(dtype)
        used = (active & (ptab.inv_depth > 0) & (nobs >= 2)).to(dtype)
        tri_need = solvable * (ptab.inv_depth <= 0).to(dtype)
        fb4 = (nobs >= 4).to(dtype)
        ln_active2 = ((ltab.ids >= 0) & (torch.sum(ltab.mask, dim=1) >= 2)).to(dtype)
        lneed = ln_active2 * (1.0 - ltab.solved)
        f = marg.install_prior(f._replace(pt_valid=used, ln_valid=ln_active2 * ltab.solved),
                               carry.prior)
        # the solve's state as `_device_state` builds it: the relocalization
        # pose reset (no relo request in a step), unsolved depths at 0.2
        st = st._replace(inv_depth=torch.where(ptab.inv_depth > 0, ptab.inv_depth,
                                               torch.full_like(ptab.inv_depth, 0.2)),
                         line=ltab.line_w, relo_p=self.relo_p, relo_q=self.relo_q)

        # ---- solve + marginalize
        kf_host = bool(kf)  # the step's one read back
        timers.count("host_wait")
        st_out, stats, prior_new, aux = backend_tick(
            st, f, solvable, tri_need, fb4, lneed, ln_active2, est.lay, est.cfg,
            marg_mode="old" if kf_host else "new", graphs=est._graphs, **self.kw)

        # ---- after the solve (`_finish_solve`): depths, removeFailures,
        # removeOutlier / removeLineOutlier
        ptv = aux["pt_valid"] > 0
        inv = st_out.inv_depth
        ptab = ptab._replace(inv_depth=torch.where(ptv, inv, ptab.inv_depth))
        drop = ptv & ((inv <= 0) | (aux["pt_err"] > 10.0))
        ptab = dtab._pt_clear_where(ptab, drop)
        ltab = dtab._ln_clear_where(
            ltab._replace(solved=torch.maximum(ltab.solved, aux["lcommit"]), line_w=st_out.line),
            (aux["ln_solved"] > 0) & (aux["ln_err"] > 10.0))

        # ---- failure detection (a sticky latch; float64, as on the host)
        dp = st_out.p[W].double() - st_out.p[W - 1].double()
        fail = carry.fail | ((long_tracked < 2) | (torch.linalg.norm(st_out.ba[W].double()) > 2.5)
                             | (torch.linalg.norm(st_out.bg[W].double()) > 1.0)
                             | (torch.linalg.norm(dp) > 5.0) | (torch.abs(dp[2]) > 1.0))

        # ---- the slide
        after = (st_out, ptab, ltab, imu_f, td_pair)
        raw = (acc, gyr, dts, torch.full((), n_imu, dtype=torch.int64, device=dev))
        slid = self._slide_old(*after, raw) if kf_host else self._slide_new(*after, carry, raw)
        st_s, ptab_s, ltab_s, imu_s, td_pair_s, (racc, rgyr, rdts, rn) = slid
        new = BurstCarry(pt_fe=pt_fe, pyr=pyr, ln_fe=ln_fe, st=st_s, ptab=ptab_s, ltab=ltab_s,
                         prior=prior_new, imu=imu_s, raw_acc=racc, raw_gyr=rgyr, raw_dts=rdts,
                         raw_n=rn, td_pair=td_pair_s, fail=fail)
        # a latched failure freezes the estimator state; the frontends run on
        # (streaming clears and re-initializes: the runner falls back to it)
        frozen = carry._replace(pt_fe=pt_fe, pyr=pyr, ln_fe=ln_fe, fail=fail)
        out_carry = _tree_where(carry.fail, frozen, new)

        # ---- the keyframe payload (`window_points`): solved points that
        # survived the gates and are seen in the newest frame
        kf_pts = ptv & ~drop & (ptab.mask[:, W] > 0) & (ptab.ids >= 0)
        uv = normalized_to_pixel(self.fp.cam, ptab.obs[:, W].to(self.fp.dtype))
        out = (st_out.p[W], st_out.q[W], kf, stats.cost, fail, long_tracked,
               torch.sum(aux["pt_valid"]), st_out.td, ptab.ids, kf_pts, uv, aux["p_w"],
               aux["eigh_failed"])
        return out_carry, out

    def _slide_old(self, st_out, ptab, ltab, imu_f, td_pair, raw):
        """MARGIN_OLD: states rolled, frame 0's anchors transferred (in
        float64 from float64 camera poses, as the host table transfers
        them), the interval closed by this frame becomes the newest raw one."""
        p_wc, q_wc = cam_poses(WindowState(*[x.double() for x in st_out]))
        st = st_out._replace(p=_roll1(st_out.p), q=_roll1(st_out.q), v=_roll1(st_out.v),
                             ba=_roll1(st_out.ba), bg=_roll1(st_out.bg))
        slid = dtab.pt_slide_old(ptab._replace(obs=ptab.obs.double(),
                                               inv_depth=ptab.inv_depth.double()),
                                 p_wc[0], q_wc[0], p_wc[1], q_wc[1])
        slid = slid._replace(obs=slid.obs.to(ptab.obs.dtype),
                             inv_depth=slid.inv_depth.to(ptab.inv_depth.dtype))
        return (st, slid, dtab.ln_slide_old(ltab), {k: _roll1(v) for k, v in imu_f.items()},
                _roll1(td_pair), raw)

    def _slide_new(self, st_out, ptab, ltab, imu_f, td_pair, carry, raw):
        """SECOND_NEW: slot W-1 dies; its interval merges with this frame's
        (`ImuBuffer.merged`) and is preintegrated again."""
        W, dev = self.W, self.est.device
        acc, gyr, dts, n_imu = raw
        st = st_out._replace(p=_copy_new(st_out.p), q=_copy_new(st_out.q),
                             v=_copy_new(st_out.v), ba=_copy_new(st_out.ba),
                             bg=_copy_new(st_out.bg))
        n1 = carry.raw_n
        i1 = torch.arange(IMU_PAD + 1, device=dev)
        take = torch.clamp(i1 - n1, 0, IMU_PAD)
        first = (i1 <= n1)[:, None]
        acc_m = torch.where(first, carry.raw_acc, acc[take])
        gyr_m = torch.where(first, carry.raw_gyr, gyr[take])
        i0 = i1[:-1]
        dts_m = torch.where(i0 < n1, carry.raw_dts, dts[torch.clamp(i0 - n1, 0, IMU_PAD - 1)])
        n_m = torch.clamp(n1 + n_imu, max=IMU_PAD)
        dtype = self.est.dtype
        merged = _pre_fields(imu_ops.preintegrate(acc_m.to(dtype), gyr_m.to(dtype),
                                                  dts_m.to(dtype), st.ba[W - 2], st.bg[W - 2],
                                                  self.est.noise))
        imu = {k: _set_row(v, W - 2, merged[k]) if k in merged else v for k, v in imu_f.items()}
        imu["valid"] = _set_row(imu_f["valid"], W - 2, torch.ones_like(imu_f["valid"][0]))
        return (st, dtab.pt_slide_new(ptab), dtab.ln_slide_new(ltab), imu,
                _set_row(td_pair, W - 1, td_pair[W]), (acc_m, gyr_m, dts_m, n_m))

    # --------------------------------------------------------------- chunk
    def run_chunk(self, carry: BurstCarry, imgs, img_dts, acc, gyr, dts, n_imu, td0s):
        """B steps. imgs [B,stride,H,W] uint8 on the device; img_dts [B,stride]
        host camera-frame gaps; acc/gyr [B,PAD+1,3], dts [B,PAD] float64 on
        the device; n_imu and td0s host lists. Returns (carry, dict of the
        `OUTPUTS` stacked over the steps, on the device)."""
        outs = []
        for j in range(len(n_imu)):
            carry, out = self.step(carry, imgs[j], img_dts[j], acc[j], gyr[j], dts[j], n_imu[j],
                                   td0s[j])
            outs.append(out)
        return carry, {name: torch.stack(col) for name, col in zip(self.OUTPUTS, zip(*outs))}

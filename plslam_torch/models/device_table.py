"""Fixed-capacity feature tables on the device (the `FeatureManager` state
machine as tensor functions).

Counterpart of `plslam/models/device_table.py`. The host tables in
`feature_table.py` do the reference's `FeatureManager` list surgery with
numpy slot arrays, which costs a host round trip a frame. Here the same
state machine — `addFeatureCheckParallax` insertion and decision,
`removeBackShiftDepth` / `removeFront` slides, `removeFailures` /
`removeOutlier` drops — is a set of functions over NamedTuples of tensors
with fixed shapes, nothing read back to the host, so the burst step
(`models/burst.py`) chains whole frames on the device.

Semantics equal `feature_table.PointTable` / `LineTable` (free slots fill in
index order here too, relative to the table's own layout; the solver does
not depend on the slot order), the rotation of the anchor transfer
included. Ids and starts are int32, as in the JAX package, and every
integer output equals the JAX functions' exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch



class DevPointTable(NamedTuple):
    ids: torch.Tensor  # [MF] int32, -1 = free slot
    start: torch.Tensor  # [MF] int32 first observing window frame
    obs: torch.Tensor  # [MF,NW,2] normalized coordinates
    vel: torch.Tensor  # [MF,NW,2]
    mask: torch.Tensor  # [MF,NW] float 0/1
    inv_depth: torch.Tensor  # [MF] (< 0 = not solved)


class DevLineTable(NamedTuple):
    ids: torch.Tensor  # [ML] int32
    start: torch.Tensor  # [ML] int32
    obs: torch.Tensor  # [ML,NW,4]
    mask: torch.Tensor  # [ML,NW]
    line_w: torch.Tensor  # [ML,6] world Plücker
    solved: torch.Tensor  # [ML] float 0/1


def empty_point_table(mf: int, nw: int, dtype, device=None) -> DevPointTable:
    return DevPointTable(
        ids=torch.full((mf,), -1, dtype=torch.int32, device=device),
        start=torch.zeros((mf,), dtype=torch.int32, device=device),
        obs=torch.zeros((mf, nw, 2), dtype=dtype, device=device),
        vel=torch.zeros((mf, nw, 2), dtype=dtype, device=device),
        mask=torch.zeros((mf, nw), dtype=dtype, device=device),
        inv_depth=torch.full((mf,), -1.0, dtype=dtype, device=device),
    )


def empty_line_table(ml: int, nw: int, dtype, device=None) -> DevLineTable:
    L = torch.zeros((ml, 6), dtype=dtype, device=device)
    L[:, 1] = 5.0
    L[:, 5] = 1.0
    return DevLineTable(
        ids=torch.full((ml,), -1, dtype=torch.int32, device=device),
        start=torch.zeros((ml,), dtype=torch.int32, device=device),
        obs=torch.zeros((ml, nw, 4), dtype=dtype, device=device),
        mask=torch.zeros((ml, nw), dtype=dtype, device=device),
        line_w=L,
        solved=torch.zeros((ml,), dtype=dtype, device=device),
    )


def _put(base, slot, vals, col=None):
    """`base` with rows `slot` (column `col`) set to `vals`, out of place;
    a slot equal to len(base) writes nowhere (JAX's `mode="drop"`)."""
    ext = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    if col is None:
        ext[slot] = vals
    else:
        ext[slot, col] = vals
    return ext[:-1]


def _slot_assign(tbl_ids, fe_ids, fe_valid):
    """id → slot at a fixed shape. An existing id maps to its slot; new ids
    take free slots in index order (the host `add_frame` rule); overflow
    drops (host: "table full: drop new feature"). Returns (slot [N_in]
    int64 with CAP = len(tbl_ids) marking "dropped", the is-new mask)."""
    cap = tbl_ids.shape[0]
    dev = tbl_ids.device
    eq = (fe_ids[:, None] == tbl_ids[None, :]) & (fe_ids[:, None] >= 0) & (tbl_ids[None, :] >= 0)
    has = torch.any(eq, dim=1)
    slot_exist = torch.argmax(eq.to(torch.int32), dim=1)  # the first match
    free = tbl_ids < 0
    n_free = torch.sum(free)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    # rank → slot: scatter the slot indices by their free rank
    tgt = torch.where(free, free_rank, torch.full_like(free_rank, cap))
    rank_to_slot = _put(torch.full((cap,), cap, dtype=torch.int64, device=dev), tgt,
                        torch.arange(cap, device=dev))
    new = fe_valid & ~has & (fe_ids >= 0)
    new_rank = torch.cumsum(new.to(torch.int64), 0) - 1
    ok_new = new & (new_rank < n_free)
    slot_new = rank_to_slot[torch.clamp(new_rank, 0, cap - 1)]
    slot = torch.where(fe_valid & has, slot_exist,
                       torch.where(ok_new, slot_new, torch.full_like(slot_new, cap)))
    return slot, ok_new


def _claim(cap, slot, ok_new, fe_ids, old_ids):
    """(ids after the new features claim their slots, mask of claimed slots)."""
    is_new_slot = _put(torch.zeros(cap, dtype=torch.bool, device=old_ids.device), slot, ok_new)
    put_ids = _put(torch.zeros(cap, dtype=torch.int32, device=old_ids.device), slot,
                   fe_ids.to(torch.int32))
    return torch.where(is_new_slot, put_ids, old_ids), is_new_slot


def pt_add_frame(tbl: DevPointTable, frame_idx: int, fe_ids, fe_obs, fe_vel,
                 fe_valid) -> DevPointTable:
    """`PointTable.add_frame`: write frame `frame_idx`'s observations;
    newly seen ids claim free slots (row reset: start = frame, inv_depth =
    -1, the observation window cleared)."""
    cap = tbl.ids.shape[0]
    slot, ok_new = _slot_assign(tbl.ids, fe_ids, fe_valid)
    ids, is_new = _claim(cap, slot, ok_new, fe_ids, tbl.ids)
    start = torch.where(is_new, torch.full_like(tbl.start, frame_idx), tbl.start)
    inv_depth = torch.where(is_new, torch.full_like(tbl.inv_depth, -1.0), tbl.inv_depth)
    obs = torch.where(is_new[:, None, None], torch.zeros_like(tbl.obs), tbl.obs)
    vel = torch.where(is_new[:, None, None], torch.zeros_like(tbl.vel), tbl.vel)
    mask = torch.where(is_new[:, None], torch.zeros_like(tbl.mask), tbl.mask)
    obs = _put(obs, slot, fe_obs.to(obs.dtype), frame_idx)
    vel = _put(vel, slot, fe_vel.to(vel.dtype), frame_idx)
    mask = _put(mask, slot, fe_valid.to(mask.dtype), frame_idx)
    return DevPointTable(ids=ids, start=start, obs=obs, vel=vel, mask=mask, inv_depth=inv_depth)


def ln_add_frame(tbl: DevLineTable, frame_idx: int, fe_ids, fe_segs, fe_valid) -> DevLineTable:
    cap = tbl.ids.shape[0]
    slot, ok_new = _slot_assign(tbl.ids, fe_ids, fe_valid)
    ids, is_new = _claim(cap, slot, ok_new, fe_ids, tbl.ids)
    start = torch.where(is_new, torch.full_like(tbl.start, frame_idx), tbl.start)
    solved = torch.where(is_new, torch.zeros_like(tbl.solved), tbl.solved)
    obs = torch.where(is_new[:, None, None], torch.zeros_like(tbl.obs), tbl.obs)
    mask = torch.where(is_new[:, None], torch.zeros_like(tbl.mask), tbl.mask)
    obs = _put(obs, slot, fe_segs.to(obs.dtype), frame_idx)
    mask = _put(mask, slot, fe_valid.to(mask.dtype), frame_idx)
    return tbl._replace(ids=ids, start=start, obs=obs, mask=mask, solved=solved)


def pt_parallax_keyframe(tbl: DevPointTable, frame_idx: int, min_parallax):
    """`parallax_keyframe_decision` (frame_idx a Python int ≥ 2): a bool
    tensor, True → MARGIN_OLD."""
    both = ((tbl.ids >= 0) & (tbl.mask[:, frame_idx - 2] > 0)
            & (tbl.mask[:, frame_idx - 1] > 0) & (tbl.start <= frame_idx - 2))
    dn = torch.linalg.norm(tbl.obs[:, frame_idx - 1] - tbl.obs[:, frame_idx - 2], dim=-1)
    n = torch.sum(both)
    par = torch.sum(torch.where(both, dn, torch.zeros_like(dn))) / torch.clamp(n, min=1)
    return (n == 0) | (par >= min_parallax)


def _pt_clear_where(tbl: DevPointTable, dead) -> DevPointTable:
    return DevPointTable(
        ids=torch.where(dead, torch.full_like(tbl.ids, -1), tbl.ids),
        start=torch.where(dead, torch.zeros_like(tbl.start), tbl.start),
        obs=torch.where(dead[:, None, None], torch.zeros_like(tbl.obs), tbl.obs),
        vel=torch.where(dead[:, None, None], torch.zeros_like(tbl.vel), tbl.vel),
        mask=torch.where(dead[:, None], torch.zeros_like(tbl.mask), tbl.mask),
        inv_depth=torch.where(dead, torch.full_like(tbl.inv_depth, -1.0), tbl.inv_depth),
    )


def _ln_clear_where(tbl: DevLineTable, dead) -> DevLineTable:
    return tbl._replace(
        ids=torch.where(dead, torch.full_like(tbl.ids, -1), tbl.ids),
        start=torch.where(dead, torch.zeros_like(tbl.start), tbl.start),
        obs=torch.where(dead[:, None, None], torch.zeros_like(tbl.obs), tbl.obs),
        mask=torch.where(dead[:, None], torch.zeros_like(tbl.mask), tbl.mask),
        solved=torch.where(dead, torch.zeros_like(tbl.solved), tbl.solved),
    )


def _shift_left(a):
    """Drop window column 0, append an empty column."""
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)


def _first_obs(mask):
    """(has any observation [N], the first observed column as int32)."""
    has = torch.any(mask > 0, dim=1)
    first = torch.argmax((mask > 0).to(torch.int32), dim=1).to(torch.int32)
    return has, torch.where(has, first, torch.zeros_like(first))


def _rot(q):
    """The host table's rotation of an anchor quaternion
    (`feature_table._quat_to_rot_np`: not normalized, the diagonal as
    1 − 2(y² + z²)). On a float32 window's quaternions, unit only to ~1e-7,
    `quat_to_rot`'s w² + x² − y² − z² (the JAX device table's) differs by
    as much, and the burst steps must transfer depths as streaming does."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)])])


def pt_slide_old(tbl: DevPointTable, p_wc_old0, q_wc_old0, p_wc_new0, q_wc_new0) -> DevPointTable:
    """`removeBackShiftDepth` (see `PointTable.slide_old` for the anchor
    transfer, the gapped-track reset included)."""
    active = tbl.ids >= 0
    starts0 = active & (tbl.start == 0) & (tbl.inv_depth > 0)
    gapped = starts0 & (tbl.mask[:, 1] <= 0)
    sel = starts0 & (tbl.mask[:, 1] > 0)
    uv = tbl.obs[:, 0]
    depth = 1.0 / torch.where(tbl.inv_depth > 0, tbl.inv_depth, torch.ones_like(tbl.inv_depth))
    pc0 = torch.stack([uv[:, 0] * depth, uv[:, 1] * depth, depth], dim=-1)
    pw = pc0 @ _rot(q_wc_old0).T + p_wc_old0
    pc1 = (pw - p_wc_new0) @ _rot(q_wc_new0)  # rowwise R_newᵀ(pw − p)
    z = pc1[:, 2]
    transferred = torch.where(z > 0.1, 1.0 / torch.clamp(z, min=1e-9), torch.full_like(z, -1.0))
    inv = torch.where(sel, transferred,
                      torch.where(gapped, torch.full_like(z, -1.0), tbl.inv_depth))
    mask = _shift_left(tbl.mask)
    has, start = _first_obs(mask)
    inv = torch.where(active & has, inv, torch.full_like(inv, -1.0))
    out = DevPointTable(ids=tbl.ids, start=start, obs=_shift_left(tbl.obs),
                        vel=_shift_left(tbl.vel), mask=mask, inv_depth=inv)
    return _pt_clear_where(out, active & ~has)


def _second_new(a, nw):
    """Column nw-1 moved into nw-2, column nw-1 emptied (`removeFront`)."""
    return torch.cat([a[:, : nw - 2], a[:, nw - 1: nw], torch.zeros_like(a[:, nw - 1: nw])],
                     dim=1)


def _start_second_new(start, nw):
    return torch.where(start == nw - 1, torch.full_like(start, nw - 2), start)


def pt_slide_new(tbl: DevPointTable) -> DevPointTable:
    """`removeFront`."""
    nw = tbl.obs.shape[1]
    mask = _second_new(tbl.mask, nw)
    out = tbl._replace(obs=_second_new(tbl.obs, nw), vel=_second_new(tbl.vel, nw), mask=mask,
                       start=_start_second_new(tbl.start, nw))
    return _pt_clear_where(out, (tbl.ids >= 0) & ~torch.any(mask > 0, dim=1))


def ln_slide_old(tbl: DevLineTable) -> DevLineTable:
    mask = _shift_left(tbl.mask)
    has, start = _first_obs(mask)
    out = tbl._replace(obs=_shift_left(tbl.obs), mask=mask, start=start)
    return _ln_clear_where(out, (tbl.ids >= 0) & ~has)


def ln_slide_new(tbl: DevLineTable) -> DevLineTable:
    nw = tbl.obs.shape[1]
    mask = _second_new(tbl.mask, nw)
    out = tbl._replace(obs=_second_new(tbl.obs, nw), mask=mask,
                       start=_start_second_new(tbl.start, nw))
    return _ln_clear_where(out, (tbl.ids >= 0) & ~torch.any(mask > 0, dim=1))


# ------------------------------------------------------ host table interop
def _host_tensor(a, dtype, device):
    return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)  # a copy, never aliased


def from_host_point_table(host, dtype, device=None) -> DevPointTable:
    return DevPointTable(
        ids=_host_tensor(host.ids, torch.int32, device),
        start=_host_tensor(host.start, torch.int32, device),
        obs=_host_tensor(host.obs, dtype, device),
        vel=_host_tensor(host.vel, dtype, device),
        mask=_host_tensor(host.mask.astype(np.float64), dtype, device),
        inv_depth=_host_tensor(host.inv_depth, dtype, device),
    )


def from_host_line_table(host, line_w, dtype, device=None) -> DevLineTable:
    return DevLineTable(
        ids=_host_tensor(host.ids, torch.int32, device),
        start=_host_tensor(host.start, torch.int32, device),
        obs=_host_tensor(host.obs, dtype, device),
        mask=_host_tensor(host.mask.astype(np.float64), dtype, device),
        line_w=_host_tensor(line_w, dtype, device),
        solved=_host_tensor(host.solved.astype(np.float64), dtype, device),
    )


def to_host_point_table(host, pulled: DevPointTable):
    """Write a pulled (numpy-valued) point table into a host `PointTable` in
    place (the burst → streaming handback)."""
    host.ids[:] = np.asarray(pulled.ids).astype(np.int64)
    host.start[:] = np.asarray(pulled.start).astype(np.int32)
    host.obs[:] = np.asarray(pulled.obs)
    host.vel[:] = np.asarray(pulled.vel)
    host.mask[:] = np.asarray(pulled.mask) > 0.5
    host.inv_depth[:] = np.asarray(pulled.inv_depth)
    host.track_cnt[:] = host.mask.sum(axis=1)  # the window's observation count


def to_host_line_table(host, pulled: DevLineTable):
    """The same for lines; returns the world Plücker lines [ML,6]."""
    host.ids[:] = np.asarray(pulled.ids).astype(np.int64)
    host.start[:] = np.asarray(pulled.start).astype(np.int32)
    host.obs[:] = np.asarray(pulled.obs)
    host.mask[:] = np.asarray(pulled.mask) > 0.5
    host.solved[:] = np.asarray(pulled.solved) > 0.5
    host.track_cnt[:] = host.mask.sum(axis=1)
    return np.asarray(pulled.line_w, np.float64)

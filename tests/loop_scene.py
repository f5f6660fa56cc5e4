"""The keyframe inputs of the pose-graph replay tests (port only, no JAX):
`test_pose_graph.py::test_relocalize_against_saved_map`'s `kf_inputs`
recipe — 376×240 renders of the 14-s circle, f = 160, the ground-truth
window points — over one circle, a keyframe every 3rd frame, with the poses
and window landmarks drifted along the circle so that the revisit has
drift for the loops to close."""
import numpy as np

from plslam_torch.io import render, synthetic
from plslam_torch.ops.cameras import PinholeRadTan, normalized_to_pixel
from plslam_torch.runner import _clahe
from plslam_torch.utils import quat_np as qnp

H, W, F = 240, 376, 160.0
FRAMES = tuple(range(0, 280, 3))


def sequence():
    return synthetic.make_sequence(duration=14.0, n_points=500, n_lines=0, seed=23,
                                   params=synthetic.TrajectoryParams(omega=0.5, z_omega=0.8))


def camera():
    return PinholeRadTan.create(F, F, W / 2, H / 2)


def window_inputs(seq, cam, k):
    """(CLAHE'd image, window uv [n,2] px, ids, world points [n,3]) of frame
    k: the landmarks it sees at least 18 px inside the image."""
    img = _clahe(render.render_frame(seq, k, cam, H, W, blob_sigma=3.0, style="textured"))
    vis = np.nonzero(seq.obs_valid[k].numpy())[0]
    uv = normalized_to_pixel(cam, seq.obs[k][vis].float()).numpy().astype(np.float64)
    inb = (uv[:, 0] > 18) & (uv[:, 0] < W - 18) & (uv[:, 1] > 18) & (uv[:, 1] < H - 18)
    return img, uv[inb], vis[inb], seq.landmarks.numpy()[vis[inb]]


def keyframes(seq, cam):
    """Per keyframe: (t, p, q, img, win_uv, win_ids, win_pts3d), the pose and
    landmarks drifted by a yaw and an offset that grow along the circle."""
    for i, k in enumerate(FRAMES):
        img, uv, ids, pts = window_inputs(seq, cam, k)
        Rz = qnp.ypr_to_rot(np.array([0.12 * i / len(FRAMES), 0.0, 0.0]))
        d = np.array([0.5, -0.3, 0.05]) * i / len(FRAMES)
        p = Rz @ seq.gt_p[k].numpy() + d
        q = qnp.quat_mul(qnp.rot_to_quat(Rz), seq.gt_q[k].numpy())
        yield float(seq.frame_t[k]), p, q, img, uv, ids, pts @ Rz.T + d


def extrinsic(seq):
    return qnp.quat_to_rot(seq.q_bc.numpy()), seq.p_bc.numpy()

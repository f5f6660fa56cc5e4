"""Both packages' line frontends on the smoke set of `chip_smoke.py`, float32.

Feeds the first published frames of the smoke set (CLAHE'd and quantized to
8 bits as the runner's point frontend uploads them, then each package's own
2-level pyramid: level 0 as the image, level 1 as the second octave) through
`FrontendLines` of the JAX package and of the port, on the CPU, at the
smoke's widths (752×480, `max_lines` 64). Per frame it prints the lines each emits, the share of the
JAX segments within 0.5 px of a port segment (either endpoint order) and the
lines each tracks from the frame before; then the means.

Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/line_frontend_parity.py [binary|float] [FRAMES]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(binary=True, frames=30):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from plslam.models import frontend_lines as jfl
    from plslam.models.frontend_points import build_pyramid as j_pyramid
    from plslam.ops.cameras import PinholeRadTan as JCam
    from plslam_torch import runner
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.models import frontend_lines as tfl
    from plslam_torch.models.frontend_points import build_pyramid as t_pyramid
    from plslam_torch.models.frontend_points import to_u8
    from plslam_torch.ops.cameras import PinholeRadTan as TCam

    path, _ = chip_smoke.render_dataset()
    seq = EurocSequence.load(path)
    h, w, f = chip_smoke.H, chip_smoke.W, chip_smoke.F
    cam = (f, f, w / 2, h / 2)
    jfe = jfl.FrontendLines(JCam.create(*cam), max_lines=64, binary_desc=binary)
    tfe = tfl.FrontendLines(TCam.create(*cam), max_lines=64, binary_desc=binary, device="cpu")
    prev = (set(), set())
    rows = []
    for k in range(0, 2 * frames, 2):
        img = to_u8(runner._clahe(seq.image(k))).astype(np.float32) * (1.0 / 255.0)
        jp = j_pyramid(jnp.asarray(img), 2)
        tp = t_pyramid(torch.as_tensor(img), 2)
        jids, jsegs = (np.asarray(a) for a in jfe.process(jp[0], 0.05 * k, oct1=jp[1]))
        tids, tsegs = (np.asarray(a) for a in tfe.process(tp[0], 0.05 * k, oct1=tp[1]))
        jsegs, tsegs = jsegs * f, tsegs * f  # normalized → pixels
        near = 1.0
        if len(jsegs):
            d = np.full(len(jsegs), np.inf)
            if len(tsegs):
                swap = tsegs[:, [2, 3, 0, 1]]
                d = np.minimum(np.abs(jsegs[:, None] - tsegs[None]).max(-1),
                               np.abs(jsegs[:, None] - swap[None]).max(-1)).min(1)
            near = float(np.mean(d < 0.5))
        tracked = (len(set(jids.tolist()) & prev[0]), len(set(tids.tolist()) & prev[1]))
        prev = (set(jids.tolist()), set(tids.tolist()))
        rows.append((len(jids), len(tids), near, *tracked))
        print(f"frame {k}: lines jax {len(jids)} port {len(tids)}; JAX segments within 0.5 px "
              f"{near:.3f}; tracked jax {tracked[0]} port {tracked[1]}", flush=True)
    m = np.mean(rows, axis=0)
    print(f"mean over {frames} frames: lines jax {m[0]:.2f} port {m[1]:.2f}; within 0.5 px "
          f"{m[2]:.4f}; tracked jax {m[3]:.2f} port {m[4]:.2f}")


if __name__ == "__main__":
    main(binary=(sys.argv[1] if len(sys.argv) > 1 else "binary") == "binary",
         frames=int(sys.argv[2]) if len(sys.argv) > 2 else 30)

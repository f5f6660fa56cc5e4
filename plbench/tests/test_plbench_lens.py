"""The configuration file's lens: the scene generator draws it, the port is
handed it, and what neither takes whole is refused."""
import copy
import hashlib
import io
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from plbench import cell, run, scene

# EuRoC cam0 as VINS-Mono's config/euroc/euroc_config.yaml gives it, and
# TUM-VI's 512-px equidistant camera (Schubert et al., IROS 2018)
EUROC = dict(model="pinhole", width=752, height=480, fx=461.6, fy=460.3, cx=363.0, cy=248.1,
             k1=-0.2917, k2=0.08228, p1=5.333e-05, p2=-1.578e-04)
TUMVI = dict(model="kannala_brandt", width=512, height=512, fx=190.978, fy=190.973, cx=254.932,
             cy=256.897, kb2=0.0034824, kb3=0.00071503, kb4=-0.0020532, kb5=0.00020294)

# SHA-256 of frames 0, 1, 2 and 200 of each mix's recording, rendered on the
# CPU by the generator as it was before it took a lens (the ideal pinhole
# with fx on both axes): the zero-lens path must draw the same bytes
PINHOLE_FRAMES = {
    "euroc_plvio.stream": [
        "fbd73c6f1fe1090d090617c830ab31e09969194d65184eec1090f5167f5c84dd",
        "fa5f8d581c5ec386181c120abd61497ac1218f74e563a333ff34146f0444bd89",
        "be18bff493f085654c385d0058ccc517fee3b6399d0ee5afacca8582e2194a11",
        "3d26f03b62bcb64be366c6a3de46b2c63c2b1f78bfcf631f798164cce1be0cf2"],
    "euroc_plslam.revisit": [
        "3061628f4de15a185bbb578cc8b2835433cfaa81fd2b7fca79326568cf0ffa88",
        "7a319895fea4b0827dfe4e84de86237b2167bae58ec33a14c0dba5412c24e2e7",
        "b5cca67b680ff84c280e519d3db1f456e9fbdfbfe7a3f32ef0cd4d6b828fd318",
        "0621646e45bc13dfaadc228990580059d3f0db02284112b5a559539bc5cc5e41"],
}


@pytest.mark.parametrize("workload", sorted(PINHOLE_FRAMES))
def test_zero_lens_frames_are_the_pinholes(workload):
    recipe = cell.Cell(workload).recipe()
    assert recipe["camera"]["model"] == "pinhole" and scene.Lens(recipe["camera"]).ideal
    ren = scene.Renderer(scene.make_world(recipe, 0), recipe, "cpu")
    got = [hashlib.sha256(ren.frame(k).numpy().tobytes()).hexdigest() for k in (0, 1, 2, 200)]
    assert got == PINHOLE_FRAMES[workload]


@pytest.mark.parametrize("cam", [EUROC, TUMVI], ids=["radtan", "kb4"])
def test_lens_round_trip_through_the_ports_lift(cam):
    """Camera-frame points projected by the generator's lens and lifted by
    the port's camera (`ops/cameras.py`) come back to their normalized
    coordinates. The port's lift runs a fixed count of Newton steps (8 in
    `pixel_to_normalized`; `lift` takes 5 radial-tangential, at least 8
    Kannala-Brandt): in float64 they reach rounding at every pixel of both
    images (3.1e-15 at most), so 1e-12 is held; in float32, the port's
    working dtype, 1e-5 (1.4e-6 read at the fisheye's rim, ~3e-4 px)."""
    from plslam_torch.ops import cameras

    conf = {"camera": dict(cam, rate_hz=20)}
    port = cell.port_config({**_config(), **conf}).camera
    assert port.model_type == cell.MODELS[cam["model"]][0]
    lens = scene.Lens(cam)
    g = torch.Generator().manual_seed(5)
    p = torch.rand((4000, 3), generator=g, dtype=torch.float64) * 2.0 - 1.0
    p[:, 2] = 0.4 + 2.0 * torch.rand(4000, generator=g, dtype=torch.float64)
    mn = p[:, :2] / p[:, 2:]
    uv = lens.pixels(mn)
    inside = ((uv[:, 0] > 5) & (uv[:, 0] < cam["width"] - 5) & (uv[:, 1] > 5)
              & (uv[:, 1] < cam["height"] - 5))
    assert inside.sum() > 500
    mn, uv = mn[inside], uv[inside]
    cam_t = cameras.make_camera(port, dtype=torch.float64)
    for iters in (5, 8):
        back = cameras.lift(cam_t, uv, iters)
        assert float(torch.amax(torch.abs(back - mn))) < 1e-12
    back = cameras.pixel_to_normalized(cameras.make_camera(port), uv.float())
    assert float(torch.amax(torch.abs(back.double() - mn))) < 1e-5
    # the port's own projection lands on the generator's pixels
    assert float(torch.amax(torch.abs(cameras.normalized_to_pixel(cam_t, mn) - uv))) < 1e-9


def test_a_lens_bends_a_drawn_line():
    """Under a lens a segment is a polyline of short sub-segments through
    its points' lensed pixels; a straight pinhole line's midpoint lies on
    its chord, the lensed one's off it."""
    recipe = cell.Cell("euroc_plvio.stream").recipe()
    recipe = dict(recipe, scene=dict(recipe["scene"], duration_s=1.0), camera=EUROC)
    ren = scene.Renderer(scene.make_world(recipe, 0), recipe, "cpu")
    ps, pe = np.array([-1.5, -1.0, 2.0]), np.array([1.5, -1.0, 2.0])  # a row near the top
    uv = ren._polyline(ps, pe)
    steps = torch.linalg.norm(uv[1:] - uv[:-1], dim=-1)
    assert float(steps.max()) <= ren.MAX_STEP_PX
    mid = uv[len(uv) // 2]
    chord_y = 0.5 * float(uv[0, 1] + uv[-1, 1])
    assert abs(float(mid[1]) - chord_y) > 5.0  # barrel distortion bows the row
    img = torch.zeros((ren.h, ren.w))
    ren._draw_polyline(img, uv)
    col = int(round(float(mid[0])))
    # one stroke, at most half a pixel off the curve (at most 0.45 where
    # sub-segments meet: the strongest, not the sum)
    assert 0.45 * 0.9 - 1e-6 <= float(img[:, col].max()) <= 0.45 + 1e-6
    assert abs(int(torch.argmax(img[:, col])) - float(mid[1])) <= 1.5


def _config():
    return copy.deepcopy(cell.Cell("euroc_plvio.stream").config)


@pytest.mark.parametrize("model", ["mei", "scaramuzza"])
def test_a_model_the_generator_cannot_draw_raises(model):
    conf = _config()
    conf["camera"]["model"] = model
    with pytest.raises(ValueError, match="model"):
        cell.port_config(conf)
    with pytest.raises(ValueError, match="cannot draw"):
        scene.Lens(dict(conf["camera"]))


@pytest.mark.parametrize("edit", ["section", "camera_key", "unused_coefficient", "no_fy"])
def test_what_would_be_dropped_raises(edit):
    conf = _config()
    if edit == "section":
        conf["rolling"] = {"rolling_shutter": True}
    elif edit == "camera_key":
        conf["camera"]["xi"] = 1.2
    elif edit == "unused_coefficient":
        conf["camera"]["kb2"] = 0.01  # a Kannala-Brandt term on a pinhole
    else:
        del conf["camera"]["fy"]  # the port would take its own default
    with pytest.raises(ValueError):
        cell.port_config(conf)


def test_the_temporal_section_reaches_the_port():
    conf = _config()
    conf["temporal"] = {"estimate_td": True, "td": 0.003}
    t = cell.port_config(conf).temporal
    assert t.estimate_td is True and t.td == 0.003


def test_a_run_with_an_unsupported_model_exits_2(monkeypatch):
    load = cell.load_json

    def load_json(*parts):
        out = load(*parts)
        if parts[-1].endswith("configs/euroc_plvio.json"):
            out["camera"]["model"] = "mei"
        return out

    monkeypatch.setattr(cell, "load_json", load_json)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "euroc_plvio.stream", "--seed", "1", "--seconds", "1",
                       "--device", "cpu", "--trace", "0"])
    assert rc == 2 and out.getvalue() == ""
    assert "mei" in err.getvalue()

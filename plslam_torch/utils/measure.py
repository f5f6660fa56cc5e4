"""What the card check (`chip_smoke.py`) and the timing scripts under
`scripts/` share: the card's name and power limit, CUDA-event, profiler and
host timing, the LK kernel's inputs at the main path's shapes, the
PyTorch library calls that compute the Hamming matrix (a yardstick only: no
path of the port calls them), the pose graph's solve timed eagerly and
through CUDA graphs, the host's waits on the card, stamped, and a call's host
time behind a card kept busy by a sleep."""
from __future__ import annotations

import contextlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from plslam_torch.utils import device as _policy  # noqa: F401  (TF32 off: true fp32 matmuls)


def card_info():
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def cuda_time_ms(fn, reps=50, warmup=5):
    """Mean ms a call of `fn` over `reps` back-to-back calls, by CUDA events
    on the current stream, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HOST_CALLS, HOST_ROUNDS = 2000, 3  # `host_us`: calls a round, rounds
PROFILER_SESSIONS = 3  # `device_us`: sessions tried before it gives up


def host_us(fn):
    """µs of host time a call of `fn`: the mean over HOST_CALLS calls with no
    synchronize in between (what the caller's thread spends enqueuing), the
    fastest of HOST_ROUNDS such rounds."""
    for _ in range(20):
        fn()
    best = float("inf")
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, 1e6 * (time.perf_counter() - t0) / HOST_CALLS)
    torch.cuda.synchronize()
    return best


def device_us(fn, name, reps=50):
    """Device time per launch (µs) of the kernels whose name holds `name`
    that `fn` launches, from torch.profiler's raw device events over `reps`
    calls after one warm-up call: the mean over the launches whose records
    the profiler kept (it can drop some; a smoke run once kept 38 of 50,
    and a session can keep none: it is then run again, up to
    PROFILER_SESSIONS sessions)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and name in e.name()]
        if ns:
            return 1e-3 * sum(ns) / len(ns)
        print(f"device_us: profiler session {attempt} of {PROFILER_SESSIONS} kept no '{name}' "
              f"record of {reps} calls", file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler saw no '{name}' kernel in {PROFILER_SESSIONS} × {reps} calls")


def busy_card(ms: float) -> torch.cuda.Event:
    """Queue `torch.cuda._sleep` on the current stream for at least `ms` ms
    (sized by a timed sleep first) and return an event recorded after it:
    while `event.query()` is False the card is still busy with the sleep."""
    probe = 10_000_000  # cycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    cycles = int(probe * ms / max(start.elapsed_time(end), 1e-3)) + 1
    torch.cuda._sleep(cycles)
    done = torch.cuda.Event()
    done.record()
    return done


def host_ms_behind_busy_card(fn, busy_ms: float = 100.0):
    """(host ms of one call of `fn` queued behind `busy_card(busy_ms)`,
    whether the card was still busy when the call returned). A call that
    waits for the card takes about `busy_ms` and finds it idle; one that
    only queues returns at once."""
    done = busy_card(busy_ms)
    t0 = time.perf_counter()
    fn()
    ms = 1e3 * (time.perf_counter() - t0)
    busy = not done.query()
    torch.cuda.synchronize()
    return ms, busy


def shifted_texture(rng, h, w, dx, dy, sigma=3.0):
    """A smooth random texture and its bilinear shift by (dx, dy)."""
    img = rng.standard_normal((h, w))
    k = np.exp(-0.5 * (np.arange(-7, 8) / sigma) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = np.ascontiguousarray((img - img.min()) / (img.max() - img.min()), np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    sx = np.clip(xs - dx, 0, w - 1.001)
    sy = np.clip(ys - dy, 0, h - 1.001)
    x0, y0 = sx.astype(int), sy.astype(int)
    fx, fy = sx - x0, sy - y0
    img2 = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return img, img2.astype(np.float32)


def lk_inputs(dev, h=480, w=752, levels=4, n_features=150):
    """The main path's LK shapes (by default): an h×w shifted texture,
    `levels`-level pyramids, the detector's `n_features` corners with the
    last six moved to every border (padding / clamp paths). Returns (pyr1,
    pyr2, pts, valid, (dx, dy))."""
    from plslam_torch.models.frontend_points import build_pyramid, shi_tomasi_grid

    rng = np.random.default_rng(0)
    dx, dy = 3.7, -2.3
    img1, img2 = shifted_texture(rng, h, w, dx, dy)
    pyr1 = build_pyramid(torch.as_tensor(img1, device=dev), levels=levels)
    pyr2 = build_pyramid(torch.as_tensor(img2, device=dev), levels=levels)
    uv, _ = shi_tomasi_grid(pyr1[0], torch.zeros((1, 2), device=dev),
                            torch.zeros((1,), device=dev), cell=30, max_out=n_features)
    pts = uv.clone()
    pts[-6:] = torch.tensor([[4.2, 120.3], [w - 3.3, 60.1], [160.5, 2.6], [200.4, h - 2.8],
                             [11.3, 11.8], [w - 11.0, h - 10.6]], device=dev)
    valid = torch.ones(n_features, dtype=torch.bool, device=dev)
    return pyr1, pyr2, pts, valid, (dx, dy)


def hamming_inputs(rng, n1, n2, dev):
    """[n1,8] and [n2,8] int32 words carrying random uint32 bits from `rng`,
    with the extremes where the sizes allow: every bit set in d1[0] and
    d2[0] (distance 0), every bit clear in d1[1] (256 to d2[0]), and d2[1]
    equal to d1[2] (distance 0)."""
    a, b = (rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32) for n in (n1, n2))
    a[0] = b[0] = 0xFFFFFFFF
    if n1 > 1:
        a[1] = 0
    if n1 > 2 and n2 > 1:
        b[1] = a[2]
    return tuple(torch.from_numpy(x.view(np.int32)).to(dev) for x in (a, b))


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` whose data starts one element past the
    allocator's aligned base (4 B past 16-B alignment for int32)."""
    v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return v.copy_(x)


def unpack_bits(d: torch.Tensor) -> torch.Tensor:
    """[N,8] int32 words carrying uint32 bits → [N,256] int64 0/1 bits
    (word by word, least significant bit first)."""
    w = d.to(torch.int64) & 0xFFFFFFFF
    return ((w[:, :, None] >> torch.arange(32, device=d.device)) & 1).reshape(d.shape[0], -1)


def hamming_library_calls(d1, d2):
    """The two single PyTorch calls that compute the Hamming matrix of
    [N1,8] × [N2,8] words once their bits are unpacked (here, outside the
    calls): name → (call, decode of its result to the int32 distances).
    `torch.matmul` of ±1 float16 signs gives 256 − 2H (every partial sum is
    an integer within ±256, exact in float16); `torch.cdist(p=0)` of 0/1
    float32 bits counts the bits that differ."""
    b1, b2 = unpack_bits(d1), unpack_bits(d2)
    s1, s2t = (1 - 2 * b1).to(torch.float16), (1 - 2 * b2).to(torch.float16).T
    f1, f2 = b1.to(torch.float32), b2.to(torch.float32)
    return {
        "torch.matmul(±1 float16 signs)": (
            lambda: torch.matmul(s1, s2t), lambda m: ((256 - m.to(torch.float32)) / 2).to(torch.int32)),
        "torch.cdist(0/1 float32 bits, p=0)": (
            lambda: torch.cdist(f1, f2, p=0), lambda m: m.to(torch.int32)),
    }


def hamming_library(d1, d2):
    """The calls of `hamming_library_calls` on the card, each checked
    against `hamming_matrix_torch` bit for bit (it raises otherwise).
    Returns ({name: call}, the unpacking's ms by CUDA events, which no
    call's time includes)."""
    from plslam_torch.ops.kernels.hamming import hamming_matrix_torch

    unpack_ms = cuda_time_ms(lambda: hamming_library_calls(d1, d2), reps=20, warmup=2)
    ref = hamming_matrix_torch(d1, d2)
    calls = {}
    for name, (call, decode) in hamming_library_calls(d1, d2).items():
        if not torch.equal(decode(call()), ref):
            raise AssertionError(f"{name} does not give the Hamming matrix")
        calls[name] = call
    return calls, unpack_ms


def ms_in_turns(fns, reps=200, rounds=5):
    """{name: [ms a call, one a round]} for each of the callables `fns`:
    `rounds` rounds of `cuda_time_ms(fn, reps)`, taken in turns (one round
    of each, then the next), so that the calls share the host's load. Where
    the host paces the calls, that load moves single rounds by tens of
    percent."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_time_ms(fn, reps=reps))
    return times


def pgo_graph_vs_eager(pg, iters=12, rounds=2):
    """The run's dense PGO calls replayed on the card two ways, in turns:
    eagerly, and through one CUDA graph per (K, Ep) bucket recorded at the
    bucket's first call (a fresh set of graphs each pass, as in a run).
    Call c solves the first E edges of `pg`'s final graph at K node slots,
    as the run's c-th `optimize` did (from the final poses). Each call is
    timed on the host from packing its inputs to reading the solution back.
    Returns {"eager": [[ms a call] a pass], "graph": [[ms a call] a pass],
    "pack": [ms a call]}: `rounds` passes of each way."""
    from plslam_torch.models.pose_graph import _PCG_THRESHOLD, _pow2_at_least, optimize_4dof
    from plslam_torch.utils import cuda_graph

    calls = [(K, E) for K, E, _ in pg.times["optimize"] if K < _PCG_THRESHOLD]
    edges, n = pg.edges, pg.n
    out = {"eager": [], "graph": [], "pack": []}

    def solve(K, E, graphs):
        pg.edges = edges[:E]
        pg.n = 1 + max(max(e["i"], e["j"]) for e in pg.edges)
        Ep = _pow2_at_least(E)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = pg.pgo_inputs(K, Ep)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xyz, yaw, _ = cuda_graph.run(graphs, ("optimize_4dof", K, Ep, iters),
                                     lambda *a: optimize_4dof(*a, iters=iters), *args)
        xyz.cpu(), yaw.cpu()
        return 1e3 * (time.perf_counter() - t0), 1e3 * (t1 - t0)

    try:
        for _ in range(rounds):
            graphs = {}
            out["graph"].append([solve(K, E, graphs)[0] for K, E in calls])
            eager = [solve(K, E, None) for K, E in calls]
            out["eager"].append([ms for ms, _ in eager])
            out["pack"] = [pack for _, pack in eager]
    finally:
        pg.edges, pg.n = edges, n
    return out


@contextlib.contextmanager
def sync_stamps():
    """The host clock (`time.perf_counter`) and the Python line ("file:line")
    of every CUDA call that waits for the card while the block runs:
    PyTorch's sync debug mode warns at each (`.item()`, `bool(tensor)`, a
    pageable copy, a linalg `info` check), and the warning is stamped
    instead of shown. Yields the list of (stamp, line) pairs."""
    stamps = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stamps.append((time.perf_counter(), f"{filename}:{lineno}"))
        else:
            shown(message, category, filename, lineno, file, line)

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield stamps
        finally:
            torch.cuda.set_sync_debug_mode(prev)

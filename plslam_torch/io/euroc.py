"""EuRoC MAV dataset loader (ASL layout) — no ROS.

The port's own copy of `plslam/io/euroc.py`.

Replaces the reference's rosbag + `feature_tracker_node` input path
(SURVEY.md §2.1 'Point tracker node' → host data-pump). Reads
`mav0/cam0/data.csv` (+PNGs), `mav0/imu0/data.csv`, and
`mav0/state_groundtruth_estimate0/data.csv` (SURVEY.md §A.8).

Images load lazily (a sequence is ~1-2 GB); IMU/GT load eagerly as arrays.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult", "MH_05_difficult",
    "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]


@dataclass
class EurocSequence:
    root: str  # …/<sequence>/mav0
    imu_t: np.ndarray = field(default=None)  # [M] seconds
    imu_gyr: np.ndarray = field(default=None)  # [M,3]
    imu_acc: np.ndarray = field(default=None)  # [M,3]
    cam_t: np.ndarray = field(default=None)  # [F] seconds
    cam_files: list = field(default=None)
    gt_t: np.ndarray = field(default=None)
    gt_p: np.ndarray = field(default=None)
    gt_q: np.ndarray = field(default=None)  # wxyz
    gt_v: np.ndarray = field(default=None)

    @staticmethod
    def load(path: str) -> "EurocSequence":
        """path: either the sequence dir (containing mav0/) or mav0 itself."""
        root = path if os.path.basename(path) == "mav0" else os.path.join(path, "mav0")
        seq = EurocSequence(root=root)

        imu = np.loadtxt(os.path.join(root, "imu0", "data.csv"), delimiter=",", skiprows=1)
        seq.imu_t = imu[:, 0] * 1e-9
        seq.imu_gyr = imu[:, 1:4]
        seq.imu_acc = imu[:, 4:7]

        cam_csv = os.path.join(root, "cam0", "data.csv")
        ts, files = [], []
        with open(cam_csv) as fh:
            for row in csv.reader(fh):
                if row and row[0].strip().isdigit():
                    ts.append(int(row[0]) * 1e-9)
                    files.append(os.path.join(root, "cam0", "data", row[1].strip()))
        seq.cam_t = np.asarray(ts)
        seq.cam_files = files

        gt_csv = os.path.join(root, "state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gt_csv):
            gt = np.loadtxt(gt_csv, delimiter=",", skiprows=1)
            seq.gt_t = gt[:, 0] * 1e-9
            seq.gt_p = gt[:, 1:4]
            seq.gt_q = gt[:, 4:8]  # EuRoC GT stores qw qx qy qz
            seq.gt_v = gt[:, 8:11]
        return seq

    def image(self, k: int) -> np.ndarray:
        """Load frame k as float32 grayscale [H,W] in [0,1]."""
        return load_gray(self.cam_files[k])

    def imu_between(self, t0: float, t1: float):
        i0 = int(np.searchsorted(self.imu_t, t0 - 1e-9))
        i1 = int(np.searchsorted(self.imu_t, t1 - 1e-9))
        i0 = max(i0 - 1, 0)
        sl = slice(i0, min(i1 + 1, len(self.imu_t)))
        return self.imu_acc[sl], self.imu_gyr[sl], np.diff(self.imu_t[sl])


def load_gray(path: str) -> np.ndarray:
    """PNG → float32 [H,W] in [0,1]. Prefers the native C++ decoder
    (native/dataloader.cpp), then PIL / imageio, then a stdlib zlib reader
    (EuRoC PNGs are 8-bit grayscale)."""
    from plslam_torch.io import native

    img = native.load_png_gray(path)
    if img is not None:
        return img
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32) / 255.0
    except ImportError:
        pass
    try:
        import imageio.v3 as iio

        img = np.asarray(iio.imread(path))
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return img.astype(np.float32) / 255.0
    except ImportError:
        pass
    return _read_png_gray(path).astype(np.float32) / 255.0


def _read_png_gray(path: str) -> np.ndarray:
    """Minimal stdlib PNG decoder (8-bit grayscale, non-interlaced)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", chunk[:10])
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    assert bit_depth == 8, f"unsupported bit depth {bit_depth}"
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            out = line
        elif filt == 1:
            out = line.copy()
            for x in range(nch, stride):
                out[x] = (out[x] + out[x - nch]) & 0xFF
        elif filt == 2:
            out = (line + prev) & 0xFF
        elif filt == 3:
            out = line.copy()
            for x in range(stride):
                a = out[x - nch] if x >= nch else 0
                out[x] = (out[x] + ((a + int(prev[x])) >> 1)) & 0xFF
        elif filt == 4:
            out = line.copy()
            for x in range(stride):
                a = int(out[x - nch]) if x >= nch else 0
                b = int(prev[x])
                c = int(prev[x - nch]) if x >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                out[x] = (out[x] + pred) & 0xFF
        img[y] = out.astype(np.uint8)
        prev = img[y]
    img = img.reshape(h, w, nch)
    return img.mean(axis=-1) if nch > 1 else img[:, :, 0]

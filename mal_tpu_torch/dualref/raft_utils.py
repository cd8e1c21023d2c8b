"""RAFT-lineage utilities: optical-flow visualization, flow/disparity file
I/O, input padding, and flow warm-start interpolation.

The port's own copy of `mal_tpu.dualref.raft_utils` (numpy on the host;
the port imports nothing of `mal_tpu`).

Completes the DualRefine stack's utility surface
(`dualrefine/networks/utils/{flow_viz,frame_utils,utils}.py`, SURVEY.md
§2.3 "RAFT utils"): the reference vendors these from princeton-vl/RAFT.
Host-side numpy throughout — none of this is on the device hot path.

- Flow rendering uses the standard Middlebury color wheel (Baker et al.,
  "A Database and Evaluation Methodology for Optical Flow", ICCV 2007)
  exactly as `flow_viz.py:20-131` does.
- File formats: Middlebury `.flo` (little-endian, magic 202021.25), PFM,
  and the KITTI 16-bit PNG encodings (`frame_utils.py:15-123`).
- `InputPadder` pads to a multiple of 8 with edge replication
  (`utils/utils.py:28-45`) — NHWC here, matching mal_tpu's TPU layout,
  instead of the reference's NCHW.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

FLO_MAGIC = 202021.25


# ---------------------------------------------------------------------------
# flow visualization (Middlebury color wheel)
# ---------------------------------------------------------------------------

def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB color wheel: RY 15, YG 6, GC 4, CB 11, BM 13, MR 6
    sectors. Within a sector one channel is pinned at 255 while the other
    ramps floor(255*i/n) up, or 255 minus that down (the Scharstein/Sun
    rounding — NOT floor of the descending interpolant)."""
    # (length, pinned channel, ramping channel, ramp direction)
    sectors = [(15, 0, 1, +1), (6, 1, 0, -1), (4, 1, 2, +1),
               (11, 2, 1, -1), (13, 2, 0, +1), (6, 0, 2, -1)]
    rows = []
    for n, pin, ramp_ch, direction in sectors:
        block = np.zeros((n, 3))
        block[:, pin] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        block[:, ramp_ch] = ramp if direction > 0 else 255 - ramp
        rows.append(block)
    return np.concatenate(rows, axis=0)


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Map normalized (|flow| <= 1 in-range) u/v fields to (H, W, 3) uint8."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi            # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    in_range = rad <= 1
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1.0 - f) * col0 + f * col1
        # saturate toward white as |flow| -> 0; dim out-of-range pixels
        col = np.where(in_range, 1.0 - rad * (1.0 - col), col * 0.75)
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255.0 * col)
    return img


def flow_to_image(flow_uv: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization
    (`flow_viz.py:109-131`)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u = flow_uv[..., 0]
    v = flow_uv[..., 1]
    rad_max = np.max(np.sqrt(u ** 2 + v ** 2))
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)


# ---------------------------------------------------------------------------
# file I/O
# ---------------------------------------------------------------------------

def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo: magic f32, W i32, H i32, then (H, W, 2) f32
    interleaved (little-endian)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = struct.unpack("<i", f.read(4))[0]
        h = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(h * w * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2).astype(np.float32)


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(flow[..., :2], dtype="<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Portable float map: 'PF' (color) / 'Pf' (gray) header, dims line,
    scale line (sign = endianness), rows stored bottom-up."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), dtype=endian + "f4")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def read_flow_kitti(path: str):
    """KITTI flow PNG: 16-bit BGR; flow = (value - 2^15) / 64, third
    channel = validity. Returns (flow (H, W, 2) f32, valid (H, W) f32)."""
    import cv2
    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)     # BGR -> RGB = (u, v, valid)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    import cv2
    uv = (64.0 * flow[..., :2] + 2 ** 15).astype(np.uint16)
    valid = np.ones((flow.shape[0], flow.shape[1], 1), np.uint16)
    cv2.imwrite(path, np.concatenate([uv, valid], axis=-1)[..., ::-1])


def read_disp_kitti(path: str):
    """KITTI disparity PNG (uint16 / 256, 0 = invalid) in flow form:
    returns (stack([-disp, 0], -1), disp > 0) per `frame_utils.py:112-117`
    (RAFT treats stereo disparity as horizontal flow)."""
    import cv2
    disp = cv2.imread(path, cv2.IMREAD_ANYDEPTH) / 256.0
    valid = disp > 0.0
    return np.stack([-disp, np.zeros_like(disp)], axis=-1), valid


def read_gen(path: str):
    """Extension-dispatched reader (`frame_utils.py:126-140`)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        from PIL import Image
        return Image.open(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        arr = read_pfm(path)
        return arr[..., :-1] if arr.ndim == 3 else arr
    raise ValueError(f"unsupported extension: {path}")


# ---------------------------------------------------------------------------
# padding + warm start
# ---------------------------------------------------------------------------

class InputPadder:
    """Pads NHWC (or HWC / HW) arrays so H and W are multiples of 8 with
    edge replication; `unpad` crops back. mode='sintel' centers the pad,
    otherwise all height padding goes below (`utils/utils.py:28-45`)."""

    def __init__(self, dims, mode: str = "sintel", multiple: int = 8):
        # dims: any shape tuple whose trailing spatial axes are (H, W) or
        # (H, W, C); NHWC arrays pass their .shape directly
        if len(dims) >= 3:
            h, w = dims[-3], dims[-2]
            self._chan_last = True
        else:
            h, w = dims[-2], dims[-1]
            self._chan_last = False
        m = multiple
        pad_h = (((h // m) + 1) * m - h) % m
        pad_w = (((w // m) + 1) * m - w) % m
        if mode == "sintel":
            self._pad = (pad_h // 2, pad_h - pad_h // 2,
                         pad_w // 2, pad_w - pad_w // 2)
        else:
            self._pad = (0, pad_h, pad_w // 2, pad_w - pad_w // 2)

    def _axes(self, ndim: int):
        hax = ndim - 3 if self._chan_last else ndim - 2
        return hax, hax + 1

    def pad(self, *arrays):
        out = []
        for x in arrays:
            hax, wax = self._axes(x.ndim)
            widths = [(0, 0)] * x.ndim
            widths[hax] = (self._pad[0], self._pad[1])
            widths[wax] = (self._pad[2], self._pad[3])
            out.append(np.pad(np.asarray(x), widths, mode="edge"))
        return out


    def unpad(self, x):
        hax, wax = self._axes(x.ndim)
        h, w = x.shape[hax], x.shape[wax]
        sl = [slice(None)] * x.ndim
        sl[hax] = slice(self._pad[0], h - self._pad[1])
        sl[wax] = slice(self._pad[2], w - self._pad[3])
        return x[tuple(sl)]


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Warm-start flow for the next frame pair: splat each pixel's flow to
    where it lands, then fill by nearest-neighbour scattered interpolation
    (`utils/utils.py:48-67`). flow: (2, H, W) or (H, W, 2)."""
    from scipy import interpolate as si

    chan_first = flow.shape[0] == 2 and flow.ndim == 3
    if not chan_first:
        flow = np.moveaxis(flow, -1, 0)
    dx, dy = flow[0], flow[1]
    h, w = dx.shape
    x0, y0 = np.meshgrid(np.arange(w), np.arange(h))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    keep = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    x1, y1, dxf, dyf = x1[keep], y1[keep], dxf[keep], dyf[keep]
    out_dx = si.griddata((x1, y1), dxf, (x0, y0), method="nearest",
                         fill_value=0)
    out_dy = si.griddata((x1, y1), dyf, (x0, y0), method="nearest",
                         fill_value=0)
    out = np.stack([out_dx, out_dy], axis=0).astype(np.float32)
    return out if chan_first else np.moveaxis(out, 0, -1)

"""KITTI raw/odometry loaders + velodyne GT-depth projection (the port's
copy of `mal_tpu.data.kitti`).

Reproduces `manydepth/datasets/kitti_dataset.py:19-159` and
`manydepth/kitti_utils.py:50-102` (calib parsing, cam->rect x velo->cam
projection, duplicate-pixel min-depth dedupe) plus the
`export_gt_depth.py:12-58` tool as `export_gt_depths`.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
from PIL import Image

from mal_tpu_torch.data.mono_dataset import MonoDataset, pil_loader

# normalized KITTI intrinsics (`kitti_dataset.py:26-29`)
KITTI_K = np.array([[0.58, 0, 0.5, 0],
                    [0, 1.92, 0.5, 0],
                    [0, 0, 1, 0],
                    [0, 0, 0, 1]], dtype=np.float32)

KITTI_FULL_RES = (1242, 375)  # (W, H)
SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


class KITTIRAWDataset(MonoDataset):
    def index_to_folder_and_frame_idx(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder,
                            f"image_0{SIDE_MAP[side]}/data", f_str)

    def get_color(self, folder, frame_index, side, do_flip):
        img = pil_loader(self.get_image_path(folder, frame_index, side))
        if do_flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def load_intrinsics(self, folder, frame_index):
        return KITTI_K.copy()

    def get_depth(self, folder, frame_index, side, do_flip):
        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo_filename = os.path.join(
            self.data_path, folder,
            "velodyne_points/data/{:010d}.bin".format(int(frame_index)))
        depth = generate_depth_map(calib_path, velo_filename, SIDE_MAP[side])
        depth = _resize_nn(depth, KITTI_FULL_RES[1], KITTI_FULL_RES[0])
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class KITTIOdomDataset(KITTIRAWDataset):
    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(self.data_path,
                            "sequences/{:02d}".format(int(folder)),
                            f"image_{SIDE_MAP[side]}", f_str)


# ---------------------------------------------------------------------------
# Velodyne -> depth map (`manydepth/kitti_utils.py`)
# ---------------------------------------------------------------------------

def read_calib_file(path: str) -> dict:
    data = {}
    with open(path) as f:
        for line in f:
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value.strip()
    return data


def load_velodyne_points(filename: str) -> np.ndarray:
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0  # homogeneous
    return points


def sub2ind(matrix_size, row_sub, col_sub):
    m, n = matrix_size
    return row_sub * (n - 1) + col_sub - 1


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Project velodyne points into the camera image plane."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_f = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.hstack((velo2cam_f["R"].reshape(3, 3),
                          velo2cam_f["T"].reshape(3, 1)))
    velo2cam = np.vstack((velo2cam, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_cam2rect = np.eye(4)
    R_cam2rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = np.dot(np.dot(P_rect, R_cam2rect), velo2cam)

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0, :]  # points in front of the car

    velo_pts_im = np.dot(P_velo2im, velo.T).T
    velo_pts_im[:, :2] = velo_pts_im[:, :2] / velo_pts_im[:, 2][..., np.newaxis]
    if vel_depth:
        velo_pts_im[:, 2] = velo[:, 0]

    # round to pixel and keep in-bounds points (torch ref rounds with -1)
    velo_pts_im[:, 0] = np.round(velo_pts_im[:, 0]) - 1
    velo_pts_im[:, 1] = np.round(velo_pts_im[:, 1]) - 1
    val_inds = (velo_pts_im[:, 0] >= 0) & (velo_pts_im[:, 1] >= 0)
    val_inds &= (velo_pts_im[:, 0] < im_shape[1]) & (velo_pts_im[:, 1] < im_shape[0])
    velo_pts_im = velo_pts_im[val_inds, :]

    depth = np.zeros(im_shape)
    depth[velo_pts_im[:, 1].astype(np.int32),
          velo_pts_im[:, 0].astype(np.int32)] = velo_pts_im[:, 2]

    # duplicate points: keep the closest
    inds = sub2ind(depth.shape, velo_pts_im[:, 1], velo_pts_im[:, 0])
    dupe_inds = [item for item, count in Counter(inds).items() if count > 1]
    for dd in dupe_inds:
        pts = np.where(inds == dd)[0]
        x_loc = int(velo_pts_im[pts[0], 0])
        y_loc = int(velo_pts_im[pts[0], 1])
        depth[y_loc, x_loc] = velo_pts_im[pts, 2].min()
    depth[depth < 0] = 0
    return depth


def _resize_nn(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * arr.shape[0] / h).astype(np.int32)
    xs = (np.arange(w) * arr.shape[1] / w).astype(np.int32)
    return arr[ys][:, xs]


def export_gt_depths(data_path: str, split_dir: str, out_path: str,
                     split: str = "eigen") -> int:
    """`export_gt_depth.py` equivalent: velodyne -> gt_depths.npz."""
    with open(os.path.join(split_dir, "test_files.txt")) as f:
        lines = [l.strip() for l in f if l.strip()]
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        calib_dir = os.path.join(data_path, folder.split("/")[0])
        velo = os.path.join(data_path, folder,
                            "velodyne_points/data", f"{frame_id:010d}.bin")
        gt_depths.append(generate_depth_map(calib_dir, velo, 2).astype(np.float32))
    np.savez_compressed(out_path, data=np.array(gt_depths, dtype=object))
    return len(gt_depths)


class KITTIDepthDataset(KITTIRAWDataset):
    """KITTI with the official updated GT depth maps
    (`manydepth/datasets/kitti_dataset.py:129-159`)."""

    def get_depth(self, folder, frame_index, side, do_flip):
        f_str = f"{frame_index:010d}.png"
        depth_path = os.path.join(
            self.data_path, folder,
            f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}", f_str)
        img = Image.open(depth_path)
        img = img.resize(KITTI_FULL_RES, Image.NEAREST)
        depth = np.asarray(img).astype(np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth

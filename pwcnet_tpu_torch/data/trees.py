"""Dataset trees written from a seed, in the layout each reader of
``data/datasets.py`` takes, for tests and smoke runs where the real
datasets are absent. The content is generated, not real data: frame 1 is
uniform noise, frame 2 the same noise moved by a whole-pixel flow (u, v)
drawn per pair (wrapping around the border), and the ground truth is that
flow everywhere (KITTI: on a random sparse subset of the pixels).

Each writer returns the root to give the reader.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from pwcnet_tpu_torch.io import (write_flo, write_kitti_png, write_pfm,
                                 write_png, write_ppm)

HW = Tuple[int, int]


def _pairs(n: int, hw: HW, seed: int
           ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """n (im1, im2, flow) of size ``hw``: uint8 frames, f32 flow."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        im1 = rng.integers(0, 256, (*hw, 3), np.uint8)
        u, v = (int(s) for s in rng.integers(-6, 7, 2))
        flow = np.empty((*hw, 2), np.float32)
        flow[..., 0], flow[..., 1] = u, v
        yield im1, np.roll(im1, (v, u), (0, 1)), flow


def _sequence(n: int, hw: HW, seed: int):
    """n + 1 frames, each the one before moved by its pair's flow, and the
    n flows."""
    pairs = list(_pairs(n, hw, seed))
    frames = [pairs[0][0]]
    for _, _, flow in pairs:
        frames.append(np.roll(frames[-1], (int(flow[0, 0, 1]),
                                           int(flow[0, 0, 0])), (0, 1)))
    return frames, [p[2] for p in pairs]


def _dir(*parts: str) -> str:
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


def write_chairs(root: str, n: int, hw: HW = (384, 512), seed: int = 0,
                 split_labels=None) -> str:
    """``NNNNN_img1.ppm``, ``NNNNN_img2.ppm`` and ``NNNNN_flow.flo`` in
    ``root``; with ``split_labels`` (1 = train, 2 = val, one per pair) also
    ``FlyingChairs_train_val.txt``."""
    _dir(root)
    for i, (im1, im2, flow) in enumerate(_pairs(n, hw, seed), 1):
        stem = os.path.join(root, f"{i:05d}")
        write_ppm(stem + "_img1.ppm", im1)
        write_ppm(stem + "_img2.ppm", im2)
        write_flo(stem + "_flow.flo", flow)
    if split_labels is not None:
        np.savetxt(os.path.join(root, "FlyingChairs_train_val.txt"),
                   np.asarray(split_labels, np.int64), fmt="%d")
    return root


def _pfm_flow(path: str, flow: np.ndarray) -> None:
    # FlyingThings3D stores flow as a 3-channel PFM, the third unused.
    write_pfm(path, np.concatenate(
        [flow, np.zeros(flow.shape[:2] + (1,), np.float32)], -1))


def write_things(root: str, n: int, hw: HW = (540, 960), seed: int = 0,
                 layout: str = "subset", split: str = "train") -> str:
    """n consecutive pairs of one sequence: ``layout="subset"`` under
    ``<split>/image_clean/left`` and ``<split>/flow/left/into_future``;
    ``"full"`` under ``frames_cleanpass/<TRAIN|TEST>/A/0000/left`` and
    ``optical_flows/<TRAIN|TEST>/A/0000/into_future/left``. Frame k + 1 is
    frame k moved by pair k's flow."""
    if layout == "subset":
        img_dir = _dir(root, split, "image_clean", "left")
        flow_dir = _dir(root, split, "flow", "left", "into_future")
        img_name, flow_name = "{:07d}.png", "{:07d}.pfm"
    else:
        part = "TEST" if split == "val" else "TRAIN"
        img_dir = _dir(root, "frames_cleanpass", part, "A", "0000", "left")
        flow_dir = _dir(root, "optical_flows", part, "A", "0000",
                        "into_future", "left")
        img_name = "{:04d}.png"
        flow_name = "OpticalFlowIntoFuture_{:04d}_L.pfm"
    frames, flows = _sequence(n, hw, seed)
    for k, frame in enumerate(frames):
        write_png(os.path.join(img_dir, img_name.format(k)), frame)
    for k, flow in enumerate(flows):
        _pfm_flow(os.path.join(flow_dir, flow_name.format(k)), flow)
    return root


def write_sintel(root: str, scenes: int, frames: int, hw: HW = (436, 1024),
                 seed: int = 0) -> str:
    """``training/<pass>/scene_S/frame_NNNN.png`` (frames 1..``frames``)
    and ``training/flow/scene_S/frame_NNNN.flo`` (1..``frames`` - 1); the
    final pass is the clean one with noise added."""
    rng = np.random.default_rng(seed + 1)
    for s in range(scenes):
        scene = f"scene_{s}"
        flow_dir = _dir(root, "training", "flow", scene)
        clean, flows = _sequence(frames - 1, hw, seed * 1000 + s)
        for k, flow in enumerate(flows, 1):
            write_flo(os.path.join(flow_dir, f"frame_{k:04d}.flo"), flow)
        for p in ("clean", "final"):
            img_dir = _dir(root, "training", p, scene)
            for k, im in enumerate(clean, 1):
                if p != "clean":
                    im = np.clip(im + rng.integers(-8, 9, im.shape), 0,
                                 255).astype(np.uint8)
                write_png(os.path.join(img_dir, f"frame_{k:04d}.png"), im)
    return root


def write_kitti(root: str, n: int, hw: HW = (375, 1242),
                seed: int = 0) -> str:
    """``training/image_2/NNNNNN_10.png`` and ``_11.png`` with the sparse
    16-bit ground truth ``training/flow_occ/NNNNNN_10.png``, valid on
    about 30% of the pixels."""
    img_dir = _dir(root, "training", "image_2")
    flow_dir = _dir(root, "training", "flow_occ")
    rng = np.random.default_rng(seed + 1)
    for i, (im1, im2, flow) in enumerate(_pairs(n, hw, seed)):
        write_png(os.path.join(img_dir, f"{i:06d}_10.png"), im1)
        write_png(os.path.join(img_dir, f"{i:06d}_11.png"), im2)
        valid = (rng.random(hw) < 0.3).astype(np.float32)
        write_kitti_png(os.path.join(flow_dir, f"{i:06d}_10.png"), flow,
                        valid)
    return root

"""The file datasets (counterpart of ``pwcnet_tpu/data/datasets.py``):
FlyingChairs, FlyingThings3D, Sintel and KITTI, with the JAX package's
directory layouts, pairing rules and splits, decoded by the port's own
codecs (``io/``). Each registers under the JAX package's name.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from pwcnet_tpu_torch.data.base import (FlowDataset, SampleRecord,
                                        read_image, register_dataset,
                                        require_dir)
from pwcnet_tpu_torch.io import load_flow, read_kitti_png


def _pair(rec: SampleRecord, flow: np.ndarray) -> Dict[str, np.ndarray]:
    return {"im1": read_image(rec.im1), "im2": read_image(rec.im2),
            "flow": flow}


@register_dataset("flyingchairs")
class FlyingChairs(FlowDataset):
    """A flat directory of ``NNNNN_img1.ppm``, ``NNNNN_img2.ppm`` and
    ``NNNNN_flow.flo``.

    Split: the published ``FlyingChairs_train_val.txt`` (1 = train,
    2 = val) when it lies in ``root`` or next to it; else a seeded 9:1
    split.
    """

    def __init__(self, root: str, split: str = "train"):
        require_dir(root, "FlyingChairs data")
        records = [SampleRecord(im1=fp[:-len("_flow.flo")] + "_img1.ppm",
                                im2=fp[:-len("_flow.flo")] + "_img2.ppm",
                                flow=fp)
                   for fp in sorted(glob.glob(os.path.join(root,
                                                           "*_flow.flo")))]
        if not records:
            raise FileNotFoundError(f"no *_flow.flo files under {root}")
        split_file = next(
            (c for c in (os.path.join(root, "FlyingChairs_train_val.txt"),
                         os.path.join(os.path.dirname(root.rstrip("/")),
                                      "FlyingChairs_train_val.txt"))
             if os.path.isfile(c)), None)
        if split_file is not None and split in ("train", "val"):
            labels = np.loadtxt(split_file, dtype=np.int64)
            want = 1 if split == "train" else 2
            self.records = [r for r, lab in zip(records, labels)
                            if lab == want]
        else:
            self.records = self.split_records(records, split)

    def _load(self, rec: SampleRecord) -> Dict[str, np.ndarray]:
        return _pair(rec, load_flow(rec.flow))


@register_dataset("flyingthings")
class FlyingThings(FlowDataset):
    """FlyingThings3D forward flow of the left view, in either published
    layout:

    - full: ``frames_<pass>/TRAIN/<abc>/<seq>/left/NNNN.png`` with
      ``optical_flows/TRAIN/<abc>/<seq>/into_future/left/
      OpticalFlowIntoFuture_NNNN_L.pfm`` (or ``flow/`` for
      ``optical_flows/``); val reads ``TEST``;
    - subset: ``<train|val>/image_clean/left/NNNNNNN.png`` with
      ``<train|val>/flow/left/into_future/NNNNNNN.pfm``.

    The PFM's unused third channel is dropped.
    """

    def __init__(self, root: str, split: str = "train",
                 render_pass: str = "cleanpass"):
        require_dir(root, "FlyingThings3D data")
        side = "val" if split == "val" else "train"
        subset_img = os.path.join(root, side, "image_clean", "left")
        records = []
        if os.path.isdir(subset_img):
            flow_dir = os.path.join(root, side, "flow", "left",
                                    "into_future")
            for fp in sorted(glob.glob(os.path.join(flow_dir, "*.pfm"))):
                idx = int(os.path.splitext(os.path.basename(fp))[0])
                im1 = os.path.join(subset_img, f"{idx:07d}.png")
                im2 = os.path.join(subset_img, f"{idx + 1:07d}.png")
                if os.path.isfile(im1) and os.path.isfile(im2):
                    records.append(SampleRecord(im1=im1, im2=im2, flow=fp))
        else:
            part = "TEST" if split == "val" else "TRAIN"
            frame_root = os.path.join(root, f"frames_{render_pass}", part)
            flow_root = os.path.join(root, "optical_flows", part)
            if not os.path.isdir(flow_root):
                flow_root = os.path.join(root, "flow", part)
            for seq in sorted(glob.glob(os.path.join(frame_root, "*", "*"))):
                rel = os.path.relpath(seq, frame_root)
                imgs = sorted(glob.glob(os.path.join(seq, "left", "*.png")))
                for im1, im2 in zip(imgs[:-1], imgs[1:]):
                    n1 = int(os.path.splitext(os.path.basename(im1))[0])
                    fp = os.path.join(flow_root, rel, "into_future", "left",
                                      f"OpticalFlowIntoFuture_{n1:04d}_L.pfm")
                    if os.path.isfile(fp):
                        records.append(SampleRecord(im1=im1, im2=im2,
                                                    flow=fp))
        if not records:
            raise FileNotFoundError(f"no usable pairs under {root}")
        self.records = records

    def _load(self, rec: SampleRecord) -> Dict[str, np.ndarray]:
        return _pair(rec, np.ascontiguousarray(load_flow(rec.flow)[..., :2]))


@register_dataset("sintel")
class Sintel(FlowDataset):
    """MPI Sintel: consecutive ``training/<pass>/<scene>/frame_NNNN.png``
    with ``training/flow/<scene>/frame_NNNN.flo`` (``root`` may also be the
    ``training`` directory itself). The split keeps whole scenes on one
    side (``split_groups``)."""

    def __init__(self, root: str, split: str = "train",
                 render_pass: str = "clean"):
        base = os.path.join(root, "training")
        if not os.path.isdir(base):
            base = root
        img_root = os.path.join(base, render_pass)
        flow_root = os.path.join(base, "flow")
        require_dir(img_root, f"Sintel {render_pass}")
        require_dir(flow_root, "Sintel flow")
        records, scenes = [], []
        for scene in sorted(os.listdir(img_root)):
            imgs = sorted(glob.glob(os.path.join(img_root, scene, "*.png")))
            for im1, im2 in zip(imgs[:-1], imgs[1:]):
                frame = os.path.splitext(os.path.basename(im1))[0]
                fp = os.path.join(flow_root, scene, frame + ".flo")
                if os.path.isfile(fp):
                    records.append(SampleRecord(im1=im1, im2=im2, flow=fp))
                    scenes.append(scene)
        if not records:
            raise FileNotFoundError(f"no usable pairs under {root}")
        self.records = self.split_groups(records, scenes, split)

    def _load(self, rec: SampleRecord) -> Dict[str, np.ndarray]:
        return _pair(rec, load_flow(rec.flow))


@register_dataset("kitti")
class KITTI(FlowDataset):
    """KITTI 2012/2015 flow: ``image_2/NNNNNN_10.png`` and ``_11.png``
    (KITTI 2012: ``colored_0``) with the sparse 16-bit PNG ground truth of
    ``flow_occ`` (or ``flow_noc``) and its valid mask; ``root`` or
    ``root/training``."""

    def __init__(self, root: str, split: str = "train",
                 occlusion: str = "occ"):
        base = os.path.join(root, "training")
        if not os.path.isdir(base):
            base = root
        img_root = os.path.join(base, "image_2")
        if not os.path.isdir(img_root):
            img_root = os.path.join(base, "colored_0")
        flow_root = os.path.join(base, f"flow_{occlusion}")
        require_dir(img_root, "KITTI image")
        require_dir(flow_root, "KITTI flow")
        records = []
        for fp in sorted(glob.glob(os.path.join(flow_root, "*_10.png"))):
            stem = os.path.basename(fp)[:-len("_10.png")]
            im1 = os.path.join(img_root, stem + "_10.png")
            im2 = os.path.join(img_root, stem + "_11.png")
            if os.path.isfile(im1) and os.path.isfile(im2):
                records.append(SampleRecord(im1=im1, im2=im2, flow=fp))
        if not records:
            raise FileNotFoundError(f"no usable pairs under {root}")
        self.records = self.split_records(records, split)

    def _load(self, rec: SampleRecord) -> Dict[str, np.ndarray]:
        flow, valid = read_kitti_png(rec.flow)
        return {**_pair(rec, flow), "valid": valid}

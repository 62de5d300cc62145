"""Command line of the port (counterpart of ``pwcnet_tpu/cli.py``):

    python -m pwcnet_tpu_torch.cli train   --preset chairs-1chip [--max-steps N] [--backend nccl|gloo] data.root=DIR [section.field=value ...]
    python -m pwcnet_tpu_torch.cli eval    --preset sintel-eval [--ckpt DIR] [--split val] [--backend nccl|gloo] data.root=DIR [...]
    python -m pwcnet_tpu_torch.cli predict --im1 a.png --im2 b.png [--ckpt DIR] [--out flow.flo] [--vis flow.png] [--backend nccl|gloo]
    python -m pwcnet_tpu_torch.cli match   --im1 a.png --im2 b.png [--ckpt DIR] [--out matches.txt] [--grid-step 8] [--fb-threshold 1.5]
    python -m pwcnet_tpu_torch.cli parity  --im1 a.png --im2 b.png [--gt gt.flo] [--ref-flow ref.flo] [--ckpt DIR|ref.pth] [--sweep]
    python -m pwcnet_tpu_torch.cli config  --preset synthetic-proof [...]

The presets are the JAX package's (``config.PRESETS``): the file datasets
read the tree under ``data.root``; ``synthetic-proof`` and
``synthetic-hard`` need none; ``raft-chairs`` (or ``model.family=raft``)
selects RAFT, ``model.family=raft_allpairs`` published RAFT (its all-pairs
pyramid of 4 levels), ``model.family=gma`` GMA (published RAFT with global
motion aggregation), ``model.family=gmflow`` GMFlow with refinement (its
shifted-window transformer, global and local matching; inference only:
``predict``, ``eval``, ``match``). It runs on the GPU;
``PWCNET_PLATFORM=cpu`` selects the CPU (the plain
versions of the kernels). With no GPU and no such setting it raises.
``--ckpt`` is a directory of the port's ``CheckpointManager``
(``step_<n>.pt``); an Orbax directory of the JAX package is refused.
``parity`` also takes a reference PWC-Net ``.pth``/``.pt`` state dict
(``compat/torch_import.py``) and prints its report as JSON
(``train/parity.py``).
``train``, ``eval`` and ``predict`` run on a (data, spatial, model) grid
of N processes, one per card (``parallel.data``, ``parallel.spatial``,
``parallel.model``; ``data=-1`` takes the processes left): start each with
``parallel.num_processes=N parallel.process_id=<rank>
parallel.coordinator=<host:port of rank 0>``, or all of them with
``torchrun --nproc_per_node=N -m pwcnet_tpu_torch.cli train ...``.
``train`` and ``eval`` split each batch over ``data`` and replicate over
``spatial`` and ``model``, as the JAX trainer does; ``predict`` shards the
pair's rows over ``spatial`` (``parallel.spatial_forward``). Process 0
alone prints and writes. ``--backend`` picks the collectives (default:
``nccl`` on the GPU, ``gloo`` on the CPU; ``gloo`` lets several ranks share
one card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np


def _device() -> Optional[str]:
    """``PWCNET_PLATFORM=cpu`` selects the CPU; unset, the GPU (None)."""
    import torch
    platform = os.environ.get("PWCNET_PLATFORM", "")
    if platform == "cpu":
        return "cpu"
    if platform:
        raise ValueError(f"PWCNET_PLATFORM={platform!r}: only 'cpu' is "
                         "supported (unset: the GPU)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set "
                           "PWCNET_PLATFORM=cpu to run on the CPU")
    return None


def _load_cfg(args):
    from pwcnet_tpu_torch.config import PRESETS, Config, apply_overrides
    cfg = PRESETS[args.preset] if args.preset else Config()
    return apply_overrides(cfg, args.overrides)


def _model(cfg, ckpt: Optional[str], device=None):
    """The config's model on ``device`` (None: the selected device), with
    the weights of the latest checkpoint under ``ckpt`` when given."""
    from pwcnet_tpu_torch.train.checkpoint import load_model_weights
    from pwcnet_tpu_torch.train.loop import build_model
    model = build_model(cfg, _device() if device is None else device)
    if ckpt:
        load_model_weights(model, ckpt)
    return model.eval()


def _mesh(cfg, backend: Optional[str]):
    """The grid that ``cfg.parallel`` names, joined as ``train`` joins it
    (a mesh of one process without a process group)."""
    from pwcnet_tpu_torch.parallel.mesh import (MeshConfig,
                                                initialize_distributed,
                                                make_mesh)
    device = _device()
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    p = cfg.parallel
    initialize_distributed(p.coordinator, p.num_processes, p.process_id,
                           backend)
    return make_mesh(MeshConfig(data=p.data, spatial=p.spatial,
                                model=p.model), backend=backend,
                     device=device)


def cmd_train(args) -> int:
    from pwcnet_tpu_torch.train.loop import train
    metrics = train(_load_cfg(args), max_steps=args.max_steps,
                    device=_device(), backend=args.backend)
    print(json.dumps(metrics))
    return 0


def cmd_eval(args) -> int:
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    cfg = _load_cfg(args)
    mesh = _mesh(cfg, args.backend)
    model = _model(cfg, args.ckpt, mesh.device)
    ds_kw = ({"hw": cfg.data.sample_hw, "regime": cfg.data.synthetic_regime,
              "val_length": cfg.data.synthetic_val_length}
             if cfg.data.name == "synthetic" else {})
    ds = get_dataset(cfg.data.name, cfg.data.root, split=args.split, **ds_kw)
    out = evaluate_dataset(model, ds, batch=cfg.data.eval_batch,
                           limit=cfg.train.eval_limit, mesh=mesh)
    if mesh.rank == 0:
        print(json.dumps(out))
    return 0


def cmd_predict(args) -> int:
    from pwcnet_tpu_torch.data.base import read_image
    from pwcnet_tpu_torch.io import flow_to_rgb, save_flow, write_png
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    from pwcnet_tpu_torch.parallel.spatial import predict_flow_spatial
    cfg = _load_cfg(args)
    mesh = _mesh(cfg, args.backend)
    model = _model(cfg, args.ckpt, mesh.device)
    im1, im2 = read_image(args.im1), read_image(args.im2)
    flow = (predict_flow_spatial(model, mesh, im1, im2)
            if mesh.spatial_mesh.size > 1 else predict_flow(model, im1, im2))
    if mesh.rank:
        return 0
    if args.out:
        save_flow(args.out, flow)
    if args.vis:
        write_png(args.vis, flow_to_rgb(flow))
    mag = float(np.sqrt((flow ** 2).sum(-1)).mean())
    print(json.dumps({"mean_flow_magnitude": mag, "shape": list(flow.shape)}))
    return 0


def cmd_match(args) -> int:
    from pwcnet_tpu_torch.data.base import read_image
    from pwcnet_tpu_torch.frontend import match_two_view
    cfg = _load_cfg(args)
    model = _model(cfg, args.ckpt)
    out = match_two_view(model, read_image(args.im1), read_image(args.im2),
                         grid_step=args.grid_step,
                         fb_threshold=args.fb_threshold)
    matches = np.concatenate(
        [out["pts1"], out["pts2"], out["confidence"][:, None]], axis=1)
    if args.out:
        np.savetxt(args.out, matches, fmt="%.3f",
                   header="x1 y1 x2 y2 confidence")
    print(json.dumps({
        "num_matches": int(len(matches)),
        "mean_confidence": float(out["confidence"].mean())
        if len(matches) else None,
        "median_fb_error_px": float(np.median(out["fb_error"])),
    }))
    return 0


def cmd_parity(args) -> int:
    from pwcnet_tpu_torch.train.parity import parity_report
    out = parity_report(_load_cfg(args), args.im1, args.im2,
                        gt_path=args.gt, ref_flow_path=args.ref_flow,
                        ckpt=args.ckpt, sweep=args.sweep, device=_device())
    print(json.dumps(out, indent=2))
    return 0


def cmd_config(args) -> int:
    print(json.dumps(dataclasses.asdict(_load_cfg(args)), indent=2,
                     default=str))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pwcnet_tpu_torch", description="PWC-Net and RAFT optical flow "
        "on the GPU (the PyTorch/CUDA port of pwcnet_tpu)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--preset", default=None,
                       help="named config preset (see pwcnet_tpu_torch."
                            "config.PRESETS)")
        p.add_argument("overrides", nargs="*",
                       help="section.field=value overrides")

    def backend(p):
        p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                       help="collectives of a run on several processes "
                            "(default: nccl on the GPU, gloo on the CPU)")

    p = sub.add_parser("train", help="run training")
    common(p)
    p.add_argument("--max-steps", type=int, default=None)
    backend(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint on a dataset")
    common(p)
    backend(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--split", default="val")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("predict", help="flow for one image pair")
    common(p)
    backend(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--im1", required=True)
    p.add_argument("--im2", required=True)
    p.add_argument("--out", default=None,
                   help=".flo / .pfm / KITTI .png output path")
    p.add_argument("--vis", default=None, help="color visualization (.png)")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("match", help="sparse two-view matches (forward-"
                       "backward-checked flow correspondences)")
    common(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--im1", required=True)
    p.add_argument("--im2", required=True)
    p.add_argument("--out", default=None,
                   help="matches text file: x1 y1 x2 y2 confidence")
    p.add_argument("--grid-step", type=int, default=8)
    p.add_argument("--fb-threshold", type=float, default=1.5)
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser(
        "parity", help="parity harness: EPE of one pair against a ground "
        "truth and/or a reference implementation's .flo, per level, and "
        "over the resize_mode x input_center conventions with --sweep")
    common(p)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint directory of the port, or a reference "
                        "PWC-Net .pth/.pt state dict")
    p.add_argument("--im1", required=True)
    p.add_argument("--im2", required=True)
    p.add_argument("--gt", default=None, help="ground-truth .flo")
    p.add_argument("--ref-flow", default=None,
                   help="reference implementation's predicted .flo")
    p.add_argument("--sweep", action="store_true",
                   help="report all resize_mode x input_center combinations")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("config", help="print the resolved config")
    common(p)
    p.set_defaults(fn=cmd_config)

    args = parser.parse_args(argv)
    rc = args.fn(args)
    import torch.distributed as dist
    if dist.is_initialized():  # no rank leaves while another needs the group
        dist.barrier()
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())

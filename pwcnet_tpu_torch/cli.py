"""Command line of the port (counterpart of ``pwcnet_tpu/cli.py``):

    python -m pwcnet_tpu_torch.cli train   --preset chairs-1chip [--max-steps N] data.root=DIR [section.field=value ...]
    python -m pwcnet_tpu_torch.cli eval    --preset sintel-eval [--ckpt DIR] [--split val] data.root=DIR [...]
    python -m pwcnet_tpu_torch.cli predict --im1 a.png --im2 b.png [--ckpt DIR] [--out flow.flo] [--vis flow.png]
    python -m pwcnet_tpu_torch.cli config  --preset synthetic-proof [...]

The presets are the JAX package's PWC-Net presets (``config.PRESETS``):
the file datasets read the tree under ``data.root``; ``synthetic-proof``
and ``synthetic-hard`` need none. It runs on the GPU;
``PWCNET_PLATFORM=cpu`` selects the CPU (the plain
versions of the kernels). With no GPU and no such setting it raises.
``--ckpt`` is a directory of the port's ``CheckpointManager``
(``step_<n>.pt``); an Orbax directory of the JAX package is refused.
``match`` and ``parity`` are not ported yet (ROADMAP A9).
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


def _model(cfg, ckpt: Optional[str]):
    """The config's model on the selected device, with the weights of the
    latest checkpoint under ``ckpt`` when given."""
    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model
    model = build_model(cfg, _device())
    if ckpt:
        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"checkpoint directory not found: {ckpt}")
        mgr = CheckpointManager(ckpt)
        if mgr.latest_step is None:
            raise ValueError(
                f"{ckpt} holds no step_<n>.pt of the port's "
                "CheckpointManager; an Orbax checkpoint of the JAX package "
                "needs JAX (convert its params with pwcnet_tpu_torch.compat."
                "load_flax_params)")
        model.load_state_dict(mgr.load()["model"])
    return model.eval()


def cmd_train(args) -> int:
    from pwcnet_tpu_torch.train.loop import train
    metrics = train(_load_cfg(args), max_steps=args.max_steps,
                    device=_device())
    print(json.dumps(metrics))
    return 0


def cmd_eval(args) -> int:
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    cfg = _load_cfg(args)
    model = _model(cfg, args.ckpt)
    ds_kw = ({"hw": cfg.data.sample_hw, "regime": cfg.data.synthetic_regime,
              "val_length": cfg.data.synthetic_val_length}
             if cfg.data.name == "synthetic" else {})
    ds = get_dataset(cfg.data.name, cfg.data.root, split=args.split, **ds_kw)
    out = evaluate_dataset(model, ds, batch=cfg.data.eval_batch,
                           limit=cfg.train.eval_limit)
    print(json.dumps(out))
    return 0


def cmd_predict(args) -> int:
    from pwcnet_tpu_torch.data.base import read_image
    from pwcnet_tpu_torch.io import flow_to_rgb, save_flow, write_png
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    cfg = _load_cfg(args)
    model = _model(cfg, args.ckpt)
    flow = predict_flow(model, read_image(args.im1), read_image(args.im2))
    if args.out:
        save_flow(args.out, flow)
    if args.vis:
        write_png(args.vis, flow_to_rgb(flow))
    mag = float(np.sqrt((flow ** 2).sum(-1)).mean())
    print(json.dumps({"mean_flow_magnitude": mag, "shape": list(flow.shape)}))
    return 0


def cmd_not_ported(args) -> int:
    raise NotImplementedError(f"the {args.cmd!r} command (the front-end and "
                              "the parity harness) is not ported yet "
                              "(ROADMAP A9)")


def cmd_config(args) -> int:
    print(json.dumps(dataclasses.asdict(_load_cfg(args)), indent=2,
                     default=str))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pwcnet_tpu_torch", description="PWC-Net optical flow on the "
        "GPU (the PyTorch/CUDA port of pwcnet_tpu)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--preset", default=None,
                       help="named config preset (see pwcnet_tpu_torch."
                            "config.PRESETS)")
        p.add_argument("overrides", nargs="*",
                       help="section.field=value overrides")

    p = sub.add_parser("train", help="run training")
    common(p)
    p.add_argument("--max-steps", type=int, default=None)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint on a dataset")
    common(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--split", default="val")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("predict", help="flow for one image pair")
    common(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--im1", required=True)
    p.add_argument("--im2", required=True)
    p.add_argument("--out", default=None,
                   help=".flo / .pfm / KITTI .png output path")
    p.add_argument("--vis", default=None, help="color visualization (.png)")
    p.set_defaults(fn=cmd_predict)

    for name, text in (("match", "sparse two-view matches (not ported)"),
                       ("parity", "reference-parity harness (not ported)")):
        p = sub.add_parser(name, help=text)
        common(p)
        p.add_argument("--ckpt", default=None)
        p.add_argument("--im1", default=None)
        p.add_argument("--im2", default=None)
        p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("config", help="print the resolved config")
    common(p)
    p.set_defaults(fn=cmd_config)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

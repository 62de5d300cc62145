"""Run jobs in one process per rank on this machine: spatially sharded
inference and gradients, and training on a (data, spatial, model) grid.

    python -m pwcnet_tpu_torch.parallel.launch RANK WORLD PORT JOB OUT_DIR

is one rank: it joins a ``torch.distributed`` group of WORLD processes at
``tcp://localhost:PORT``, runs the tasks of the job file (``torch.save`` of
a dict) and writes its results to ``OUT_DIR/rank<RANK>.pt``. ``run_ranks``
starts all ranks, waits for them under one time limit, stops them all if
one fails, and returns every rank's results.

A job: ``{"backend": "gloo" | "nccl", "device": "cpu" | "cuda" | "cuda:0",
"threads": int or None, "allow_tf32": bool or None, "tasks": [...]}``.
A task's ``"mesh"``, where it takes one, is a dict of ``MeshConfig``
fields (``{"data": 2, "spatial": 2}``); each task kind has its default.
Any task may carry ``"patch": {"module.name": "other.module.name"}``:
while it runs, each named object is replaced by the other (both imported
by name on the rank, e.g. a function that raises in place of a plain
version the run must not reach).
Tasks:
- ``{"kind": "exchange", "x": (N, H, ...) tensor, "top": int,
  "bottom": int, "grad": (N, H + S*(top+bottom), ...) tensor or None}``:
  ``exchange_rows`` of this rank's rows on a spatial mesh of all ranks;
  with ``grad``, also the gradient of this rank's rows for this rank's
  block of ``grad``: ``{"out":, "dx":}``;
- ``{"kind": "forward", "model": PWCNet kwargs, "state_dict": ..., "im1":,
  "im2": global images, "reps": int, "profile": bool, "mesh":}``:
  ``spatial_forward`` (default mesh: spatial over all ranks) once with the
  kernel launch counts of that call, then ``reps`` timed calls, then
  (``profile``) one call under ``torch.profiler``: the host operators that
  take the most time and the device's busy time;
- ``{"kind": "grad", "model": PWCNet kwargs, "state_dict":, "im1":,
  "im2":, "mesh":, "warmup": bool}``: the gradient of the sum over levels and pixels of
  flow**2 through ``spatial_forward`` (default mesh: spatial over all
  ranks), each rank's loss on its own rows of the gathered flows: this
  rank's rows of both images' gradients, the parameters' gradients summed
  over the spatial axis, the launches of the forward + backward (the plain
  forward correlation refused on the GPU) and its wall ms (with
  ``warmup``, of a second run after an uncounted first);
- ``{"kind": "warp_corr_grad", "f1":, "f2":, "flow": global (N, H, W,
  ...) tensors, "max_displacement":, "halo_rows":, "backend":,
  "fused_min_pixels":}``: ``warp_corr_spatial`` of this rank's rows on a
  spatial mesh of all ranks, and the gradients of this rank's rows of f1
  and f2 for the sum of its output squared: ``{"out":, "df1":, "df2":}``;
- ``{"kind": "mesh", "backend":, "device":, "mesh":}``: the grid (default:
  data over all ranks; by default with the job's backend and device): its
  world rank and size, device, backend, shape, this rank's data, spatial
  and model index, and the world ranks of its data and spatial groups;
- ``{"kind": "train", "cfg": Config, "max_steps": int, "digest": bool,
  "profile": bool, "capture": bool}``: ``train_with_state(cfg, max_steps,
  capture=capture)`` on this rank (``capture`` default None; the job's
  device and backend; ``cfg.parallel`` names the grid, e.g.
  ``data=2, spatial=2``): its final metrics, the kernel launches per step
  (the run takes ``max_steps`` steps), the wall seconds, and the final
  parameters (on the CPU), or their SHA-256 with ``digest``; with
  ``profile``, the run's collective host operators (``torch.profiler``,
  CPU activity);
- ``{"kind": "step", "cfg": Config, "state_dict": ..., "batches": [global
  batches], "aug": bool, "mesh":}``: ``run_steps`` on the grid (default:
  data over all ranks);
- ``{"kind": "eval", "cfg": Config, "state_dict": ..., "dataset":
  FlowDataset, "batch": int, "limit": int, "mesh":, "per_sample": bool}``:
  ``evaluate_dataset`` on the grid (default: data over all ranks); with
  ``per_sample``, ``{"result":, "per_sample":}``, the eval step's
  per-sample rows of every batch as every rank gathers them.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import List

import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]


def _launch_counters() -> list:
    """The kernel modules' ``LAUNCHES`` dicts, from the counter registry
    (importing the modules registers them)."""
    from pwcnet_tpu_torch import trace
    from pwcnet_tpu_torch.ops.kernels import (  # noqa: F401
        cost_volume_kernel, stem_kernel, warp_corr_kernel)
    return list(trace.groups("launches").values())


def _launches() -> dict:
    return {k: v for d in _launch_counters() for k, v in d.items() if v}


def _reset_launches() -> None:
    for d in _launch_counters():
        for k in d:
            d[k] = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def params_digest(model: torch.nn.Module) -> str:
    """SHA-256 of every parameter's bits, in ``named_parameters`` order."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


# Host operators of the collectives, as torch.profiler names them.
_COLLECTIVE = ("allreduce", "all_reduce", "allgather", "all_gather",
               "broadcast", "barrier", "gloo", "nccl")


def run_steps(cfg, state_dict: dict, batches: List[dict], mesh=None,
              aug: bool = False, device="cpu") -> dict:
    """``make_train_step`` of ``cfg`` (model, optimizer, loss, clipping,
    ``cfg.data.augment`` when ``aug``) from ``state_dict``, one step per
    global batch: on a ``mesh``, this rank's data row's rows on the mesh's
    device; without one, the whole batch on ``device``. Returns the
    metrics and the gradients of each step, and the final parameters and
    the generator's state, on the CPU."""
    from pwcnet_tpu_torch.parallel.mesh import shard_batch
    from pwcnet_tpu_torch.train.loop import build_model
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    dev = torch.device(device) if mesh is None else mesh.device
    model = build_model(cfg, dev)
    model.load_state_dict(state_dict)
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    step = make_train_step(model, opt, sched, loss_kind=cfg.train.loss,
                           level_weights=cfg.train.level_weights,
                           grad_clip=cfg.train.grad_clip,
                           aug=cfg.data.augment if aug else None, mesh=mesh)
    state = TrainState.create(model, opt, sched, seed=cfg.train.seed + 1)
    metrics, grads = [], []
    for b in batches:
        state, m = step(state, {k: v.to(dev) for k, v in
                                shard_batch(mesh, b).items()})
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    return {"metrics": metrics, "grads": grads,
            "params": {n: p.detach().cpu()
                       for n, p in model.named_parameters()},
            "generator": state.generator.get_state()}


def _eval(task: dict, mesh) -> dict:
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    from pwcnet_tpu_torch.train.loop import build_model
    model = build_model(task["cfg"], mesh.device).eval()
    model.load_state_dict(task["state_dict"])
    out = evaluate_dataset(model, task["dataset"], batch=task["batch"],
                           limit=task.get("limit"), mesh=mesh,
                           return_per_sample=bool(task.get("per_sample")))
    if not task.get("per_sample"):
        return out
    return {"result": out[0], "per_sample": out[1]}


def _grad(task: dict, mesh) -> dict:
    """The ``grad`` task (see the module docstring)."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.parallel.spatial import shard_rows, spatial_forward
    from pwcnet_tpu_torch.parallel.spatial_ops import all_reduce_sum
    sm = mesh.spatial_mesh
    model = PWCNet(device=mesh.device, **task["model"])
    model.load_state_dict(task["state_dict"])
    # Copies: the tasks of a job may share their image tensors.
    im1, im2 = (torch.as_tensor(task[k]).to(mesh.device, copy=True)
                .requires_grad_() for k in ("im1", "im2"))
    for _ in range(1 + bool(task.get("warmup"))):  # the last one counts
        for t in (im1, im2, *model.parameters()):
            t.grad = None
        _sync(mesh.device)
        _reset_launches()
        t0 = time.perf_counter()
        flows, _ = spatial_forward(model, sm, im1, im2)
        loss = sum((shard_rows(f, sm) ** 2).sum() for f in flows)
        loss.backward()
        _sync(mesh.device)
        wall = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    return {"loss": loss.item(), "launches": launches, "wall_ms": wall,
            "im1": shard_rows(im1.grad, sm).cpu().clone(),
            "im2": shard_rows(im2.grad, sm).cpu().clone(),
            "params": {n: all_reduce_sum(p.grad, sm).cpu()
                       for n, p in model.named_parameters()}}


def _warp_corr_grad(task: dict, sm) -> dict:
    """The ``warp_corr_grad`` task (see the module docstring)."""
    from pwcnet_tpu_torch.parallel.halo import warp_corr_spatial
    from pwcnet_tpu_torch.parallel.spatial import shard_rows
    f1, f2 = (shard_rows(task[k], sm).to(sm.device, copy=True)
              .requires_grad_() for k in ("f1", "f2"))
    flow = shard_rows(task["flow"], sm).to(sm.device)
    out = warp_corr_spatial(
        f1, f2, flow, sm, max_displacement=task["max_displacement"],
        halo_rows=task["halo_rows"], backend=task["backend"],
        fused_min_pixels=task.get("fused_min_pixels"))
    (out ** 2).sum().backward()
    return {"out": out.detach().cpu(), "df1": f1.grad.cpu(),
            "df2": f2.grad.cpu()}


@contextlib.contextmanager
def _patched(names: dict):
    """While open, each object named by a key of ``names`` (a dotted
    path) is the object named by its value."""
    import importlib
    from unittest import mock

    def resolve(name: str):
        module, _, attr = name.rpartition(".")
        return getattr(importlib.import_module(module), attr)

    with contextlib.ExitStack() as stack:
        for target, new in names.items():
            stack.enter_context(mock.patch(target, resolve(new)))
        yield


def _train(task: dict, job: dict) -> dict:
    from pwcnet_tpu_torch.train.loop import train_with_state
    dev = torch.device(job["device"])
    _sync(dev)
    _reset_launches()
    prof = None
    if task.get("profile"):
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
    t0 = time.perf_counter()
    try:
        final, state = train_with_state(task["cfg"], task["max_steps"],
                                        device=dev, backend=job["backend"],
                                        capture=task.get("capture"))
        _sync(state.model.device)
    finally:
        if prof is not None:
            prof.stop()
    out = {"final": final,
           "launches_per_step": {k: v / task["max_steps"]
                                 for k, v in _launches().items()},
           "wall_s": time.perf_counter() - t0,
           "params": params_digest(state.model) if task.get("digest") else
           {n: p.detach().cpu() for n, p in state.model.named_parameters()}}
    if prof is not None:
        out["collectives"] = [
            {"name": e.key[:60], "calls": e.count,
             "cpu_ms": e.cpu_time_total / 1e3}
            for e in prof.key_averages()
            if any(c in e.key.lower() for c in _COLLECTIVE)]
    return out


def _forward(task: dict, mesh) -> dict:
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.parallel.spatial import spatial_forward
    model = PWCNet(device=mesh.device, **task["model"]).eval()
    model.load_state_dict(task["state_dict"])
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)

    def run():
        return spatial_forward(model, mesh, task["im1"], task["im2"])

    with torch.inference_mode():
        sync()
        _reset_launches()
        flows, full = run()
        sync()
        launches = _launches()
        times = []
        barrier = (lambda: dist.barrier(mesh.group)) if mesh.size > 1 \
            else (lambda: None)
        for _ in range(task.get("reps", 0)):
            barrier()
            t0 = time.perf_counter()
            run()
            sync()
            barrier()  # the slowest rank's time
            times.append((time.perf_counter() - t0) * 1e3)
        prof = _profile(run, sync, mesh) if task.get("profile") else None
    return {"flows": [f.cpu() for f in flows], "full": full.cpu(),
            "launches": launches, "profile": prof,
            "wall_ms": statistics.median(times) if times else None}


def _profile(run, sync, mesh) -> dict:
    """One call under the profiler: wall ms, the device's busy ms (kernel
    entries), the host operators' summed self time (the rest of the wall
    is spent waiting: on the peers, on the device) and the 12 operators
    with the most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if mesh.device.type == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        sync()
    wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()
    busy = sum(e.self_device_time_total for e in evs
               if e.device_type == DeviceType.CUDA) / 1e3
    top = sorted(evs, key=lambda e: -e.self_cpu_time_total)[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "host_ops_ms": sum(e.self_cpu_time_total for e in evs) / 1e3,
            "host_top": [{"name": e.key[:60], "calls": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in top]}


def worker(rank: int, world: int, port: int, job_path: str,
           out_dir: str) -> None:
    from pwcnet_tpu_torch.parallel.mesh import (MeshConfig,
                                                initialize_distributed,
                                                make_mesh)
    job = torch.load(job_path, weights_only=False)
    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    if job.get("allow_tf32") is not None:
        torch.backends.cudnn.allow_tf32 = job["allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = job["allow_tf32"]
    initialize_distributed(f"localhost:{port}", world, rank, job["backend"])
    meshes = {}

    def mesh(task: dict, default: dict):
        """The task's grid (its "mesh", else ``default``), made once."""
        key = tuple(sorted(task.get("mesh", default).items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshConfig(**dict(key)),
                                    backend=job["backend"],
                                    device=job["device"])
        return meshes[key]

    try:
        results = []
        for task in job["tasks"]:
            with _patched(task.get("patch", {})):
                results.append(_task(task, job, mesh, world))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _task(task: dict, job: dict, mesh, world: int):
    """One task's result (see the module docstring); ``mesh(task,
    default)`` is the task's grid."""
    from pwcnet_tpu_torch.parallel.halo import exchange_rows
    from pwcnet_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from pwcnet_tpu_torch.parallel.spatial import shard_rows
    spatial_all = dict(data=1, spatial=world)
    kind = task["kind"]
    if kind == "exchange":
        m = mesh(task, spatial_all).spatial_mesh
        x = shard_rows(task["x"], m).to(m.device)
        if task.get("grad") is None:
            return exchange_rows(x, task["top"], task["bottom"], m).cpu()
        x = x.clone().requires_grad_()
        out = exchange_rows(x, task["top"], task["bottom"], m)
        out.backward(shard_rows(task["grad"], m).to(m.device))
        return {"out": out.detach().cpu(), "dx": x.grad.cpu()}
    if kind == "forward":
        return _forward(task, mesh(task, spatial_all))
    if kind == "grad":
        return _grad(task, mesh(task, spatial_all))
    if kind == "warp_corr_grad":
        return _warp_corr_grad(task, mesh(task, spatial_all).spatial_mesh)
    if kind == "mesh":
        m = make_mesh(MeshConfig(**task.get("mesh", dict(data=world))),
                      backend=task.get("backend", job["backend"]),
                      device=task.get("device", job["device"]))
        return {"rank": m.rank, "size": m.size, "device": str(m.device),
                "backend": m.backend, "shape": m.shape,
                "index": (m.data_index, m.spatial_index, m.model_index),
                "data_ranks": m.data_ranks,
                "spatial_ranks": m.spatial_ranks}
    if kind == "train":
        return _train(task, job)
    if kind == "step":
        return run_steps(task["cfg"], task["state_dict"], task["batches"],
                         mesh(task, dict(data=world)), task.get("aug", False))
    if kind == "eval":
        return _eval(task, mesh(task, dict(data=world)))
    raise ValueError(f"unknown task kind {kind!r}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, job: dict, out_dir: str, timeout: float = 600.0
              ) -> List[list]:
    """Run ``job`` on ``world`` ranks (one process each); returns each
    rank's list of task results. Raises if a rank fails or the time limit
    passes; every process is stopped before it returns or raises."""
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pwcnet_tpu_torch.parallel.launch", str(r),
         str(world), str(port), job_path, out_dir],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=str(_ROOT))
        for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None

    def first_failure():
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        return bad and f"rank {bad[0]} exited with {procs[bad[0]].returncode}"

    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = first_failure() or None
            if failed is None and time.monotonic() > deadline:
                failed = f"the ranks did not finish in {timeout} s"
            time.sleep(0.05)
        failed = failed or first_failure() or None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for r, f in enumerate(logs):
            f.seek(0)
            tails.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
            f.close()
    if failed:
        raise RuntimeError(f"job failed: {failed}\n"
                           + "\n".join(tails))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])

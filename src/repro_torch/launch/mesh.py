"""Workers on `torch.distributed` (port of `repro.launch.mesh`).

The reference builds a ("data", "model") `jax.sharding.Mesh`; the port's
workers are processes, and its meshes are process groups and the layouts
of `repro_torch.dist.sharding` (`HostMesh`, `MeshLayout`). Every rank runs
the same program with the same arguments.

  make_host_group(data, model)  the mesh a program of data × model ranks
                                runs on
  make_production_mesh(...)     the 16×16 or 2×16×16 layout, no processes
                                (the dry-run reads its shape)
  init_workers(...)             one rank's `init_process_group`, with the
                                backend rule of `sharding.backend_for`
  run_local_ranks(...)          start the ranks of one host as processes

On a machine with a card per rank, `torchrun --nproc-per-node m` starts the
ranks (`init_workers(int(os.environ["RANK"]), m, "env://")` in each takes
NCCL); ranks sharing one card take gloo.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.dist import sharding

SINGLE_POD = (16, 16)                  # 256 devices
MULTI_POD = (2, 16, 16)                # 512 devices
SINGLE_AXES = ("data", "model")
MULTI_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         start_ranks: bool = False) -> sharding.MeshLayout:
    """The reference's production layout: 16×16 ("data", "model") or
    2×16×16 ("pod", "data", "model"), as a `MeshLayout` with no
    processes (the dry-run reads its shape). Its 256 or 512 ranks span
    hosts, so this function cannot start them (`start_ranks` raises):
    `torchrun` over the hosts and `make_host_group` in each rank do."""
    if start_ranks:
        raise ValueError(
            "the production mesh's ranks span hosts: start them with "
            "torchrun and build the mesh in each with make_host_group")
    return sharding.MeshLayout(MULTI_AXES if multi_pod else SINGLE_AXES,
                               MULTI_POD if multi_pod else SINGLE_POD)


def make_host_group(data: int = 1, model: int = 1):
    """The mesh of data × model ranks in the initialized default group.

    At model 1 it is the group of `data` workers: None for one, else the
    default group. At model > 1 it is a `sharding.HostMesh`, rank =
    d·model + j as the reference's row-major mesh orders its devices,
    with one model group per data index and one data group per model
    index, made with `dist.new_group` (every rank makes every group, in
    the same order, as `new_group` requires)."""
    if data < 1 or model < 1:
        raise ValueError(f"data={data}, model={model}: axes must be >= 1")
    if data * model == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"data={data} × model={model} needs "
                           "torch.distributed initialized (init_workers) in "
                           "each of its ranks")
    if dist.get_world_size() != data * model:
        raise ValueError(f"data={data} × model={model}, but the default "
                         f"group holds {dist.get_world_size()} ranks")
    if model == 1:
        return dist.group.WORLD
    rank = dist.get_rank()
    model_groups = [dist.new_group([d * model + j for j in range(model)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model + j for d in range(data)])
                   if data > 1 else None for j in range(model)]
    return sharding.HostMesh(
        SINGLE_AXES, (data, model), rank=rank, world=dist.group.WORLD,
        model_group=model_groups[rank // model],
        data_group=data_groups[rank % model])


def init_workers(rank: int, world_size: int, init_method: str,
                 device=None, timeout_s: float = 300.0):
    """Join this rank to the default group and return (group, device).

    `device` (default `cuda`) is where the rank computes. The backend
    follows `sharding.backend_for`: NCCL when every rank has its own card,
    rank r then on card r; gloo on the CPU and for ranks that share a card
    (each on the card `device` names). A collective that waits longer than
    `timeout_s` raises instead of hanging."""
    dev = torch.device("cuda" if device is None else device)
    backend = sharding.backend_for(dev, world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl"
                           else (dev.index or 0))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dist.group.WORLD, dev


def run_local_ranks(argv_of: Callable[[int, str], list], world_size: int,
                    timeout_s: float, env: Optional[dict] = None) -> list:
    """Start `world_size` fresh interpreters, `python *argv_of(rank,
    init_method)`, with a `file://` store in a temporary directory, and
    wait for them; returns [(returncode, stdout, stderr)] in rank order.

    A rank that fails stops the others, and ranks still running after
    `timeout_s` are killed (returncode < 0), so a hung rank cannot outlive
    its caller's limit. The ranks' environment drops `XLA_FLAGS`."""
    env = dict(os.environ if env is None else env)
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        logs = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                 open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(world_size)]
        procs = []
        try:
            for r, (out, err) in enumerate(logs):
                procs.append(subprocess.Popen(
                    [sys.executable, *argv_of(r, init)], stdout=out,
                    stderr=err, env=env))
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(
                        c not in (None, 0) for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        return results

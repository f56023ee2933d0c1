"""Workers on `torch.distributed` (port of `repro.launch.mesh`).

The reference builds a ("data", "model") `jax.sharding.Mesh`; the port's
workers are processes, one per data-parallel worker, and its "mesh" is the
process group of their ranks (`repro_torch.dist.sharding`). Every rank runs
the same program with the same arguments.

  make_host_group(data, model)  the group a program of `data` ranks runs on
  init_workers(...)             one rank's `init_process_group`, with the
                                backend rule of `sharding.backend_for`
  run_local_ranks(...)          start the ranks of one host as processes

On a machine with a card per rank, `torchrun --nproc-per-node m` starts the
ranks (`init_workers(int(os.environ["RANK"]), m, "env://")` in each takes
NCCL); ranks sharing one card take gloo. `make_production_mesh` (TPU pods)
is not ported.
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


def make_host_group(data: int = 1, model: int = 1):
    """The group of `data` workers: None for one, else the initialized
    default group, which must hold `data` ranks. A model axis > 1 raises:
    the port's train step replicates the params (tensor parallelism over
    "model" is not ported, ROADMAP queue 1 item 4)."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: the port has no 'model' axis (tensor "
            "parallelism is not ported, ROADMAP queue 1 item 4)")
    if data == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"data={data} needs torch.distributed initialized "
                           "(init_workers) in each of its ranks")
    if dist.get_world_size() != data:
        raise ValueError(f"data={data}, but the default group holds "
                         f"{dist.get_world_size()} ranks")
    return dist.group.WORLD


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

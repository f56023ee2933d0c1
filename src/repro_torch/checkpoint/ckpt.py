"""Checkpointing (port of `repro.checkpoint.ckpt`): tree ↔ npz with a JSON
manifest.

Layout:  <dir>/step_<N>/arrays.npz  +  <dir>/step_<N>/manifest.json

The manifest holds every leaf's key path (`tree.keystr`, character for
character `jax.tree_util.keystr`), shape and dtype; restore rebuilds the
structure of a caller-provided template and checks the paths against it.
No pickle: numpy and json only, so a checkpoint crosses packages in both
directions (the reference writes the same files).

A tensor leaf moves to the host once (`.detach().cpu().numpy()`). numpy
has no bfloat16: a bf16 leaf is written as its raw 16-bit patterns (a
2-byte void array, as numpy stores the reference's bf16 leaves) with
`"dtype": "bfloat16"` in the manifest, and read back from the bits
whatever numpy shows for them (void or uint16). Restore puts each leaf on
the device of the template's leaf, in the template's dtype.

`save_federation` / `restore_federation` capture a whole
`repro_torch.fed.Federation`: server params, fedopt optimizer state,
fedmem memory, every client's EF tree, PRNG lane (as the reference's raw
uint32 key data) and participation counter, the adaptive allocator's
`NormEMA` and rates, and the round counter, so a restored federation
continues bitwise like an uninterrupted run.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib

_BF16 = "bfloat16"


def _flatten_with_names(tree):
    pairs, spec = tree_lib.flatten_with_path(tree)
    return ([x for _, x in pairs], [tree_lib.keystr(p) for p, _ in pairs],
            spec)


def _to_host(x) -> tuple:
    """(numpy array for the npz, manifest dtype name) of one leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).cpu().numpy()
            return bits.view("V2"), _BF16
        a = t.cpu().numpy()
        return a, str(a.dtype)
    a = np.asarray(x)
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write `tree` at `directory/step_<step>/`. Returns the path."""
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    flat, paths, _ = _flatten_with_names(tree)
    host = [_to_host(x) for x in flat]
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(host)})
    manifest = {"step": step,
                "leaves": [{"index": i, "path": p, "shape": list(a.shape),
                            "dtype": dtype}
                           for i, (p, (a, dtype)) in enumerate(zip(paths,
                                                                   host))]}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def _numpy_dtype(dtype: torch.dtype):
    """numpy's counterpart of a torch dtype (None for bfloat16)."""
    if dtype == torch.bfloat16:
        return None
    return torch.empty(0, dtype=dtype).numpy().dtype


def _like(a: np.ndarray, dtype: str, like):
    """Saved array `a` (manifest dtype `dtype`) as the template leaf's
    kind: a tensor on its device in its dtype, or a numpy array."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(a).astype(np.asarray(like).dtype)
    a = np.require(a, requirements="C")        # keeps 0-d arrays 0-d
    if dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        want = _numpy_dtype(like.dtype)
        if want is not None and a.dtype != want:
            a = a.astype(want)
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into the structure of `like`. Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_flat, like_paths, spec = _flatten_with_names(like)
    saved_paths = [leaf["path"] for leaf in manifest["leaves"]]
    if saved_paths != like_paths:
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved:    {saved_paths[:5]}...\n  template: {like_paths[:5]}...")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [_like(z[f"a{leaf['index']}"], leaf["dtype"], t)
                  for leaf, t in zip(manifest["leaves"], like_flat)]
    return tree_lib.unflatten(spec, leaves), step


# ---------------------------------------------------------------------------
# Federation state (repro_torch.fed): everything a resumed run needs
# ---------------------------------------------------------------------------
def _key_data(key: torch.Tensor) -> np.ndarray:
    """A PRNG lane (int64 words of 32 bits) as the reference's uint32 key
    data."""
    return key.cpu().numpy().astype(np.uint32)


def federation_state(fed) -> dict:
    """One tree capturing a `repro_torch.fed.Federation`, keyed as the
    reference's `federation_state`, so the two packages write the same
    manifest. Live tensors, plus numpy leaves for the PRNG lanes, the round
    counter and the allocator; the tree doubles as the `like` template on
    restore. Codecs, data shards and round programs are not state: they
    come from building the federation with the same arguments (the saved
    rates rebuild the codecs through `set_rates`)."""
    tree = {
        "server": {"params": fed.server.params,
                   "opt_state": fed.server.opt_state,
                   "memory": fed.server.memory},
        "clients": {
            "ef": [s.ef for s in fed.states],
            "key_data": [_key_data(s.key) for s in fed.states],
            "rounds_seen": [s.rounds_seen for s in fed.states],
        },
        "round": np.asarray(fed.rounds_done, np.int64),
    }
    if fed._ema is not None:
        tree["ema"] = {"norms": fed._ema.norms, "seen": fed._ema.seen,
                       "rates": np.asarray(fed._rates, np.float64)}
    return tree


def save_federation(directory: str, fed, step: Optional[int] = None) -> str:
    """Checkpoint `fed` at `directory/step_<rounds_done>/` (or `step`)."""
    at = fed.rounds_done if step is None else step
    return save_checkpoint(directory, at, federation_state(fed))


def restore_federation(directory: str, fed,
                       step: Optional[int] = None) -> int:
    """Restore a checkpoint into `fed` IN PLACE; returns the restored step.

    `fed` must be built with the same arguments as the saved federation
    (the manifest's key paths are checked against it). After this call
    `fed.run(cfg)` continues from the saved round counter, bitwise like a
    run that never stopped."""
    from repro_torch.fed.clients import ClientState

    tree, at = restore_checkpoint(directory, federation_state(fed), step)
    s = tree["server"]
    fed.server = type(fed.server)(params=s["params"],
                                  opt_state=s["opt_state"],
                                  memory=s["memory"])
    fed.rounds_done = int(tree["round"])
    if fed._ema is not None:
        # the saved rates FIRST (they rebuild the codecs), then the EMA
        fed.set_rates(tree["ema"]["rates"].tolist())
        fed._ema.norms = np.asarray(tree["ema"]["norms"], np.float64)
        fed._ema.seen = np.asarray(tree["ema"]["seen"], bool)
    c = tree["clients"]
    fed.states = [
        ClientState(ef=c["ef"][i],
                    key=torch.from_numpy(
                        c["key_data"][i].astype(np.int64)).to(
                            fed.states[i].key.device),
                    rounds_seen=c["rounds_seen"][i])
        for i in range(len(fed.states))]
    return at


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None

"""Plain reference of a data-parallel worker's training step at one
worker: the loss and its gradients (`reference.model`), the consensus
(the exact mean, or each leaf through the NDSC codec with error feedback,
`reference.codec`), clipping by the global norm, and the optimizer (AdamW
with decoupled weight decay, or SGD), written from their published
update rules.

`run` follows the first steps from the seed's initial weights and reads
what the benchmark compares (`gaps`): each step's loss; each leaf's
first gradient as the optimizer receives it, read back the way it is
read from the program (AdamW: its first moment over 1 − β1; SGD: the
change of the weights over the learning rate); the second step's
gradient read the same way, on a strided sample of each leaf (`sample`);
and each leaf's change of the weights after the last step.

A weight stacked over the layers (and over the experts) is held as one
tensor a layer (and an expert), so that no gradient of a whole stacked
weight is ever formed beside another; the codec codes such a leaf piece
by piece, which codes the whole leaf's rows where every piece is whole
rows of `chunk` values (a leaf whose pieces are not is refused).
"""
from __future__ import annotations

import numpy as np
import torch

from bench import weights
from bench.reference import codec, model

SAMPLE = 1 << 22        # values of a leaf in the second step's sample


def _norm(pieces) -> float:
    return float(np.sqrt(sum(
        float(torch.linalg.vector_norm(p.reshape(-1),
                                       dtype=torch.float64)) ** 2
        for p in pieces)))


def stride(numel: int) -> int:
    """Every stride-th value of a leaf's flat order is in its sample."""
    return max(1, -(-numel // SAMPLE))


def sample(pieces) -> torch.Tensor:
    """The values at flat positions 0, s, 2s, ... of a leaf held as
    `pieces` (in flat order), s = stride(leaf size), as float64."""
    pieces = [pieces] if isinstance(pieces, torch.Tensor) else pieces
    step = stride(sum(p.numel() for p in pieces))
    out, offset = [], 0
    for p in pieces:
        out.append(p.reshape(-1)[(-offset) % step::step].double())
        offset += p.numel()
    return torch.cat(out)


def _split(x: torch.Tensor, stacked: int):
    """x's pieces: one a layer, and one an expert of it (nested lists),
    each a tensor of its own."""
    if stacked == 0:
        return x.clone()
    return [_split(x[i], stacked - 1) for i in range(x.shape[0])]


def _flat(tree) -> list:
    return ([p for t in tree for p in _flat(t)] if isinstance(tree, list)
            else [tree])


def _held(cfg: dict, seed: int, device) -> tuple:
    """The initial weights as the reference holds them: the model's tree
    (a stacked leaf as nested lists of pieces) and each leaf's pieces in
    flat order."""
    params: dict = {"blocks": {}}
    pieces = []
    for i, (path, shape) in enumerate(weights.leaf_shapes(cfg)):
        leaf = weights.make_leaf(cfg, seed, i, device)
        if path[0] == "blocks":
            tree = _split(leaf, len(shape) - 2)
            params["blocks"][path[1]] = tree
            pieces.append(_flat(tree))
        else:
            params[path[0]] = leaf
            pieces.append([leaf])
        del leaf
    return params, pieces


def _change(cfg, seed, i, pieces, device) -> float:
    """‖w − w₀‖ of leaf i, held as pieces."""
    w0 = weights.make_leaf(cfg, seed, i, device).reshape(-1)
    squares, offset = 0.0, 0
    for p in pieces:
        squares += _norm([p.reshape(-1) - w0[offset:offset + p.numel()]]) ** 2
        offset += p.numel()
    return float(np.sqrt(squares))


def _consensus(grads, ef, signs, traffic) -> None:
    """Each piece's gradient replaced by the decoded codec output of
    u = g + e, and e by u − decoded (in place)."""
    bits, chunk = traffic["bits"], traffic["chunk"]
    if len(grads) > 1 and any(g.numel() % chunk for g in grads):
        raise ValueError(f"a piece is not whole rows of {chunk}")
    for j, g in enumerate(grads):
        if ef is not None:
            g.add_(ef[j])
        decoded = codec.roundtrip(g, signs, bits, chunk)
        if ef is not None:
            torch.sub(g, decoded, out=ef[j])
        g.copy_(decoded)
        del decoded


def run(cfg: dict, traffic: dict, seed: int, batches: torch.Tensor,
        device, matmul=model._f32_matmul) -> dict:
    """Readings of len(batches) steps from the seed's initial weights."""
    train = cfg["training"]
    params, leaves = _held(cfg, seed, device)
    every = [p for pieces in leaves for p in pieces]
    zeros = lambda: [[torch.zeros_like(p) for p in pieces]  # noqa: E731
                     for pieces in leaves]
    ef = zeros() if traffic.get("error_feedback") else None
    adam = train["optimizer"] == "adamw"
    mu = zeros() if adam else None
    nu = zeros() if adam else None
    signs = [torch.from_numpy(codec.frame_signs(traffic.get("codec_seed", 0),
                                                i, traffic["chunk"])
                              ).to(device)
             for i in range(len(leaves))] \
        if traffic["strategy"] != "psum" else None
    # what the second step's gradient is read from, before and after it
    read = mu if adam else leaves
    losses, first_grad, second_grad, before = [], None, None, None
    for step, tokens in enumerate(batches, start=1):
        for p in every:
            p.requires_grad_(True)
        value = model.loss(cfg, params, tokens, matmul)
        flat = list(torch.autograd.grad(value, every))
        losses.append(float(value.detach()))
        del value
        for p in every:
            p.requires_grad_(False)
        grads, k = [], 0
        for pieces in leaves:
            grads.append(flat[k:k + len(pieces)])
            k += len(pieces)
        del flat
        if signs is not None:
            for i, g in enumerate(grads):
                _consensus(g, ef[i] if ef is not None else None, signs[i],
                           traffic)
        if train.get("clip_norm"):
            total = torch.sqrt(sum(torch.sum(c * c) for g in grads
                                   for c in g))
            scale = torch.clamp(train["clip_norm"]
                                / torch.clamp_min(total, 1e-12), max=1.0)
            for g in grads:
                for c in g:
                    c.mul_(scale)
        if step == 2:
            before = [sample(r) for r in read]
        _update(train, step, leaves, grads, mu, nu)
        del grads
        if step == 1 and adam:
            first_grad = [_norm(m) / (1.0 - train["b1"]) for m in mu]
        elif step == 1:
            first_grad = [_change(cfg, seed, i, p, device) / train["lr"]
                          for i, p in enumerate(leaves)]
        if step == 2:
            second_grad = [second(sample(r), b, train)
                           for r, b in zip(read, before)]
            del before
    change = [_change(cfg, seed, i, p, device) for i, p in enumerate(leaves)]
    return {"losses": losses, "first_grad": first_grad,
            "second_grad": second_grad, "change": change,
            "leaves": weights.leaf_names(cfg)}


def second(after: torch.Tensor, before: torch.Tensor, train: dict) -> float:
    """The norm of the second step's gradient on a leaf's sample, from the
    sample of what it is read from before and after the step: AdamW's
    first moment, μ₂ = β1·μ₁ + (1 − β1)·g₂; SGD's weights,
    w₂ = w₁ − lr·g₂."""
    if train["optimizer"] == "sgd":
        g = (before - after) / train["lr"]
    else:
        g = (after - train["b1"] * before) / (1.0 - train["b1"])
    return float(torch.linalg.vector_norm(g))


def _update(train: dict, step: int, leaves, grads, mu, nu) -> None:
    lr = train["lr"]
    with torch.no_grad():
        if train["optimizer"] == "sgd":
            for pieces, g in zip(leaves, grads):
                for p, c in zip(pieces, g):
                    p.add_(-lr * c)
            return
        b1, b2, eps, wd = (train["b1"], train["b2"], train["eps"],
                           train["weight_decay"])
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for pieces, g, ms, vs in zip(leaves, grads, mu, nu):
            for p, c, m, v in zip(pieces, g, ms, vs):
                m.mul_(b1).add_((1.0 - b1) * c)
                v.mul_(b2).add_((1.0 - b2) * c * c)
                p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                              + wd * p))


def gaps(program: dict, reference: dict, skip_below: float = 1e-3) -> dict:
    """The numbers compared, each the worst over steps or leaves:
    `loss1` |program − reference| / |reference| of the first step's loss;
    `grad`, `grad2` and `change` max over leaves of |‖program‖ −
    ‖reference‖| / max(‖reference‖, median leaf's ‖reference‖), of the
    first gradient, the second (on each leaf's sample: the step that
    replays the program's captured graph) and the change after the last
    step. A leaf whose reference first gradient is under `skip_below` of
    the median leaf's moves by round-off alone and is left out of
    `change`. `loss`, the worst step's loss, is read and not compared:
    from the second step on, AdamW's first updates (±lr wherever a
    gradient is not nought) carry the codec's last-bit code flips into
    the weights."""
    rel = [abs(a - b) / abs(b) for a, b in zip(program["losses"],
                                              reference["losses"])]

    def worst(key, keep):
        ref = np.asarray(reference[key])
        got = np.asarray(program[key])
        floor = max(float(np.median(ref)), 1e-30)
        gap = np.abs(got - ref) / np.maximum(ref, floor)
        gap = gap[keep]
        i = int(np.argmax(gap))
        return float(gap[i]), [n for n, k in zip(reference["leaves"], keep)
                               if k][i]

    g_ref = np.asarray(reference["first_grad"])
    every = np.ones(len(g_ref), dtype=bool)
    moved = g_ref >= skip_below * np.median(g_ref)
    grad, grad_leaf = worst("first_grad", every)
    grad2, grad2_leaf = worst("second_grad", every)
    change, change_leaf = worst("change", moved)
    return {"loss1": rel[0], "grad": grad, "grad2": grad2, "change": change,
            "loss": max(rel), "grad_leaf": grad_leaf,
            "grad2_leaf": grad2_leaf, "change_leaf": change_leaf,
            "left_out": [n for n, k in zip(reference["leaves"], moved)
                         if not k]}

"""The steps of `bench.reference.train.run` for any model's loss, at one
worker.

`run` follows the first steps from the seed's initial weights with the
loss it is given (`bench.reference.layer_types.loss`, or
`bench.reference.model.loss`), and reads what `train.gaps` compares, as
`train.run` reads it: the losses, each leaf's first gradient as the
optimizer receives it, the second step's on each leaf's sample, and
each leaf's change after the last step. The weights are held a layer
and an expert at a time (`train._held`); the codec, clipping and the
optimizer are `train`'s.
"""
from __future__ import annotations

import torch

from bench import weights
from bench.reference import codec, model
from bench.reference import train as one


def run(cfg: dict, traffic: dict, seed: int, batches, device, loss,
        matmul=model._f32_matmul) -> dict:
    """Readings of len(batches) steps from the seed's initial weights,
    with `loss(cfg, params, tokens, matmul)`."""
    train = cfg["training"]
    params, leaves = one._held(cfg, seed, device)
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
    read = mu if adam else leaves
    losses, first_grad, second_grad, before = [], None, None, None
    for step, tokens in enumerate(batches, start=1):
        for p in every:
            p.requires_grad_(True)
        value = loss(cfg, params, tokens, matmul)
        flat = list(torch.autograd.grad(value, every))
        value = value.detach()
        losses.append(float(value))
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
                one._consensus(g, ef[i] if ef is not None else None,
                               signs[i], traffic)
        if train.get("clip_norm"):
            total = torch.sqrt(sum(torch.sum(c * c) for g in grads
                                   for c in g))
            scale = torch.clamp(train["clip_norm"]
                                / torch.clamp_min(total, 1e-12), max=1.0)
            for g in grads:
                for c in g:
                    c.mul_(scale)
        if step == 2:
            before = [one.sample(r) for r in read]
        one._update(train, step, leaves, grads, mu, nu)
        del grads
        if step == 1 and adam:
            first_grad = [one._norm(m) / (1.0 - train["b1"]) for m in mu]
        elif step == 1:
            first_grad = [one._change(cfg, seed, i, p, device) / train["lr"]
                          for i, p in enumerate(leaves)]
        if step == 2:
            second_grad = [one.second(one.sample(r), b, train)
                           for r, b in zip(read, before)]
            del before
    change = [one._change(cfg, seed, i, p, device)
              for i, p in enumerate(leaves)]
    return {"losses": losses, "first_grad": first_grad,
            "second_grad": second_grad, "change": change,
            "leaves": weights.leaf_names(cfg)}

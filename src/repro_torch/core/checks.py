"""Small problems that run each of the paper's algorithms (`core.optim`)
and the democratic embedding on a device: the cases the captured step
programs are held against `repro_torch.graph.eager()` with, on the CPU
(tests/test_torch_core_programs.py) and on the card
(tests/test_torch_cuda.py).

The data are drawn with numpy from a seed on the host and copied to the
device, and the Haar frame is made on the CPU (QR differs between LAPACK
and cuSOLVER), so both devices run the same inputs. `run(case, dev)`
returns the `Trace`; `democratic_case(kind, dev)` a frame and its inputs;
`recorded_programs()` lists the `graph.Program`s a block makes (their
specializations and capture seconds), for the tests and chip_smoke.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch import graph
from repro_torch import random as rnd
from repro_torch.core import baselines as B
from repro_torch.core import coding as C
from repro_torch.core import embeddings as E
from repro_torch.core import frames as F
from repro_torch.core import optim as O

N, ROWS, WORKERS, STEPS = 20, 40, 4, 12
# case -> (algorithm, its variant); every algorithm of core.optim, each
# frame kind, the sub-linear and dithered codecs and the baselines
CASES = {
    "gd": ("gd", None),
    "dqgd_schedule": ("dqgd_schedule", None),
    "dqgd_naive": ("dqgd", "naive"),
    "dgd_def_nde_hadamard": ("dgd_def", "nde_hadamard"),
    "dgd_def_de_haar": ("dgd_def", "de_haar"),
    "dgd_def_sublinear_hadamard": ("dgd_def", "sublinear"),
    "dq_psgd_ndsc_haar": ("dq_psgd", "ndsc_haar"),
    "dq_psgd_rand50_1b": ("dq_psgd", "randk"),
    "dq_psgd_projected": ("dq_psgd", "projected"),
    "dq_psgd_multiworker_dsc_haar": ("dq_psgd_multiworker", "dsc_haar"),
    "dq_psgd_multiworker_ndsc_hadamard": ("dq_psgd_multiworker",
                                          "ndsc_hadamard"),
    "dq_psgd_multiworker_dither": ("dq_psgd_multiworker", "dither"),
}


def _problem(seed: int = 0) -> dict:
    """Least squares A x = A x* (A cubed Gaussian, ROWS × N), on the host."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((ROWS, N)) ** 3 / np.sqrt(ROWS)).astype(
        np.float32)
    x_star = rng.standard_normal(N).astype(np.float32)
    eigs = np.linalg.eigvalsh(a.T.astype(np.float64) @ a)
    return {"a": a, "x_star": x_star, "L": float(eigs[-1]),
            "mu": max(float(eigs[0]), 1e-6)}


def _codec(frame, bits: float, **kw) -> C.Codec:
    emb = E.EmbeddingSpec(kind=kw.pop("embedding", "near_democratic"))
    return C.Codec(frame, C.CodecConfig(bits_per_dim=bits, embedding=emb,
                                        **kw))


def _haar(dev) -> F.DenseFrame:
    return F.DenseFrame(S=F.haar_frame(rnd.key(2), N, N).S.to(dev))


def run(case: str, dev, steps: int = STEPS) -> O.Trace:
    """The case's algorithm for `steps` steps on dev."""
    algorithm, variant = CASES[case]
    p = _problem()
    a = torch.from_numpy(p["a"]).to(dev)
    x_star = torch.from_numpy(p["x_star"]).to(dev)
    x0 = torch.zeros(N, device=dev)
    key = rnd.key(1, device=dev)
    hadamard = F.hadamard_frame(rnd.key(0, device=dev), N, 32)
    if algorithm in ("gd", "dqgd_schedule", "dqgd", "dgd_def"):
        h, atb = a.T @ a, a.T @ (a @ x_star)
        grad = lambda x: h @ x - atb                            # noqa: E731
        alpha = O.alpha_star(p["L"], p["mu"])
        if algorithm == "gd":
            return O.gd(grad, x0, alpha, steps, x_star=x_star)
        if algorithm == "dqgd_schedule":
            d_range = 1.5 * float(np.linalg.norm(p["x_star"]))
            return O.dqgd_schedule(grad, x0, 4, alpha, steps, p["L"],
                                   p["mu"], d_range, N, x_star=x_star)
        if algorithm == "dqgd":
            return O.dqgd(grad, x0, B.naive_uniform(4).roundtrip, alpha,
                          steps, key=key, x_star=x_star)
        codec = {"nde_hadamard": lambda: _codec(hadamard, 2.0),
                 "de_haar": lambda: _codec(_haar(dev), 2.0,
                                           embedding="democratic"),
                 "sublinear": lambda: _codec(hadamard, 0.5)}[variant]()
        return O.dgd_def(grad, x0, codec, alpha, steps, key=key,
                         x_star=x_star)
    if algorithm == "dq_psgd":
        b = torch.sign(a @ x_star)

        def subgrad(k, x):                                  # SVM hinge loss
            idx = rnd.randint(k, (8,), 0, ROWS).long()
            ai, bi = a[idx], b[idx]
            g = -(bi[:, None] * ai) * ((bi * (ai @ x)) < 1.0)[:, None]
            return torch.mean(g, dim=0)

        kw = {"ndsc_haar": {"codec": _codec(_haar(dev), 1.0, dithered=True)},
              "randk": {"compressor_roundtrip": B.randk(
                  0.5, quant_levels=2, unbiased=True).roundtrip},
              "projected": {"project": lambda x: torch.clamp(x, -0.5, 0.5)},
              }[variant]
        return O.dq_psgd(subgrad, x0, kw.pop("codec", None), 0.05, steps,
                         key=key, **kw)
    s = ROWS // WORKERS
    a_w = a.reshape(WORKERS, s, N)
    b_w = (a @ x_star).reshape(WORKERS, s)

    def subgrad_w(ids, keys, x):                         # per-worker LS
        idx = rnd.randint(keys, (WORKERS, 3), 0, s).long()
        ai, bi = a_w[ids[:, None], idx], b_w[ids[:, None], idx]
        return torch.mean((ai @ x - bi)[..., None] * ai, dim=1)

    codec, roundtrip = {
        "dsc_haar": (_codec(_haar(dev), 1.0, dithered=True,
                            embedding="democratic"), None),
        "ndsc_hadamard": (_codec(hadamard, 0.5, dithered=True), None),
        "dither": (None, B.standard_dither(4).roundtrip)}[variant]
    return O.dq_psgd_multiworker(subgrad_w, WORKERS, x0, codec, 0.1, steps,
                                 key=key, compressor_roundtrip=roundtrip)


def democratic_case(kind: str, dev, n: int = N) -> tuple:
    """(frame, y (3, n)): a Hadamard (N 32) or a Haar (N n) frame."""
    frame = (F.hadamard_frame(rnd.key(4, device=dev), n, 32)
             if kind == "hadamard" else
             F.DenseFrame(S=F.haar_frame(rnd.key(5), n, n).S.to(dev)))
    y = np.random.default_rng(n).standard_normal((3, n)) ** 3
    return frame, torch.from_numpy(y.astype(np.float32)).to(dev)


@contextlib.contextmanager
def recorded_programs():
    """Every graph.Program made inside the block, in a list."""
    made, base = [], graph.Program

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    graph.Program = Recorded
    try:
        yield made
    finally:
        graph.Program = base

"""Synthetic data (port of `repro.data.pipeline`): the LM token stream, the
vision and audio frontends' stand-in batches, and the convex problems of
the paper's §5.

The token stream is order-1 Markov sequences over a fixed low-rank random
transition table: learnable structure with no I/O. A batch is a pure
function of (seed, step). Everything here draws from seeded
`torch.Generator`s on the caller's device.

The draws are NOT bitwise equal to the JAX package's (which uses
`jax.random`), and a generator on the card draws another stream than one on
the CPU; the distributions are the same. Tests that compare the two
packages feed both the same numpy arrays.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

_RANK = 32


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int                 # tokens per example INCLUDING the shift target
    batch_size: int              # global batch
    seed: int = 0
    markov_temperature: float = 0.3
    device: object = None        # `cuda` unless the caller asks for the CPU

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _table(self):
        """Low-rank logits table factors (V, r), (r, V): row t of the
        transition logits is a[t] @ b / √r, made only for the rows needed."""
        gen = _generator(self.seed, self.device)
        a = torch.randn(self.vocab_size, _RANK, generator=gen,
                        device=self.device)
        b = torch.randn(_RANK, self.vocab_size, generator=gen,
                        device=self.device)
        return a, b / (_RANK ** 0.5 * self.markov_temperature)

    def batch(self, step: int) -> dict:
        """Global batch at `step`: {"tokens": (B, seq_len+1) int32}."""
        a, b = self._table()
        gen = _generator((self.seed * 1_000_003 + step + 1) % 2 ** 63,
                         self.device)
        tok = torch.randint(0, self.vocab_size, (self.batch_size,),
                            generator=gen, device=self.device)
        out = [tok]
        for _ in range(self.seq_len):
            probs = torch.softmax(a[tok] @ b, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            out.append(tok)
        return {"tokens": torch.stack(out, dim=1).to(torch.int32)}


def batch_for_shape(cfg, batch_size: int, seq_len: int, step: int = 0,
                    seed: int = 0, device=None) -> dict:
    """A real batch matching `configs.input_specs`' layouts, on `device`
    (`cuda` unless asked for the CPU): {"tokens": (B, seq_len + 1) int32}
    for a text model; the audio frontend's {"embeds": (B, seq_len, d) f32
    N(0, 0.02²), "targets": (B, seq_len) int32}; the vision frontend's
    {"image_embeds": (B, num_patches, d) f32 N(0, 0.02²), "tokens": (B,
    seq_len − num_patches + 1) int32}. A pure function of (seed, step)."""
    device = resolve_device(device)
    if cfg.frontend is None:
        return TokenStream(cfg.vocab_size, seq_len, batch_size, seed,
                           device=device).batch(step)
    gen = _generator((seed * 1_000_003 + step) % 2 ** 63, device)
    if cfg.frontend == "audio":
        embeds = torch.randn(batch_size, seq_len, cfg.d_model,
                             generator=gen, device=device) * 0.02
        return {"embeds": embeds,
                "targets": torch.randint(
                    0, cfg.vocab_size, (batch_size, seq_len), generator=gen,
                    device=device).to(torch.int32)}
    if cfg.frontend == "vision":
        text_len = seq_len - cfg.num_patches
        image = torch.randn(batch_size, cfg.num_patches, cfg.d_model,
                            generator=gen, device=device) * 0.02
        return {"image_embeds": image,
                "tokens": torch.randint(
                    0, cfg.vocab_size, (batch_size, text_len + 1),
                    generator=gen, device=device).to(torch.int32)}
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


# ---------------------------------------------------------------------------
# Convex-experiment data (paper §5 protocols)
# ---------------------------------------------------------------------------
def synthetic_regression(seed: int, n_samples: int, dim: int,
                         design: str = "gauss3", model: str = "student_t",
                         device=None):
    """b = A x* with heavy-tailed A and/or x* (paper Fig. 3a / Figs. 5–6):
    A Gaussian (cubed for design 'gauss3'); x* Student-t(1) (a Cauchy
    draw), Gaussian cubed, or Gaussian. Returns (A, b, x*) on `device`
    (`cuda` unless asked for the CPU)."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    a = torch.randn(n_samples, dim, generator=gen, device=device)
    if design == "gauss3":
        a = a ** 3
    if model == "student_t":
        x_star = torch.empty(dim, device=device).cauchy_(generator=gen)
    elif model == "gauss3":
        x_star = torch.randn(dim, generator=gen, device=device) ** 3
    else:
        x_star = torch.randn(dim, generator=gen, device=device)
    return a, a @ x_star, x_star


def synthetic_two_class(seed: int, n_per_class: int, dim: int,
                        separation: float = 2.0, device=None):
    """Two Gaussian clouds at ±separation/√dim·1, labels ±1 (paper Fig.
    2a–b SVM protocol). Returns (x (2·n_per_class, dim), y) on `device`
    (`cuda` unless asked for the CPU)."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    mu = torch.full((dim,), separation, device=device) / torch.sqrt(
        torch.tensor(float(dim), device=device))
    xa = torch.randn(n_per_class, dim, generator=gen, device=device) + mu
    xb = torch.randn(n_per_class, dim, generator=gen, device=device) - mu
    y = torch.cat([torch.ones(n_per_class, device=device),
                   -torch.ones(n_per_class, device=device)])
    return torch.cat([xa, xb]), y

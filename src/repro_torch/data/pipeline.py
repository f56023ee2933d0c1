"""Synthetic, deterministic LM token stream (port of `repro.data.pipeline`).

Order-1 Markov sequences over a fixed low-rank random transition table:
learnable structure with no I/O. A batch is a pure function of
(seed, step), drawn from seeded `torch.Generator`s on the caller's device.

The draws are NOT bitwise equal to the JAX package's (which uses
`jax.random`); the distribution is the same. Tests that compare the two
packages feed both the same numpy tokens.
"""
from __future__ import annotations

import dataclasses

import torch

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
    device: str = "cpu"

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
                    seed: int = 0, device="cpu") -> dict:
    """A real batch for a text model: {"tokens": (B, seq_len + 1) int32}."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} batches are not ported yet")
    return TokenStream(cfg.vocab_size, seq_len, batch_size, seed,
                       device=str(device)).batch(step)

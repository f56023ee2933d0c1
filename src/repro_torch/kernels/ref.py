"""Plain PyTorch versions of the codec and optimizer kernels (the
oracles).

These define the semantics the CUDA kernels in `repro_torch/csrc/` must
meet, and they are what `kernels.ops` runs on a CPU tensor. Each op repeats
`repro.kernels.ref` step by step, each step rounded on its own, so on the
CPU the integer payloads, scales, FWHT and dequantized values are bitwise
equal to the eager JAX reference.

Two PyTorch habits would break that and are avoided here: a float tensor
divided by a Python scalar may run as a multiply by the reciprocal on CUDA
(so divisors are tensors on the operand's device, see `_div`), and torch
has no full uint32 arithmetic (so packing runs in int64 and wraps to int32
explicitly).

The optimizer's ops (`sum_squares`, `adamw_update`, `sgd_update`) are the
global norm's sum and the update rules of `repro_torch.optimizer.optim`
as its tree maps ran them, one leaf at a time and operator for operator,
so they give those maps' bits.
"""
from __future__ import annotations

import math

import torch

BITS = (1, 2, 4, 8)
TINY = torch.finfo(torch.float32).tiny      # jnp.finfo(float32).tiny


def _check_bits(bits: int) -> None:
    if bits not in BITS:
        raise ValueError(f"bits must be in {{1,2,4,8}}, got {bits}")


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded (d as a tensor on x's device, never a
    host scalar that CUDA would turn into a reciprocal multiply; filled
    there, not copied from the host, so a captured program can hold it)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 → int32 with two's-complement wrap."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh–Hadamard transform along the last axis:
    radix-2 butterflies pairing i with i+h for h = 1, 2, 4, …, then one
    multiply by f32(1/√N). N must be a power of 2."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length {n} is not a power of 2")
    orig_shape = x.shape
    y = x.reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2).reshape(-1, n)
        h *= 2
    scale = torch.tensor(1.0 / math.sqrt(n), dtype=x.dtype, device=x.device)
    return (y * scale).reshape(orig_shape)


def quantize_pack(x: torch.Tensor, scale: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Uniform R-bit quantize against `scale` + pack code j at bit j·R of
    int32 words: (..., N) → (..., N·R/32)."""
    _check_bits(bits)
    k = 32 // bits
    n = x.shape[-1]
    if n % k:
        raise ValueError(f"N={n} not divisible by packing factor {k}")
    m = 2 ** bits
    normalized = x / torch.clamp_min(scale, TINY)
    idx = torch.floor(_div(torch.clamp(normalized, -1.0, 1.0) + 1.0, 2.0 / m))
    idx = torch.clamp(idx, 0, m - 1).to(torch.int64)
    grouped = idx.reshape(x.shape[:-1] + (n // k, k))
    shifts = torch.arange(k, dtype=torch.int64, device=x.device) * bits
    return to_int32(torch.sum(grouped << shifts, dim=-1))


def unpack_dequant(words: torch.Tensor, scale: torch.Tensor, bits: int,
                   n: int) -> torch.Tensor:
    """Inverse of quantize_pack: int32 words → (−1+(2·idx+1)/2^R)·scale,
    trimmed to n values per row."""
    _check_bits(bits)
    k = 32 // bits
    m = 2 ** bits
    w = (words.to(torch.int64) & 0xFFFFFFFF)[..., None]
    shifts = torch.arange(k, dtype=torch.int64, device=words.device) * bits
    idx = (w >> shifts) & (m - 1)
    idx = idx.reshape(words.shape[:-1] + (words.shape[-1] * k,))[..., :n]
    values = -1.0 + _div(2.0 * idx.to(torch.float32) + 1.0, float(m))
    return values * scale


def encode(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
           dither: torch.Tensor | None = None,
           mask: torch.Tensor | None = None) -> tuple:
    """sign-flip → FWHT → ℓ∞ scale → (dither·scale) → quantize+pack →
    (mask). Returns (words int32 (..., N·R/32), scale f32 (..., 1))."""
    embedded = fwht(chunks * signs)
    scale = torch.amax(torch.abs(embedded), dim=-1, keepdim=True)
    if dither is not None:
        embedded = embedded + dither * scale
    words = quantize_pack(embedded, scale, bits)
    if mask is not None:
        words = words * mask.to(words.dtype)
        scale = scale * mask
    return words, scale


def decode_embedded(words: torch.Tensor, scale: torch.Tensor,
                    signs: torch.Tensor, bits: int, n: int, *,
                    mask: torch.Tensor | None = None,
                    rescale: float | None = None) -> torch.Tensor:
    """unpack+dequant → (mask, /rescale) → FWHT → sign-flip."""
    x_hat = unpack_dequant(words, scale, bits, n)
    if mask is not None:
        x_hat = x_hat * mask
        if rescale is not None:
            x_hat = _div(x_hat, rescale)
    return fwht(x_hat) * signs.to(x_hat.dtype)


def encode_ef(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
              dither: torch.Tensor | None = None,
              mask: torch.Tensor | None = None,
              rescale: float | None = None,
              residual_dtype=torch.float32) -> tuple:
    """`encode` plus the error-feedback residual u − D(E(u)), the decode
    rounded through `residual_dtype`. Returns (words, scale, residual f32)."""
    words, scale = encode(chunks, signs, bits, dither=dither, mask=mask)
    y_hat = decode_embedded(words, scale, signs, bits, chunks.shape[-1],
                            mask=mask, rescale=rescale)
    y_hat = y_hat.to(residual_dtype).to(torch.float32)
    return words, scale, chunks.to(torch.float32) - y_hat


def quant_decode_attention(q: torch.Tensor, kw: torch.Tensor,
                           ks: torch.Tensor, vw: torch.Tensor,
                           vs: torch.Tensor, kv_len: torch.Tensor, *,
                           bits: int, inv_rotate_v: bool = True
                           ) -> torch.Tensor:
    """Exact softmax attention over the NDSC-packed, rotated KV cache,
    inverse-rotating V at the end.

    q: (B,K,G,dh) f32 (pre-scaled, rotated); kw/vw: (B,C,K,dh·R/32);
    ks/vs: (B,C,K); kv_len: (B,). Returns (B,K,G,dh)."""
    c = kw.shape[1]
    dh = q.shape[-1]
    kd = unpack_dequant(kw, ks[..., None], bits, dh)      # (B,C,K,dh)
    vd = unpack_dequant(vw, vs[..., None], bits, dh)
    s = torch.einsum("bkgd,bckd->bkgc", q, kd)
    pos = torch.arange(c, dtype=torch.int32, device=q.device)
    valid = (pos[None, :] < kv_len[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, vd)
    return fwht(out) if inv_rotate_v else out


def _clipped(g: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """g × the clip scale, rounded to g's dtype (`clip_by_global_norm`'s
    map); g itself without a scale."""
    return g if scale is None else (g * scale).to(g.dtype)


def sum_squares(leaves) -> torch.Tensor:
    """Σ x² over every value of `leaves`, in f32: each leaf's sum, added
    leaf after leaf (the global norm's square)."""
    total = 0
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return total


def adamw_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 p: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                 c2: torch.Tensor, scale: torch.Tensor | None = None, *,
                 b1: float, b2: float, eps: float,
                 weight_decay: float) -> tuple:
    """One AdamW step over a leaf (the moments first, then the update with
    decoupled weight decay; c1, c2 the bias corrections): (u in p's dtype,
    mu', nu')."""
    g = _clipped(g, scale)
    m = b1 * mu + (1 - b1) * g.float()
    v = b2 * nu + (1 - b2) * torch.square(g.float())
    m_hat, v_hat = m / c1, v / c2
    u = -lr * (m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p.float())
    return u.to(p.dtype), m, v


def sgd_update(g: torch.Tensor, vel: torch.Tensor | None, p: torch.Tensor,
               lr: torch.Tensor, scale: torch.Tensor | None = None, *,
               momentum: float, nesterov: bool) -> tuple:
    """One SGD step over a leaf, plain, with momentum or Nesterov's: (u in
    p's dtype, vel' or None without momentum)."""
    g = _clipped(g, scale)
    if not momentum:
        return (-lr * g.float()).to(p.dtype), None
    v = momentum * vel + g.float()
    if nesterov:
        return (-lr * (momentum * v + g.float())).to(p.dtype), v
    return (-lr * v).to(p.dtype), v

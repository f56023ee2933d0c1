"""Selective state-space (Mamba-style) block (port of `repro.models.ssm`).

State update (per channel c, state dim n):
    h_t = exp(Δ_t A) ⊙ h_{t−1} + (Δ_t x_t) B_tᵀ ,   y_t = h_t C_t + D x_t
with input-dependent Δ, B, C (selective scan). Two execution modes, as in
the reference:
  * `mamba_scan`       — sequential over time (the reference's `lax.scan`
                         is a Python loop here: a few eager ops per token);
  * `mamba_assoc_scan` — a log-depth scan over time (Hillis–Steele
                         doubling; the reference's `lax.associative_scan`
                         composes the same pairs in another tree, so the
                         two agree to rounding, not bitwise).
Δ is `softplus` as the reference computes it, logaddexp(x, 0).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import softplus


class MambaParams(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*di) → x, z
    w_bc: torch.Tensor       # (di, 2n) → B, C
    w_dt: torch.Tensor       # (di, dt_rank)
    w_dt_up: torch.Tensor    # (dt_rank, di)
    dt_bias: torch.Tensor    # (di,)
    a_log: torch.Tensor      # (di, n)
    d_skip: torch.Tensor     # (di,)
    out_proj: torch.Tensor   # (di, d)


def mamba_shapes(d: int, di: int, n: int) -> MambaParams:
    """The leaf shapes of `init_mamba` in the reference."""
    dt_rank = max(1, d // 16)
    return MambaParams(in_proj=(d, 2 * di), w_bc=(di, 2 * n),
                       w_dt=(di, dt_rank), w_dt_up=(dt_rank, di),
                       dt_bias=(di,), a_log=(di, n), d_skip=(di,),
                       out_proj=(di, d))


def _inputs(p: MambaParams, x: torch.Tensor):
    di = p.out_proj.shape[0]
    n = p.a_log.shape[-1]
    xz = x @ p.in_proj
    x_in, z = xz[..., :di], xz[..., di:]
    bc = x_in @ p.w_bc                                      # (B, S, 2n)
    b_t, c_t = bc[..., :n], bc[..., n:]
    dt = softplus((x_in @ p.w_dt) @ p.w_dt_up + p.dt_bias)  # (B, S, di)
    a = -torch.exp(p.a_log.to(torch.float32))               # (di, n)
    return x_in, z, b_t, c_t, dt, a


def _finish(p: MambaParams, y, x_in, z):
    y = y + p.d_skip * x_in
    return (y * F.silu(z)) @ p.out_proj


def _step(h, a, x_t, b_t, c_t, dt_t, dtype):
    da = torch.exp(dt_t[..., None].to(torch.float32) * a)     # (B, di, n)
    h = da * h + (dt_t * x_t)[..., None].to(torch.float32) * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t.to(torch.float32))
    return h, y.to(dtype)


def mamba_scan(p: MambaParams, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """x: (B, S, d) → (y: (B, S, d), h_final: (B, di, n))."""
    bsz, s, _ = x.shape
    di, n = p.a_log.shape
    x_in, z, b_t, c_t, dt, a = _inputs(p, x)
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(s):
        h, y = _step(h, a, x_in[:, t], b_t[:, t], c_t[:, t], dt[:, t],
                     x.dtype)
        ys.append(y)
    y = torch.stack(ys, dim=1)                                 # (B, S, di)
    return _finish(p, y, x_in, z), h


def mamba_assoc_scan(p: MambaParams, x: torch.Tensor,
                     h0: Optional[torch.Tensor] = None):
    """Log-depth variant: h_t = a_t h_{t−1} + u_t composed by doubling."""
    s = x.shape[1]
    x_in, z, b_t, c_t, dt, a = _inputs(p, x)
    da = torch.exp(dt[..., None].to(torch.float32) * a)       # (B,S,di,n)
    u = (dt * x_in)[..., None].to(torch.float32) * b_t[:, :, None, :]
    if h0 is not None:
        u = torch.cat([u[:, :1] + da[:, :1] * h0[:, None], u[:, 1:]], dim=1)
    off = 1
    while off < s:
        # combine(left, right) = (a1 a2, a2 u1 + u2), left the earlier span
        a_l, u_l = da[:, :-off], u[:, :-off]
        a_r, u_r = da[:, off:], u[:, off:]
        da = torch.cat([da[:, :off], a_l * a_r], dim=1)
        u = torch.cat([u[:, :off], a_r * u_l + u_r], dim=1)
        off *= 2
    y = torch.einsum("bsdn,bsn->bsd", u,
                     c_t.to(torch.float32)).to(x.dtype)
    return _finish(p, y, x_in, z), u[:, -1]


def mamba_decode_step(p: MambaParams, x: torch.Tensor, h: torch.Tensor):
    """x: (B, 1, d), h: (B, di, n) → (y: (B, 1, d), h')."""
    x_in, z, b_t, c_t, dt, a = _inputs(p, x)
    h, y = _step(h, a, x_in[:, 0], b_t[:, 0], c_t[:, 0], dt[:, 0], x.dtype)
    return _finish(p, y[:, None, :], x_in, z), h

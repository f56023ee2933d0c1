"""xLSTM blocks (port of `repro.models.xlstm`): mLSTM (matrix memory) and
sLSTM (scalar memory) [arXiv:2405.04517].

mLSTM recurrence (per head, exponential gating with stabilizer m):
    m_t = max(f̃_t + m_{t−1}, ĩ_t)
    i'  = exp(ĩ_t − m_t),  f' = exp(f̃_t + m_{t−1} − m_t)
    C_t = f'·C_{t−1} + i'·v_t k_tᵀ ,  n_t = f'·n_{t−1} + i'·k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1) ,  out = σ(o_t) ⊙ h_t

sLSTM keeps a scalar-memory cell per hidden unit with a per-head recurrent
matrix R. The reference's `lax.scan`s over time are Python loops here, one
step's ops per token; `log_sigmoid` is the reference's −logaddexp(−x, 0)
and the stabilizer starts at −1e30. The scanned unit of `xlstm_pair` is an
(mLSTM, sLSTM) pair.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import log_sigmoid


class MLSTMParams(NamedTuple):
    wq: torch.Tensor   # (d, H*dh)
    wk: torch.Tensor
    wv: torch.Tensor
    wi: torch.Tensor   # (d, H) input-gate pre-activation
    wf: torch.Tensor   # (d, H) forget-gate pre-activation
    wo: torch.Tensor   # (d, d) output gate
    w_out: torch.Tensor  # (H*dh, d)


class SLSTMParams(NamedTuple):
    w_in: torch.Tensor   # (d, 4*d) — i, f, z, o pre-activations from input
    r_rec: torch.Tensor  # (H, dh, 4*dh) — per-head recurrent weights
    w_out: torch.Tensor  # (d, d)


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh, dh)
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)


def mlstm_shapes(d: int, heads: int) -> MLSTMParams:
    return MLSTMParams(wq=(d, d), wk=(d, d), wv=(d, d), wi=(d, heads),
                       wf=(d, heads), wo=(d, d), w_out=(d, d))


def slstm_shapes(d: int, heads: int) -> SLSTMParams:
    dh = d // heads
    return SLSTMParams(w_in=(d, 4 * d), r_rec=(heads, dh, 4 * dh),
                       w_out=(d, d))


def mlstm_zero_state(bsz: int, heads: int, dh: int,
                     device=None) -> MLSTMState:
    f32 = torch.float32
    return MLSTMState(
        torch.zeros((bsz, heads, dh, dh), dtype=f32, device=device),
        torch.zeros((bsz, heads, dh), dtype=f32, device=device),
        torch.full((bsz, heads), -1e30, dtype=f32, device=device))


def slstm_zero_state(bsz: int, d: int, device=None) -> SLSTMState:
    z = torch.zeros((bsz, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z)


def _mlstm_step(q, k, v, i_pre, f_pre, state: MLSTMState):
    c, n, m = state                          # q, k, v (B,H,dh); gates (B,H)
    f_log = log_sigmoid(f_pre.to(torch.float32))
    i_log = i_pre.to(torch.float32)
    m_new = torch.maximum(f_log + m, i_log)
    i_g = torch.exp(i_log - m_new)[..., None]                 # (B,H,1)
    f_g = torch.exp(f_log + m - m_new)[..., None]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    c = f_g[..., None] * c + i_g[..., None] * vf[..., :, None] \
        * kf[..., None, :]
    n = f_g * n + i_g * kf
    qf = q.to(torch.float32)
    num = torch.einsum("bhvk,bhk->bhv", c, qf)
    den = torch.clamp_min(
        torch.abs(torch.einsum("bhk,bhk->bh", n, qf)), 1.0)
    return MLSTMState(c, n, m_new), num / den[..., None]      # h (B,H,dh)


def mlstm_block(p: MLSTMParams, x: torch.Tensor, heads: int,
                state: Optional[MLSTMState] = None):
    """x: (B, S, d) → (y: (B, S, d), final state)."""
    bsz, s, _ = x.shape
    dh = p.wq.shape[-1] // heads
    if state is None:
        state = mlstm_zero_state(bsz, heads, dh, x.device)
    q = (x @ p.wq).reshape(bsz, s, heads, dh)
    k = (x @ p.wk).reshape(bsz, s, heads, dh) * dh ** -0.5
    v = (x @ p.wv).reshape(bsz, s, heads, dh)
    i_pre = (x @ p.wi).reshape(bsz, s, heads)
    f_pre = (x @ p.wf).reshape(bsz, s, heads)
    o_gate = torch.sigmoid(x @ p.wo)                          # (B, S, d)
    hs = []
    for t in range(s):
        state, h = _mlstm_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                               f_pre[:, t], state)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(bsz, s, heads * dh).to(x.dtype)
    return o_gate * (h @ p.w_out), state


def mlstm_decode_step(p: MLSTMParams, x: torch.Tensor, heads: int,
                      state: MLSTMState):
    """x: (B, 1, d) → (y: (B, 1, d), state')."""
    return mlstm_block(p, x, heads, state)


def slstm_block(p: SLSTMParams, x: torch.Tensor, heads: int,
                state: Optional[SLSTMState] = None):
    """x: (B, S, d) → (y, final state). Gates see h_{t−1} via per-head R."""
    bsz, s, d = x.shape
    dh = d // heads
    if state is None:
        state = slstm_zero_state(bsz, d, x.device)
    pre_in = x @ p.w_in                                       # (B, S, 4d)
    r_rec = p.r_rec.to(torch.float32)
    c, n, h = state
    hs = []
    for t in range(s):
        rec = torch.einsum("bhk,hkj->bhj", h.reshape(bsz, heads, dh),
                           r_rec).reshape(bsz, 4 * d)
        pre = pre_in[:, t].to(torch.float32) + rec
        i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)
        i_g = torch.exp(torch.clamp_max(i_pre, 10.0))   # exp gating, clamped
        f_g = torch.sigmoid(f_pre)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * c / torch.clamp_min(torch.abs(n), 1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype) @ p.w_out
    return y, SLSTMState(c, n, h)


def slstm_decode_step(p: SLSTMParams, x: torch.Tensor, heads: int,
                      state: SLSTMState):
    return slstm_block(p, x, heads, state)

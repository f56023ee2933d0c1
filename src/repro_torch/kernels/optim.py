"""CUDA kernels of the optimizer phase (`csrc/optim.cu`): the global norm's
sum of squares over a list of leaves, and AdamW's and SGD's update of one
leaf with the clip folded in.

Counterparts of `ref.sum_squares`, `ref.adamw_update` and
`ref.sgd_update` (the tree maps of `optimizer.optim`, one leaf at a time).
The updates are bitwise equal to them given the same clip scale: each
PyTorch operator is one round-to-nearest intrinsic in its order, the
Python-float constants rounded to f32 as PyTorch rounds a scalar operand.
The sum of squares runs in another order than `torch.sum` (tiles of
`SUM_TILE` values, their f32 partials summed in f64), so the norm differs
from the plain one in its last bits, and is the same on every call.

lr, the bias corrections and the clip scale are 0-d f32 tensors on the
leaves' card, read by the kernels from device memory: a captured train
step replays a schedule. Leaves are f32, bf16 or f16 and contiguous
(the moments and the velocity f32); anything else raises. The outputs
and the partials' scratch are the only allocations. Each wrapper adds
one to its `launches` (`ops.launch_counts`) a call, as every wrapper of
the port does; on the device a `sum_squares` call is
ceil(leaves / MAX_LEAVES) tile kernels (one per MAX_LEAVES leaves that
hold a value) and one finishing kernel, the updates one kernel a call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fwht import _stream, call_on, f32

# values a tile of the sum of squares, and leaves a tile launch
# (csrc/optim.cu kSumTile, kMaxLeaves)
SUM_TILE = 32768
MAX_LEAVES = 64
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _sum_squares():
    return _build.library("optim").repro_sum_squares


@functools.cache
def _adamw():
    return _build.library("optim").repro_adamw_update


@functools.cache
def _sgd():
    return _build.library("optim").repro_sgd_update


def _leaf(name: str, t: torch.Tensor, device=None) -> int:
    """t's dtype code, after the checks every leaf passes."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    code = _CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return code


def _f32_leaf(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if _leaf(name, t, like.device) != 0:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")


def _scalar(name: str, t, like: torch.Tensor):
    """The device pointer of a 0-d f32 tensor on like's card (None → a
    null pointer)."""
    if t is None:
        return None
    if not (isinstance(t, torch.Tensor) and t.dim() == 0
            and t.dtype == torch.float32 and t.device == like.device):
        raise ValueError(f"{name} must be a 0-d float32 tensor on "
                         f"{like.device}")
    return t.data_ptr()


def sum_squares_cuda(leaves) -> torch.Tensor:
    """Σ x² over every value of `leaves` (f32, bf16 or f16 CUDA tensors on
    one card) as a 0-d f32 tensor."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("sum_squares needs at least one leaf")
    dev = leaves[0].device
    codes = [_leaf(f"leaf {i}", x, dev) for i, x in enumerate(leaves)]
    lens = [x.numel() for x in leaves]
    tiles = sum(-(-n // SUM_TILE) for n in lens)
    partials = torch.empty(tiles, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    k = len(leaves)
    rc = call_on(leaves[0], _sum_squares(),
                 (ctypes.c_void_p * k)(*[x.data_ptr() for x in leaves]),
                 (ctypes.c_int64 * k)(*lens), (ctypes.c_int * k)(*codes), k,
                 partials.data_ptr(), tiles, out.data_ptr(),
                 _stream(leaves[0]))
    _build.check(rc, "sum_squares")
    sum_squares_cuda.launches += 1
    return out


def adamw_update_cuda(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                      p: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                      c2: torch.Tensor, scale: torch.Tensor | None = None, *,
                      b1: float, b2: float, eps: float,
                      weight_decay: float) -> tuple:
    """One AdamW step over a leaf: (u in p's dtype, mu', nu' f32), with g
    multiplied by `scale` first where one is given."""
    g_code = _leaf("g", g)
    p_code = _leaf("p", p, g.device)
    if p.shape != g.shape:
        raise ValueError(f"p shape {tuple(p.shape)} != {tuple(g.shape)}")
    _f32_leaf("mu", mu, g)
    _f32_leaf("nu", nu, g)
    ptrs = [_scalar(n, t, g) for n, t in (("lr", lr), ("c1", c1), ("c2", c2),
                                          ("scale", scale))]
    if None in ptrs[:3]:
        raise ValueError("lr, c1 and c2 are required")
    mu2, nu2, u = (torch.empty_like(mu), torch.empty_like(nu),
                   torch.empty_like(p))
    rc = call_on(g, _adamw(), g.data_ptr(), g_code, mu.data_ptr(),
                 nu.data_ptr(), p.data_ptr(), p_code, mu2.data_ptr(),
                 nu2.data_ptr(), u.data_ptr(), g.numel(), *ptrs, f32(b1),
                 f32(1 - b1), f32(b2), f32(1 - b2), f32(eps),
                 f32(weight_decay), _stream(g))
    _build.check(rc, "adamw_update")
    adamw_update_cuda.launches += 1
    return u, mu2, nu2


def sgd_update_cuda(g: torch.Tensor, vel: torch.Tensor | None,
                    p: torch.Tensor, lr: torch.Tensor,
                    scale: torch.Tensor | None = None, *, momentum: float,
                    nesterov: bool) -> tuple:
    """One SGD step over a leaf: (u in p's dtype, vel' f32 or None
    without momentum), with g multiplied by `scale` first where one is
    given."""
    g_code = _leaf("g", g)
    p_code = _leaf("p", p, g.device)
    if p.shape != g.shape:
        raise ValueError(f"p shape {tuple(p.shape)} != {tuple(g.shape)}")
    mode = 0 if not momentum else 2 if nesterov else 1
    vel2 = None
    if mode:
        if vel is None:
            raise ValueError("SGD with momentum needs its velocity")
        _f32_leaf("vel", vel, g)
        vel2 = torch.empty_like(vel)
    lr_ptr, scale_ptr = _scalar("lr", lr, g), _scalar("scale", scale, g)
    if lr_ptr is None:
        raise ValueError("lr is required")
    u = torch.empty_like(p)
    rc = call_on(g, _sgd(), g.data_ptr(), g_code,
                 vel.data_ptr() if mode else None,
                 vel2.data_ptr() if mode else None, u.data_ptr(), p_code,
                 g.numel(), lr_ptr, scale_ptr, mode, f32(momentum or 0.0),
                 _stream(g))
    _build.check(rc, "sgd_update")
    sgd_update_cuda.launches += 1
    return u, vel2


sum_squares_cuda.launches = 0
adamw_update_cuda.launches = 0
sgd_update_cuda.launches = 0

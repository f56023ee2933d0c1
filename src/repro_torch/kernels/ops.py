"""Dispatch of the codec ops by the tensor's device.

A CPU tensor runs the plain PyTorch version (`kernels.ref`), and so does a
`meta` tensor, which has shapes and no values (the dry-run traces the
decode step on them, `repro_torch.launch.dryrun`); a CUDA tensor runs the
hand-written kernel, or raises where the kernel refuses the input
(a dtype it does not take, an N that is not a power of two). The FWHT and
the encoders take every power-of-two N on the card: one launch up to 8192,
hand-written passes above (`kernels.fwht.fwht_plan`). There is no switch
and no fallback: unlike `repro.kernels.ops`, nothing here
quietly swaps in the reference on the accelerator. All six TPU kernels have
a CUDA counterpart; each CUDA wrapper counts its launches
(`launch_counts`).

Observability (`repro_torch.obs`), with the reference's names: every
dispatch adds to the `kernels.dispatch` counter (attrs: op, path "cuda" for
the hand-written kernel or "ref" for the plain version, n, forced, always
False: there is no forcing switch) and records the call with the session's
cost capture as program `kernels.<op>.<path>`; a CUDA kernel that refuses
its input adds to `kernels.forced_error` before the error propagates.
The counter counts where the Python runs: every eager launch, and each
launch a CUDA graph capture records (`repro_torch.graph`), once, as the
reference counts once per trace; a replay dispatches nothing, though its
launches count in `launch_counts`. With obs disabled this costs one
global load per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.quantdecode import quant_decode_attention_cuda
from repro_torch.kernels.quantencode import encode_cuda, encode_ef_cuda
from repro_torch.kernels.quantpack import (quantize_pack_cuda,
                                           unpack_dequant_cuda)
from repro_torch.obs import core as obs

KERNELS = {"encode": encode_cuda, "encode_ef": encode_ef_cuda,
           "unpack_dequant": unpack_dequant_cuda, "fwht": fwht_cuda,
           "quantize_pack": quantize_pack_cuda,
           "quant_decode_attention": quant_decode_attention_cuda}


def launch_counts() -> dict:
    """Launches of each CUDA kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launches(counts: dict) -> None:
    """Add `counts` ({kernel: n}, n may be negative) to the launch counts:
    a captured graph's replay launches what its capture recorded
    (`repro_torch.graph`), though no wrapper runs."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type in ("cpu", "meta")


def _opt(t):
    return None if t is None else t.contiguous()


def _run(op: str, path: str, n: int, fn, args: tuple, kwargs=None,
         static=None):
    """fn(*args, **kwargs), observed: a refusal of the CUDA kernel counts
    `kernels.forced_error` and propagates; a call that ran counts
    `kernels.dispatch` and is captured as `kernels.<op>.<path>`."""
    kwargs = kwargs or {}
    try:
        out = fn(*args, **kwargs)
    except ValueError:
        if path == "cuda":
            obs.counter("kernels.forced_error", 1, op=op, n=int(n))
        raise
    if obs._ACTIVE is not None:
        obs.counter("kernels.dispatch", 1, op=op, path=path, n=int(n),
                    forced=False)
        obs.observe_program_call(f"kernels.{op}.{path}", fn, args, kwargs,
                                 static=static)
    return out


def _row_scale(scale: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """scale as one contiguous value per row of t, (..., 1); broadcast
    only where its lead dims differ from t's (a view costs host time on
    the serve path's small calls)."""
    if scale.shape[:-1] != t.shape[:-1]:
        scale = scale.expand(t.shape[:-1] + (1,))
    return scale.contiguous()


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh–Hadamard transform along the last axis."""
    if _on_cpu(x):
        return _run("fwht", "ref", x.shape[-1], _ref.fwht, (x,))
    return _run("fwht", "cuda", x.shape[-1], fwht_cuda, (x.contiguous(),))


def rotate(chunks: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """The frame rotation applied chunk-wise, H·(D·x): the `transform`
    stage of `repro_torch.codecs.stages`, on the FWHT kernel for a CUDA
    tensor."""
    return fwht(chunks * signs)


def unrotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Inverse of `rotate` (H orthonormal, D its own inverse): D·(H·x).
    The sign multiply runs in place on the transform's fresh output, which
    saves a stacked decode's largest temporary."""
    y = fwht(x)
    if y.dtype != torch.promote_types(y.dtype, signs.dtype):
        return y * signs
    return y.mul_(signs)


def quantize_pack(x: torch.Tensor, scale: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Uniform quantize + bit-pack to int32 words (bits ∈ {1,2,4,8})."""
    static = ("bits", bits)
    if _on_cpu(x):
        return _run("quantize_pack", "ref", x.shape[-1], _ref.quantize_pack,
                    (x, scale, bits), static=static)
    return _run("quantize_pack", "cuda", x.shape[-1], quantize_pack_cuda,
                (x.contiguous(), _row_scale(scale, x), bits), static=static)


def unpack_dequant(words: torch.Tensor, scale: torch.Tensor, bits: int,
                   n: int) -> torch.Tensor:
    """Unpack + dequantize (inverse of quantize_pack)."""
    static = ("bits", bits, "n", n)
    if _on_cpu(words):
        return _run("unpack_dequant", "ref", n, _ref.unpack_dequant,
                    (words, scale, bits, n), static=static)
    return _run("unpack_dequant", "cuda", n, unpack_dequant_cuda,
                (words.contiguous(), _row_scale(scale, words), bits, n),
                static=static)


def encode(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
           dither: torch.Tensor | None = None,
           mask: torch.Tensor | None = None) -> tuple:
    """Fused codec encode: (words, scale), bitwise equal either way."""
    static = ("bits", bits)
    if _on_cpu(chunks):
        return _run("encode", "ref", chunks.shape[-1], _ref.encode,
                    (chunks, signs, bits), {"dither": dither, "mask": mask},
                    static)
    return _run("encode", "cuda", chunks.shape[-1], encode_cuda,
                (chunks.contiguous(), signs.contiguous(), bits),
                {"dither": _opt(dither), "mask": _opt(mask)}, static)


def encode_ef(chunks: torch.Tensor, signs: torch.Tensor, bits: int, *,
              dither: torch.Tensor | None = None,
              mask: torch.Tensor | None = None,
              rescale: float | None = None,
              residual_dtype=None) -> tuple:
    """`encode` plus the error-feedback residual u − D(E(u)).
    residual_dtype=None means f32."""
    rdt = torch.float32 if residual_dtype is None else residual_dtype
    static = ("bits", bits, "rescale", rescale,
              "rdt", str(rdt).replace("torch.", ""))
    if _on_cpu(chunks):
        return _run("encode_ef", "ref", chunks.shape[-1], _ref.encode_ef,
                    (chunks, signs, bits),
                    {"dither": dither, "mask": mask, "rescale": rescale,
                     "residual_dtype": rdt}, static)
    return _run("encode_ef", "cuda", chunks.shape[-1], encode_ef_cuda,
                (chunks.contiguous(), signs.contiguous(), bits),
                {"dither": _opt(dither), "mask": _opt(mask),
                 "rescale": rescale, "residual_dtype": rdt}, static)


def quant_decode_attention(q: torch.Tensor, kw: torch.Tensor,
                           ks: torch.Tensor, vw: torch.Tensor,
                           vs: torch.Tensor, kv_len: torch.Tensor, *,
                           bits: int, inv_rotate_v: bool = True
                           ) -> torch.Tensor:
    """Softmax attention of one query step over the NDSC-packed, rotated
    KV cache, V inverse-rotated at the end. q (B,K,G,dh) f32 pre-scaled and
    rotated; kw/vw (B,C,K,dh·bits/32) int32; ks/vs (B,C,K) f32; kv_len (B,)
    int. Returns (B,K,G,dh) f32."""
    kw_ = {"bits": bits, "inv_rotate_v": inv_rotate_v}
    static = ("bits", bits, "inv_rotate_v", inv_rotate_v)
    if _on_cpu(q):
        return _run("quant_decode_attention", "ref", q.shape[-1],
                    _ref.quant_decode_attention,
                    (q, kw, ks, vw, vs, kv_len), kw_, static)
    return _run("quant_decode_attention", "cuda", q.shape[-1],
                quant_decode_attention_cuda,
                (q.contiguous(), kw.contiguous(), ks.contiguous(),
                 vw.contiguous(), vs.contiguous(),
                 kv_len.to(torch.int32).contiguous()), kw_, static)

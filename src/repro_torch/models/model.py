"""Model config and the dense decoder (port of `repro.models.model`).

`ModelConfig` is the reference's schema, field for field. The forward pass,
loss and initializer are ported for `block="attn_mlp"` (yi, llama, phi3,
mistral); the other families raise `NotImplementedError`.

Parameters keep the reference's layout: a dict tree whose block weights are
STACKED along a leading layer axis, `params["blocks"][name]` of shape
(L, …). The codec numbers leaves in sorted-key order and chunks each leaf
whole, so per-layer weights would change every payload. `Transformer`
holds such a tree as `nn.Parameter`s.

Matmuls in float32 run in full float32: TF32 is switched off by
`disable_tf32()`, which the trainer calls, because TF32 keeps about three
decimal digits and would move the gradients the codec quantizes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block: str = "attn_mlp"
    causal: bool = True
    attention_kind: str = "full"        # full | sliding
    window: int = 4096
    rope_theta: float = 500000.0
    # moe
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01
    # ssm (hybrid)
    ssm_state: int = 16
    d_inner: Optional[int] = None
    ssm_scan: str = "sequential"
    # io / frontends
    frontend: Optional[str] = None       # None | vision | audio
    num_patches: int = 1024
    norm_eps: float = 1e-5
    dtype: str = "float32"
    vocab_pad_multiple: int = 256
    remat: bool = True
    seq_parallel: bool = False
    kv_quant_bits: Optional[int] = None
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.dh

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def di(self) -> int:
        return self.d_inner or self.d_model

    @property
    def num_scanned(self) -> int:
        if self.block == "xlstm_pair":
            if self.num_layers % 2:
                raise ValueError("xlstm_pair needs an even layer count")
            return self.num_layers // 2
        return self.num_layers

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def decode_supported(self) -> bool:
        return self.block != "encoder"

    @property
    def subquadratic(self) -> bool:
        return (self.block in ("xlstm_pair",)
                or self.attention_kind == "sliding")

    def window_or_none(self) -> Optional[int]:
        return self.window if self.attention_kind == "sliding" else None

    def decode_cache_len(self, seq_len: int) -> int:
        if self.attention_kind == "sliding":
            return min(self.window, seq_len)
        return seq_len


def _require_attn_mlp(cfg: ModelConfig) -> None:
    if cfg.block != "attn_mlp" or cfg.frontend is not None:
        raise NotImplementedError(
            f"block={cfg.block!r} frontend={cfg.frontend!r} is not ported "
            "yet; only the dense text decoder (attn_mlp) is")


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, in the reference's layout."""
    _require_attn_mlp(cfg)
    n, d = cfg.num_scanned, cfg.d_model
    return {
        "blocks": {
            "attn_norm": (n, d), "wq": (n, d, cfg.q_dim),
            "wk": (n, d, cfg.kv_dim), "wv": (n, d, cfg.kv_dim),
            "wo": (n, cfg.q_dim, d), "mlp_norm": (n, d),
            "w_gate": (n, d, cfg.d_ff), "w_up": (n, d, cfg.d_ff),
            "w_down": (n, cfg.d_ff, d),
        },
        "final_norm": (d,),
        "embed": (cfg.padded_vocab, d),
        "head": (d, cfg.padded_vocab),
    }


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from a seeded generator on `device` (`cuda`
    unless asked for the CPU): norms 1, matrices N(0, 0.02²). Same
    distribution as the reference's `init_params`, not the same numbers
    (the tests carry JAX parameters over with `repro_torch.convert`)."""
    dt = cfg.compute_dtype
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=dt, device=device)
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return (w.normal_(generator=gen) * 0.02).to(dt)

    shapes = param_shapes(cfg)
    return {k: ({n: make(n, s) for n, s in v.items()} if k == "blocks"
                else make(k, v)) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------
def _attn_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.dh)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def block_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                  positions: torch.Tensor, collect_kv: bool = False):
    """One attn_mlp block on one layer's weights `p`. Returns h, or with
    `collect_kv` (prefill) the pair (h, (k, v)) of the layer's post-RoPE
    keys and values, (B, S, K, dh) each."""
    _require_attn_mlp(cfg)
    b, s, _ = h.shape
    x = L.rmsnorm(h, p["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, p, x, positions)
    o = L.blockwise_attention(q, k, v, causal=cfg.causal,
                              window=cfg.window_or_none())
    h = h + o.reshape(b, s, cfg.q_dim) @ p["wo"]
    x = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
    h = h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return (h, (k, v)) if collect_kv else h


_BLOCK_KEYS = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk",
               "wo", "wq", "wv")


def layer_params(params: dict, i: int) -> dict:
    """Layer i's block weights, views into the stacked (L, …) leaves."""
    return {k: params["blocks"][k][i] for k in _BLOCK_KEYS}


def forward_hidden(cfg: ModelConfig, params: dict, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Run the block stack over the stacked layer weights; with `remat`,
    each layer is recomputed in the backward pass (torch.utils.checkpoint,
    the counterpart of the reference's jax.checkpoint)."""
    blocks = params["blocks"]

    def layer(hh, *weights):
        return block_forward(cfg, dict(zip(_BLOCK_KEYS, weights)), hh,
                             positions)

    for i in range(cfg.num_scanned):
        weights = [blocks[k][i] for k in _BLOCK_KEYS]
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(layer, h, *weights, use_reentrant=False)
        else:
            h = layer(h, *weights)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    _require_attn_mlp(cfg)
    toks = batch["tokens"]
    tok_in, targets = toks[:, :-1], toks[:, 1:]
    h = L.embed(tok_in, params["embed"]).to(cfg.compute_dtype)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    return h, positions, targets


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy (attn_mlp has no auxiliary loss)."""
    h, positions, targets = _embed_inputs(cfg, params, batch)
    h = forward_hidden(cfg, params, h, positions)
    return L.chunked_softmax_xent(h, params["head"], targets)


class Transformer(nn.Module):
    """The attn_mlp decoder as an nn.Module over a parameter tree in the
    reference's layout (stacked block weights); `params()` returns that
    tree of its Parameters, `forward(batch)` the loss."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        _require_attn_mlp(cfg)
        self.cfg = cfg
        self.blocks = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params["blocks"].items()})
        self.final_norm = nn.Parameter(params["final_norm"])
        self.embed = nn.Parameter(params["embed"])
        self.head = nn.Parameter(params["head"])

    def params(self) -> dict:
        return {"blocks": dict(self.blocks.items()),
                "embed": self.embed, "final_norm": self.final_norm,
                "head": self.head}

    def forward(self, batch: dict) -> torch.Tensor:
        return loss_fn(self.cfg, self.params(), batch)

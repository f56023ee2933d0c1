"""Model config and the model zoo (port of `repro.models.model`).

`ModelConfig` is the reference's schema, field for field. Six block
families (`ModelConfig.block`), as in the reference:
  attn_mlp        — dense decoder (phi3 / yi / llama3.2 / mistral-large /
                    pixtral)
  attn_moe        — attention + top-k MoE FFN (mixtral, SWA)
  attn_moe_dense  — attention + [dense-residual MLP ∥ MoE] (arctic)
  hybrid          — parallel attention + Mamba heads, then MLP (hymba)
  xlstm_pair      — (mLSTM, sLSTM) pair per scanned unit (xlstm)
  encoder         — bidirectional encoder, frame classifier head (hubert)
and two input frontends: "vision" (precomputed image embeddings prefix
the text; loss on text positions only) and "audio" (precomputed frame
embeddings, no token table).

Parameters keep the reference's layout: a dict tree whose block weights are
STACKED along a leading layer axis, `params["blocks"][name]` of shape
(L, …); the Mamba and xLSTM weights are NamedTuples of such leaves
(`p["mamba"]`, `p["mlstm"]`, `p["slstm"]`). The codec numbers leaves in
`jax.tree` order (sorted dict keys, NamedTuple fields in order) and chunks
each leaf whole, so per-layer weights would change every payload.
`Transformer` holds such a tree as `nn.Parameter`s. The reference's
`lax.scan` over the layers is a Python loop; with `remat` each layer is
recomputed in the backward pass (`torch.utils.checkpoint`).

Matmuls in float32 run in full float32: TF32 is switched off by
`disable_tf32()`, which the trainer calls, because TF32 keeps about three
decimal digits and would move the gradients the codec quantizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs as obs_lib
from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.kernels import marks as marks_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class RopeSpec:
    """One layer type's rotary table, as HF's `rope_parameters` gives it:
    θ, and with `factor` set YaRN's rescaling (rope_type "yarn": the
    original length the model was trained at, the rotation counts β_fast
    and β_slow that bound the ramp, the attention factor, by default
    0.1·ln(factor) + 1; the ramp's low end floored and its high end
    ceiled, HF's default `truncate`). `layers.rope_table` builds it."""
    theta: float
    factor: Optional[float] = None
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None


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
    # per layer "full" | "sliding" (None: every layer `attention_kind`),
    # and a RopeSpec per layer type ((type, RopeSpec), ...; a type not
    # named takes the plain table of `rope_theta`)
    layer_types: Optional[tuple] = None
    rope_by_type: Optional[tuple] = None
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

    def layer_kind(self, layer: int = 0) -> str:
        """Layer `layer`'s attention: "full" or "sliding"."""
        if self.layer_types is None:
            return self.attention_kind
        return self.layer_types[layer]

    @property
    def mixed_layers(self) -> bool:
        """Whether the layers differ in their attention."""
        return self.layer_types is not None and len(
            set(self.layer_types)) > 1

    @property
    def decode_refusal(self) -> Optional[str]:
        """Why the model has no decode step, or None."""
        if self.block == "encoder":
            return "encoder-only: no decode step"
        if self.mixed_layers:
            return ("mixed layer types (full and sliding attention): no "
                    "decode path")
        return None

    @property
    def decode_supported(self) -> bool:
        return self.decode_refusal is None

    @property
    def all_sliding(self) -> bool:
        return all(self.layer_kind(i) == "sliding"
                   for i in range(self.num_scanned))

    @property
    def subquadratic(self) -> bool:
        return self.block in ("xlstm_pair",) or self.all_sliding

    def window_or_none(self, layer: int = 0) -> Optional[int]:
        return self.window if self.layer_kind(layer) == "sliding" else None

    def layer_rope(self, layer: int = 0) -> RopeSpec:
        """Layer `layer`'s rotary table."""
        kind = self.layer_kind(layer)
        for name, spec in self.rope_by_type or ():
            if name == kind:
                return spec
        return RopeSpec(self.rope_theta)

    def decode_cache_len(self, seq_len: int) -> int:
        if self.all_sliding:
            return min(self.window, seq_len)
        return seq_len


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameter shapes and init
# ---------------------------------------------------------------------------
def is_shape(x) -> bool:
    """A leaf of `param_shapes`' tree: a tuple of ints (a NamedTuple of
    shapes is a subtree, not a shape)."""
    return (isinstance(x, tuple) and not hasattr(type(x), "_fields")
            and all(isinstance(d, int) for d in x))


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.block in ("attn_mlp", "attn_moe", "attn_moe_dense", "hybrid",
                         "encoder")


def block_shapes(cfg: ModelConfig) -> dict:
    """One scanned unit's leaf shapes, keys in the reference's
    `init_block` order."""
    d = cfg.d_model
    p: dict = {}
    if _has_attn(cfg):
        p.update(attn_norm=(d,), wq=(d, cfg.q_dim), wk=(d, cfg.kv_dim),
                 wv=(d, cfg.kv_dim), wo=(cfg.q_dim, d))
    if cfg.block == "hybrid":
        p["mamba"] = ssm_lib.mamba_shapes(d, cfg.di, cfg.ssm_state)
    if cfg.block in ("attn_mlp", "hybrid", "attn_moe_dense"):
        p.update(mlp_norm=(d,), w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                 w_down=(cfg.d_ff, d))
    if cfg.block == "encoder":
        p.update(mlp_norm=(d,), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
    if cfg.block in ("attn_moe", "attn_moe_dense"):
        e = cfg.num_experts
        p.update(moe_norm=(d,), router=(d, e), e_gate=(e, d, cfg.d_ff),
                 e_up=(e, d, cfg.d_ff), e_down=(e, cfg.d_ff, d))
    if cfg.block == "xlstm_pair":
        p.update(m_norm=(d,), mlstm=xlstm_lib.mlstm_shapes(d, cfg.num_heads),
                 s_norm=(d,),
                 slstm=xlstm_lib.slstm_shapes(d, cfg.num_heads))
    return p


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, in the reference's layout: block
    leaves stacked on a leading (num_scanned,) axis; no token table for
    the audio frontend."""
    n, d = cfg.num_scanned, cfg.d_model
    leaves, spec = tree_lib.flatten(block_shapes(cfg), is_leaf=is_shape)
    out = {"blocks": tree_lib.unflatten(spec, [(n,) + s for s in leaves]),
           "final_norm": (d,)}
    if cfg.frontend != "audio":
        out["embed"] = (cfg.padded_vocab, d)
    out["head"] = (d, cfg.padded_vocab)
    return out


def _build(tree, make, name="", path=""):
    """`tree` of shapes with each shape replaced by make(leaf name, shape,
    dotted path), visiting dict keys in insertion order and NamedTuple
    fields in order."""
    if is_shape(tree):
        return make(name, tree, path)
    if isinstance(tree, dict):
        return {k: _build(v, make, k, f"{path}.{k}") for k, v in tree.items()}
    return type(tree)(*[_build(v, make, f, f"{path}.{f}")
                        for f, v in zip(tree._fields, tree)])


def init_params(seed: int, cfg: ModelConfig, device=None, cut=None) -> dict:
    """Random parameters from a seeded generator on `device` (`cuda`
    unless asked for the CPU), with the reference's init rules: norms and
    the Mamba skip 1, the Mamba Δ bias −4.6 (softplus⁻¹(0.01)) and A_log
    log(1..n), the mLSTM forget gate N(0, 0.02²) + 3, every other matrix
    N(0, 0.02²). Same distributions as the reference's `init_params`, not
    the same numbers (the tests carry JAX parameters over with
    `repro_torch.convert`).

    `cut(path, leaf)`, when given, takes each leaf as soon as it is drawn
    and returns what to keep of it (a rank's slice,
    `dist.sharding.ModelShard.cut`; `path` is the dotted tree path,
    ".blocks.wq"): every leaf is drawn whole from the one stream, so the
    kept slices are bitwise the slices of the whole init, and at most one
    whole leaf is held beyond them."""
    dt = cfg.compute_dtype
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(name, shape, path):
        w = draw(name, shape)
        return w if cut is None else cut(path, w)

    def draw(name, shape):
        if name.endswith("norm") or name == "d_skip":
            return torch.ones(shape, dtype=dt, device=device)
        if name == "dt_bias":
            return torch.full(shape, -4.6, dtype=dt, device=device)
        if name == "a_log":
            n = shape[-1]
            return torch.log(torch.arange(
                1, n + 1, dtype=torch.float32, device=device)).expand(
                    shape).to(dt).contiguous()
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w = (w.normal_(generator=gen) * 0.02).to(dt)
        return w + 3.0 if name == "wf" else w

    return _build(param_shapes(cfg), make)


def param_count(cfg: ModelConfig) -> int:
    """Values in the parameter tree (from its shapes, no allocation)."""
    return sum(math.prod(s) for s in tree_lib.leaves(param_shapes(cfg),
                                                     is_leaf=is_shape))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k of E experts active)."""
    total = param_count(cfg)
    if cfg.num_experts:
        expert_leaf = (3 * cfg.num_experts * cfg.d_model * cfg.d_ff
                       * cfg.num_layers)
        active = expert_leaf * cfg.top_k // cfg.num_experts
        return total - expert_leaf + active
    return total


# ---------------------------------------------------------------------------
# Block forward (training / prefill share this; decode has its own path)
# ---------------------------------------------------------------------------
def _attn_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, layer: int = 0):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.dh)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.dh)
    freqs, scale = L.rope_table(cfg.dh, cfg.layer_rope(layer), x.device)
    q = L.apply_rope(q, positions, freqs, scale)
    k = L.apply_rope(k, positions, freqs, scale)
    return q, k, v


def _count_pairs(kind: str, sq: int, skv: int, causal: bool,
                 window: Optional[int]) -> None:
    """Obs counters of one attention call's (q, kv) block pairs, computed
    and skipped, by layer kind (host ints from the shapes)."""
    if not obs_lib.enabled():
        return
    pairs = L.block_pairs(sq, skv, causal=causal, window=window)
    done = sum(len(kv) for kv in pairs)
    every = len(pairs) * -(-skv // L.BLOCK_KV)
    obs_lib.counter(f"attn.{kind}.pairs_computed", done)
    obs_lib.counter(f"attn.{kind}.pairs_skipped", every - done)


def _self_attention(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    positions: torch.Tensor, layer: int = 0):
    """(attention output, (k, v)) of one layer."""
    b, s, _ = h.shape
    x = L.rmsnorm(h, p["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, p, x, positions, layer)
    window = cfg.window_or_none(layer)
    _count_pairs(cfg.layer_kind(layer), s, s, cfg.causal, window)
    o = L.blockwise_attention(q, k, v, causal=cfg.causal, window=window)
    return o.reshape(b, s, cfg.q_dim) @ p["wo"], (k, v)


def block_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                  positions: torch.Tensor, collect_kv: bool = False,
                  layer: int = 0):
    """One scanned unit on the weights `p` of layer `layer` (its window
    and RoPE table). Returns (h, aux_loss, kv): kv is the layer's post-RoPE
    (k, v), (B, S, K, dh) each, with `collect_kv` on a family with
    attention (prefill), else None. Marks `attn_<kind>` and `moe` start
    the attention and MoE sublayers on the card (`kernels.marks`)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kv = None
    if cfg.block in ("attn_mlp", "attn_moe", "attn_moe_dense", "encoder"):
        marks_lib.sublayer(f"attn_{cfg.layer_kind(layer)}", h)
        attn_out, kv = _self_attention(cfg, p, h, positions, layer)
        h = h + attn_out
    if cfg.block == "hybrid":
        marks_lib.sublayer(f"attn_{cfg.layer_kind(layer)}", h)
        attn_out, kv = _self_attention(cfg, p, h, positions, layer)
        x = L.rmsnorm(h, p["attn_norm"], cfg.norm_eps)
        scan_fn = (ssm_lib.mamba_assoc_scan if cfg.ssm_scan == "associative"
                   else ssm_lib.mamba_scan)
        mamba_out, _ = scan_fn(p["mamba"], x)
        h = h + 0.5 * (attn_out + mamba_out)
    if cfg.block in ("attn_mlp", "hybrid"):
        x = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.block == "encoder":
        x = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + L.gelu_mlp(x, p["w_up"], p["w_down"])
    if cfg.block in ("attn_moe", "attn_moe_dense"):
        marks_lib.sublayer("moe", h)
        x = L.rmsnorm(h, p["moe_norm"], cfg.norm_eps)
        moe_out, moe_aux = moe_lib.moe_ffn(
            x, p["router"], p["e_gate"], p["e_up"], p["e_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            return_aux=True)
        aux = aux + moe_aux["load_balance_loss"]
        if cfg.block == "attn_moe_dense":       # arctic: dense-residual ∥ MoE
            xm = L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps)
            moe_out = moe_out + L.swiglu(xm, p["w_gate"], p["w_up"],
                                         p["w_down"])
        h = h + moe_out
    if cfg.block == "xlstm_pair":
        x = L.rmsnorm(h, p["m_norm"], cfg.norm_eps)
        m_out, _ = xlstm_lib.mlstm_block(p["mlstm"], x, cfg.num_heads)
        h = h + m_out
        x = L.rmsnorm(h, p["s_norm"], cfg.norm_eps)
        s_out, _ = xlstm_lib.slstm_block(p["slstm"], x, cfg.num_heads)
        h = h + s_out
    return h, aux, (kv if collect_kv else None)


def layer_params(params: dict, i: int) -> dict:
    """Layer i's block weights (NamedTuples kept), views into the stacked
    (L, …) leaves."""
    leaves, spec = tree_lib.flatten(params["blocks"])
    return tree_lib.unflatten(spec, [x[i] for x in leaves])


# ---------------------------------------------------------------------------
# Full forward / loss
# ---------------------------------------------------------------------------
def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """Returns (h, positions, targets)."""
    dt = cfg.compute_dtype
    if cfg.frontend == "audio":
        h = batch["embeds"].to(dt)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)[None, :]
        return h, positions, batch.get("targets")
    toks = batch["tokens"]
    tok_in, targets = toks[:, :-1], toks[:, 1:]
    h = L.embed(tok_in, params["embed"]).to(dt)
    if cfg.frontend == "vision":
        img = batch["image_embeds"].to(dt)                 # (B, P, d)
        h = torch.cat([img, h], dim=1)
        # only text positions contribute to the loss
        pad = torch.full(img.shape[:2], -1, dtype=targets.dtype,
                         device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    return h, positions, targets


def forward_hidden(cfg: ModelConfig, params: dict, h: torch.Tensor,
                   positions: torch.Tensor):
    """Run the block stack over the stacked layer weights. Returns (h,
    total aux loss); with `remat`, each layer is recomputed in the backward
    pass (torch.utils.checkpoint, the counterpart of the reference's
    jax.checkpoint)."""
    leaves, spec = tree_lib.flatten(params["blocks"])

    def layer(i, hh, *weights):
        hh, a, _ = block_forward(cfg, tree_lib.unflatten(spec, weights), hh,
                                 positions, layer=i)
        return hh, a

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_scanned):
        weights = [x[i] for x in leaves]
        if cfg.remat and torch.is_grad_enabled():
            h, a = checkpoint(layer, i, h, *weights, use_reentrant=False)
        else:
            h, a = layer(i, h, *weights)
        aux = aux + a
    marks_lib.sublayer("head", h)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token (or frame-target) cross-entropy plus
    `moe_aux_coeff` times the summed load-balance loss."""
    h, positions, targets = _embed_inputs(cfg, params, batch)
    h, aux = forward_hidden(cfg, params, h, positions)
    ce = L.chunked_softmax_xent(h, params["head"], targets)
    return ce + cfg.moe_aux_coeff * aux


def logits_fn(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Full (B, S, V) logits — small models / tests only."""
    h, positions, _ = _embed_inputs(cfg, params, batch)
    h, _ = forward_hidden(cfg, params, h, positions)
    return (h @ params["head"]).to(torch.float32)


class _Tree(nn.Module):
    """A dict or NamedTuple of tensors and subtrees as registered
    Parameters and submodules, named by key or field."""

    def __init__(self, tree):
        super().__init__()
        self._kind = type(tree)
        items = tree.items() if isinstance(tree, dict) else zip(
            tree._fields, tree)
        self._keys = []
        for k, v in items:
            self._keys.append(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, _Tree(v))

    def tree(self):
        vals = [getattr(self, k) for k in self._keys]
        vals = [v.tree() if isinstance(v, _Tree) else v for v in vals]
        if self._kind is dict:
            return dict(zip(self._keys, vals))
        return self._kind(*vals)


class Transformer(nn.Module):
    """The model as an nn.Module over a parameter tree in the reference's
    layout (stacked block weights, NamedTuple subtrees); `params()` returns
    that tree of its Parameters, `forward(batch)` the loss."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.blocks = _Tree(params["blocks"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.embed = (nn.Parameter(params["embed"]) if "embed" in params
                      else None)
        self.head = nn.Parameter(params["head"])

    def params(self) -> dict:
        out = {"blocks": self.blocks.tree(), "final_norm": self.final_norm,
               "head": self.head}
        if self.embed is not None:
            out["embed"] = self.embed
        return out

    def forward(self, batch: dict) -> torch.Tensor:
        return loss_fn(self.cfg, self.params(), batch)

"""The model zoo, after ``repro.models.transformer``: decoder LMs (dense,
MoE, and the Qwen2-VL backbone with M-RoPE and patch embeddings), the
encoder (HuBERT: bidirectional, LayerNorm, audio frame embeddings), the
pure-SSM family (Mamba2: a stack of SSD blocks, no attention) and the hybrid
family (Zamba2: a Mamba2 backbone plus one weight-shared attention + MLP
block applied every ``hybrid_attn_every`` layers), behind one API:

    model = Model(cfg, parallel=None, device="cuda")
    params = model.init(seed)                        # torch generator
    logits, aux = model.forward(params, batch)       # full sequence
    loss, metrics = model.loss(params, batch)        # differentiable
    state = model.init_cache(batch, max_len)         # decode state (decoders)
    logits, state = model.prefill(params, batch, state)
    logits, state = model.decode_step(params, tok, state)

Parameters are a plain dictionary in the reference layout: block weights
are stacked with a leading layer dim, and the layers run as a Python loop
(the reference's ``lax.scan``). When the forward builds a graph (some
parameter requires grad), each layer runs under activation checkpointing
unless ``parallel.remat`` is ``"none"``, as the reference's scan body runs
under ``jax.checkpoint``: less memory, the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mlp, moe, ssm

# Families whose blocks are attention + FFN (MoE for "moe").
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "encoder")


@dataclasses.dataclass
class DecodeState:
    """Stacked per-layer decode state. Unused fields hold size-0 tensors."""

    k_cache: torch.Tensor  # [L_attn, B, S_max, KV, hd]
    v_cache: torch.Tensor
    cache_len: int  # tokens already in the cache
    conv_state: torch.Tensor  # [L_ssm, B, K-1, C_conv]
    ssm_state: torch.Tensor  # [L_ssm, B, H, P, N] f32


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.hybrid_attn_every)  # shared-block applications
    return 0


def _ssm_layer_count(cfg: ModelConfig) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def ssm_groups(cfg: ModelConfig):
    """The hybrid's SSM layers that follow each application of its shared
    block: ``hybrid_attn_every`` at a time, the last group shorter."""
    every = cfg.hybrid_attn_every
    return [range(i, min(i + every, cfg.n_layers)) for i in range(0, cfg.n_layers, every)]


def ssm_state_shapes(cfg: ModelConfig, batch: int):
    """Shapes of the SSM side state: (conv [L_ssm, B, K-1, C_conv],
    ssm [L_ssm, B, H, P, N])."""
    s = cfg.ssm
    ls = _ssm_layer_count(cfg)
    cconv = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    return ((ls, batch, s.conv_kernel - 1, cconv),
            (ls, batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cpu") -> DecodeState:
    hd = cfg.head_dim_() if cfg.has_attention else 1
    kv = cfg.n_kv_heads if cfg.has_attention else 1
    la = _attn_layer_count(cfg)
    shape = (la, batch, max_len if la else 0, kv, hd)
    if cfg.ssm is not None:
        conv_shape, ssm_shape = ssm_state_shapes(cfg, batch)
    else:
        conv_shape, ssm_shape = (0, batch, 0, 0), (0, batch, 0, 0, 0)
    return DecodeState(
        k_cache=torch.zeros(shape, dtype=dtype, device=device),
        v_cache=torch.zeros(shape, dtype=dtype, device=device),
        cache_len=0,
        conv_state=torch.zeros(conv_shape, dtype=dtype, device=device),
        ssm_state=torch.zeros(ssm_shape, dtype=torch.float32, device=device),
    )


def layer_params(tree, li: int):
    """One layer's slice of layer-stacked parameters (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, li) for k, v in tree.items()}
    return tree[li]


def unstack_layers(tree) -> list:
    """Every layer of layer-stacked parameters, each a tree of views: one
    ``torch.unbind`` per leaf, whose backward is one ``stack``. (The
    backward of ``layer_params``' indexing zero-fills a whole [L, ...]
    gradient per layer and leaf.)"""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v) for k, v in tree.items()}
        return [dict(zip(per_key, layer)) for layer in zip(*per_key.values())]
    return list(torch.unbind(tree, 0))


def check_supported(cfg: ModelConfig) -> None:
    """Every family of the reference is ported; an unknown one raises, as
    the reference's ``Model.init`` does."""
    if cfg.family not in TRANSFORMER_FAMILIES + ("ssm", "hybrid"):
        raise ValueError(cfg.family)


def block_ffn(p: dict, cfg: ModelConfig, h: torch.Tensor):
    """A block's FFN on its normed input: the MoE FFN for the ``moe``
    family, the dense MLP otherwise. Returns (y, aux)."""
    if cfg.family == "moe":
        return moe.moe_ffn(p["moe"], cfg, h)
    return mlp.mlp(p["ffn"], cfg, h), {}


def transformer_block(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Full-sequence pre-norm attention + FFN block (also the hybrid's
    shared block in the parallel forward). Returns (x, aux)."""
    h = layers.apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    x = x + attention.attend_prefill(p["attn"], cfg, h, positions)[0]
    h = layers.apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    y, aux = block_ffn(p, cfg, h)
    return x + y, aux


def ssm_block_fwd(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, p["norm"], x, cfg.norm_eps)
    return x + ssm.ssm_block(p["mixer"], cfg, h)


def ssm_layer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, conv: torch.Tensor,
                     sst: torch.Tensor):
    """One SSM layer of a decode step: (x', conv', ssm') as new tensors."""
    h = layers.apply_norm(cfg.norm, p["norm"], x, cfg.norm_eps)
    y, conv, sst = ssm.ssm_decode_step(p["mixer"], cfg, h, conv, sst)
    return x + y, conv, sst


class Model:
    """Family-dispatching model (pure functions over a parameter dict +
    config)."""

    def __init__(self, cfg: ModelConfig, parallel=None, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.parallel = parallel  # ParallelConfig or None
        self.device = resolve_device(device)

    def init(self, gen: Union[int, torch.Generator] = 0, dtype=torch.bfloat16) -> Dict[str, Any]:
        """Seeded random init on ``self.device`` (a seed or a generator)."""
        cfg = self.cfg
        dev = self.device
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))

        def norm(lead):
            return layers.make_norm_params(cfg.norm, cfg.d_model, lead, dev)

        def block(lead):
            p = {
                "norm1": norm(lead),
                "attn": attention.init_attn_params(gen, cfg, lead, dtype, dev),
                "norm2": norm(lead),
            }
            if cfg.family == "moe":
                p["moe"] = moe.init_moe_params(gen, cfg, lead, dtype, dev)
            else:
                p["ffn"] = mlp.init_mlp_params(gen, cfg, lead, dtype=dtype, device=dev)
            return p

        lead = (cfg.n_layers,)
        params: Dict[str, Any] = {
            "embed": layers.embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, dev),
        }
        if cfg.family in ("ssm", "hybrid"):
            params["blocks"] = {
                "norm": norm(lead),
                "mixer": ssm.init_ssm_params(gen, cfg, lead, dtype, dev),
            }
            if cfg.family == "hybrid":
                params["shared"] = block(())
        else:
            params["blocks"] = block(lead)
        params["final_norm"] = norm(())
        if (cfg.is_decoder and not cfg.tie_embeddings) or cfg.family == "encoder":
            params["lm_head"] = layers.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                                  dtype=dtype, device=dev)
        return params

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, params["embed"])
        return torch.matmul(x, params["lm_head"])

    def init_cache(self, batch_size: int, max_len: int, dtype=torch.bfloat16) -> DecodeState:
        return init_decode_state(self.cfg, batch_size, max_len, dtype, self.device)

    # ------------------------------------------------------------ embed in
    def _embed_inputs(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.frontend == "audio":
            # Frontend stub: precomputed frame embeddings.
            return batch["embeds"].to(params["embed"].dtype)
        x = params["embed"][batch["tokens"]]
        if cfg.frontend == "vision" and "embeds" in batch:
            # Patch embeddings replace token embeddings where the mask is set.
            mask = batch["embeds_mask"][..., None]
            x = torch.where(mask, batch["embeds"].to(x.dtype), x)
        return x

    def _positions(self, batch: Dict[str, torch.Tensor], seq: int, bsz: int, device
                   ) -> torch.Tensor:
        """[B, S] position ids, or [3, B, S] under M-RoPE (text positions on
        all three axes unless the batch brings its own)."""
        if "positions" in batch:
            return batch["positions"]
        base = torch.arange(seq, device=device)[None].expand(bsz, seq)
        return base[None].expand(3, bsz, seq) if self.cfg.mrope else base

    # ------------------------------------------------------------- forward
    def forward(self, params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward. Returns (logits [B, S, V], aux): for the
        attention families the MoE losses ``load_balance`` and ``router_z``
        summed over layers and divided by ``n_layers`` (zero for the others),
        for the SSM and hybrid families an empty dict."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        bsz, seq = x.shape[0], x.shape[1]
        positions = self._positions(batch, seq, bsz, x.device)
        run = self._block_runner(params)
        blocks = unstack_layers(params["blocks"])
        aux: Dict[str, torch.Tensor] = {}
        if cfg.family == "hybrid":
            for group in ssm_groups(cfg):
                x = run(transformer_block, params["shared"], cfg, x, positions)[0]
                for li in group:
                    x = run(ssm_block_fwd, blocks[li], cfg, x)
        elif cfg.family == "ssm":
            for blk in blocks:
                x = run(ssm_block_fwd, blk, cfg, x)
        else:
            lb = torch.zeros((), dtype=torch.float32, device=x.device)
            z = torch.zeros((), dtype=torch.float32, device=x.device)
            for blk in blocks:
                x, blk_aux = run(transformer_block, blk, cfg, x, positions)
                if cfg.family == "moe":
                    lb = lb + blk_aux["load_balance"]
                    z = z + blk_aux["router_z"]
            aux = {"load_balance": lb / cfg.n_layers, "router_z": z / cfg.n_layers}
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._head(params, x), aux

    def _block_runner(self, params):
        """How ``forward`` runs a block: under activation checkpointing when
        the call builds a graph and ``remat`` is on (the reference's default,
        ``parallel is None or parallel.remat == "block"``), else directly.
        Nothing in a block draws random numbers, so no RNG state is kept."""
        remat = self.parallel is None or self.parallel.remat == "block"
        if not (remat and torch.is_grad_enabled()
                and any(t.requires_grad for t in pytree.leaves(params))):
            return lambda fn, *args: fn(*args)
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                            preserve_rng_state=False)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch: Dict[str, torch.Tensor], moe_lb_weight: float = 0.01,
             moe_z_weight: float = 1e-3) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked mean next-token NLL over an f32 ``log_softmax`` (plus, for
        the MoE family, the weighted load-balance and router-z losses).
        Returns (total, metrics: ``ce``, ``loss`` and the MoE aux)."""
        logits, aux = self.forward(params, batch)
        targets = batch["targets"]
        mask = batch.get("loss_mask")
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        if mask is not None:
            ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            ce = nll.mean()
        total = ce
        metrics = {"ce": ce}
        if self.cfg.family == "moe":
            total = total + moe_lb_weight * aux["load_balance"] + moe_z_weight * aux["router_z"]
            metrics.update(aux)
        metrics["loss"] = total
        return total, metrics

    # -------------------------------------------------------------- decode
    def prefill(self, params, batch: Dict[str, torch.Tensor], state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Run the full prompt, filling ``state`` (in place) with every
        layer's K/V (and, for the SSM and hybrid families, the SSM states).
        Returns last-token logits [B, 1, V]. Encoders have no decode state:
        they raise, as in the reference."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            # Recurrent state by scanning the tokens (the reference's simple
            # path); the logits come from the parallel forward.
            state = self._prefill_recurrent(params, batch, state)
            return self.forward(params, batch)[0][:, -1:], state
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"prefill undefined for family {cfg.family}")
        x = self._embed_inputs(params, batch)
        bsz, seq = x.shape[0], x.shape[1]
        positions = self._positions(batch, seq, bsz, x.device)
        for li in range(cfg.n_layers):
            blk = layer_params(params["blocks"], li)
            hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
            y, k, v = attention.attend_prefill(blk["attn"], cfg, hn, positions)
            x = x + y
            hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
            x = x + block_ffn(blk, cfg, hn)[0]
            state.k_cache[li, :, :seq] = k.to(state.k_cache.dtype)
            state.v_cache[li, :, :seq] = v.to(state.v_cache.dtype)
        state.cache_len = seq
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._head(params, x[:, -1:]), state

    def _prefill_recurrent(self, params, batch, state: DecodeState) -> DecodeState:
        """One decode step per prompt token (K/V caches and SSM states)."""
        tokens = batch["tokens"]
        for i in range(tokens.shape[1]):
            _, state = self.decode_step(params, tokens[:, i: i + 1], state)
        return state

    def decode_step(self, params, token: torch.Tensor, state: DecodeState
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One token [B, 1] against the dense cache (K/V updated in place;
        the SSM states replaced by new tensors)."""
        cfg = self.cfg
        x = params["embed"][token]
        pos = state.cache_len
        if cfg.family == "hybrid":
            x = self._hybrid_decode(params, x, state)
        elif cfg.family == "ssm":
            convs, ssts = [], []
            for li in range(cfg.n_layers):
                x, conv, sst = ssm_layer_decode(layer_params(params["blocks"], li), cfg, x,
                                                state.conv_state[li], state.ssm_state[li])
                convs.append(conv)
                ssts.append(sst)
            state.conv_state = torch.stack(convs)
            state.ssm_state = torch.stack(ssts)
        elif cfg.family in ("dense", "moe", "vlm"):
            for li in range(cfg.n_layers):
                blk = layer_params(params["blocks"], li)
                hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
                x = x + attention.attend_decode(
                    blk["attn"], cfg, hn, state.k_cache[li], state.v_cache[li], pos
                )
                hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
                x = x + block_ffn(blk, cfg, hn)[0]
        else:
            raise ValueError(f"decode undefined for family {cfg.family}")
        state.cache_len = pos + 1
        x = layers.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._head(params, x), state

    def _hybrid_decode(self, params, x, state: DecodeState) -> torch.Tensor:
        cfg = self.cfg
        pos = state.cache_len
        blk = params["shared"]
        convs, ssts = [], []
        for g, group in enumerate(ssm_groups(cfg)):
            hn = layers.apply_norm(cfg.norm, blk["norm1"], x, cfg.norm_eps)
            x = x + attention.attend_decode(blk["attn"], cfg, hn, state.k_cache[g],
                                            state.v_cache[g], pos)
            hn = layers.apply_norm(cfg.norm, blk["norm2"], x, cfg.norm_eps)
            x = x + mlp.mlp(blk["ffn"], cfg, hn)
            for li in group:
                x, conv, sst = ssm_layer_decode(layer_params(params["blocks"], li), cfg, x,
                                                state.conv_state[li], state.ssm_state[li])
                convs.append(conv)
                ssts.append(sst)
        state.conv_state = torch.stack(convs)
        state.ssm_state = torch.stack(ssts)
        return x

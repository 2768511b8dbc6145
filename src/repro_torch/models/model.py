"""The model on torch: port of ``src/repro/models/model.py`` for every
family of the reference: dense, MoE, hybrid (Mamba + attention), SSM
(xLSTM), encoder-decoder and VLM.  Embed, then per layer a sequence mixer
(RMSNorm + GQA attention, or a Mamba, mLSTM or sLSTM block of ``ssm.py``),
a cross attention where the block has one, and an MLP, an MoE or none,
then the final norm and an untied unembed.

Layers follow the reference's period layout (``layer_layout``): layer i
has the block ``descs[i % period]``, whose ``mixer`` is ``"attn"``,
``"mamba"``, ``"mlstm"`` or ``"slstm"``, whose ``mlp`` is ``"dense"``,
``"moe"`` or None, and whose ``cross`` adds a cross attention to the
encoder's output.  Parameters are a dict: ``embed`` (V, D), ``unembed``
(D, V), ``final_norm`` and ``layers``, a list of per-layer dicts holding
the mixer's key, ``"xattn"`` where the block has a cross attention, and
``"mlp"`` or ``"moe"`` where it has one (the reference's per-period stack,
split; ``repro_torch.bridge`` converts).  A model with a frontend has
``frontend_proj`` (frontend_dim, D); an encoder-decoder has ``enc_layers``,
a list of ``{"attn", "mlp"}`` blocks (``ENC_DESC``, bidirectional), and
``enc_final_norm``.  The encoder runs on ``batch["frames"]`` projected by
``frontend_proj``; a VLM's ``batch["patches"]``, projected the same way,
go in front of the tokens, and the loss skips their positions.

Caches stack each state leaf over the layers of its kind only, batch at
axis 1 (``CACHE_LEAVES``): ``{"k", "v"}`` (P_attn, B, T, K, hd) dense or
(P_attn, N, block, K, hd) paged; ``{"ssm", "conv"}`` over the Mamba
layers; the mLSTM's and sLSTM's leaves under ``mlstm_``/``slstm_``
prefixes (both name a leaf ``n`` and ``m``); ``{"xk", "xv"}`` (P_cross,
B, ENC_CTX_DECODE, K, hd), the encoder's K and V of each cross layer,
filled by ``prefill`` and zero-padded to ``ENC_CTX_DECODE`` keys, which
cross attention with a cache attends unmasked, as the reference does.
Layer i works on row ``kind_row[i]`` of its mixer kind's leaves and row
``cross_row[i]`` of the cross leaves.  An attention-only model's caches
are the reference's stacked K/V.  A Python loop over the layers replaces
``lax.scan``.  As in the reference, a recurrent mixer takes its cached
single-token step only for S == 1 with a cache; any longer pass recomputes
its state from the window and writes the final state into the cache.

Under a sharding policy over a ``DeviceMesh`` (``repro_torch.sharding``;
the caller distributes the params by ``param_shardings``), ``cache_init``
distributes the caches by ``cache_shardings``, and the reference's shard
sites (model.py:243, 271, 385, 435, 480, 544) redistribute the embedded
inputs and the loss's logits.

``prefill``/``prefill_batched``/``prefill_resume`` return fresh caches and
leave their inputs as they were; ``decode`` updates ``caches`` in place (the
reference donates them).  Logits come from a bf16 product with ``unembed``
and are returned as fp32.  ``train_loss`` is the teacher-forced
cross-entropy, plus the MoE load-balance term; with ``use_flash`` set its
causal attention runs the CUDA flash kernel, which has no gradient (as in
the reference, which trains without it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding import current_policy, shard
from repro_torch.sharding.policy import mesh_sizes, placements
from repro_torch.sharding.specs import cache_spec


# Deterministic synthetic-shape conventions for enc-dec / VLM cells
ENC_CTX_DECODE = 4_096   # encoder context length used by decode shapes
DEC_PREFIX = 64          # decoder prefix length for enc-dec prefill cells


@dataclass(frozen=True)
class BlockDesc:
    mixer: str                 # attn | mamba | mlstm | slstm
    mlp: Optional[str]         # dense | moe | None
    cross: bool = False


ENC_DESC = BlockDesc("attn", "dense")


def layer_layout(cfg: ModelConfig):
    """Return (period, [BlockDesc per position within the period])."""
    if cfg.family == "ssm":
        x = cfg.xlstm
        period = x.slstm_every
        descs = [BlockDesc("slstm" if i % x.slstm_every == x.slstm_offset
                           else "mlstm", None) for i in range(period)]
        return period, descs
    period = cfg.attn_layer_period
    if cfg.moe is not None:
        period = int(np.lcm(period, cfg.moe.every_k_layers))
    descs = []
    for i in range(period):
        mixer = "attn"
        if cfg.family == "hybrid" and i % cfg.attn_layer_period != cfg.attn_layer_offset:
            mixer = "mamba"
        if cfg.moe is not None and i % cfg.moe.every_k_layers == cfg.moe.moe_layer_offset:
            mlp = "moe"
        elif cfg.d_ff > 0:
            mlp = "dense"
        else:
            mlp = None
        descs.append(BlockDesc(mixer, mlp, cross=cfg.cross_attention))
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    return period, descs


# K/V caches are bf16 whatever the compute dtype: the reference binds it as
# attention_cache_init's default (layers.py:285, 293)
KV_DTYPE = torch.bfloat16

class Mixer(NamedTuple):
    """A recurrent mixer kind: the prefix of its cache leaves' names (the
    mLSTM's and sLSTM's both have an ``n`` and an ``m``), and its
    functions in ``ssm.py``."""
    prefix: str
    init: Callable
    block: Callable
    cache_init: Callable


RECURRENT = {
    "mamba": Mixer("", ssm_lib.mamba_init, ssm_lib.mamba_block,
                   ssm_lib.mamba_cache_init),
    "mlstm": Mixer("mlstm_", ssm_lib.mlstm_init, ssm_lib.mlstm_block,
                   ssm_lib.mlstm_cache_init),
    "slstm": Mixer("slstm_", ssm_lib.slstm_init, ssm_lib.slstm_block,
                   ssm_lib.slstm_cache_init),
}
# every mixer kind's cache leaves, and the cross attention's, as the
# caches name them
CACHE_LEAVES = {"attn": ("k", "v"), "mamba": ("ssm", "conv"),
                "mlstm": ("mlstm_C", "mlstm_n", "mlstm_m"),
                "slstm": ("slstm_c", "slstm_n", "slstm_h", "slstm_m"),
                "cross": ("xk", "xv")}


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.period, self.descs = layer_layout(cfg)
        self.n_periods = cfg.num_layers // self.period
        self.n_layers = cfg.num_layers
        self.layer_descs = [self.descs[i % self.period]
                            for i in range(self.n_layers)]
        self.mixers = [d.mixer for d in self.layer_descs]
        # layer i's row in the stacked cache leaves of its mixer kind, and
        # in the cross leaves
        self.kind_row = [self.mixers[:i].count(m)
                         for i, m in enumerate(self.mixers)]
        self.cross_row = [sum(d.cross for d in self.layer_descs[:i])
                          for i in range(self.n_layers)]
        self.n_cross = sum(d.cross for d in self.layer_descs)
        self.use_flash = False   # the loss's attention on the flash kernel

    # ------------------------------------------------------------- init ----

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """Random weights with the reference's distributions and scales
        (model.py:84-133, layers.py:71-83, 306-315, moe.py:23-40,
        ssm.py:25-44, 183-201, 344-356), drawn
        from ``generator`` on ``device`` (``cuda`` unless the caller names
        another; the generator must live there too), one leaf at a time in
        fp32 and cast to ``dtype``."""
        cfg = self.cfg
        dev = resolve_device(device)
        d, v = cfg.d_model, cfg.vocab_size
        params = {
            "embed": L._init(generator, (v, d), 0.02, dtype, dev),
            "unembed": L._init(generator, (d, v), d ** -0.5, dtype, dev),
            "final_norm": L.rmsnorm_init(d, dtype, dev),
            "layers": [self._block_init(generator, desc, dtype, dev)
                       for desc in self.layer_descs],
        }
        if cfg.frontend:
            params["frontend_proj"] = L._init(
                generator, (cfg.frontend_dim, d), cfg.frontend_dim ** -0.5,
                dtype, dev)
        if cfg.num_encoder_layers:
            params["enc_layers"] = [
                self._block_init(generator, ENC_DESC, dtype, dev)
                for _ in range(cfg.num_encoder_layers)]
            params["enc_final_norm"] = L.rmsnorm_init(d, dtype, dev)
        return params

    def init_abstract(self, dtype=torch.float32):
        """Every leaf's shape and dtype, allocating nothing: :meth:`init` on
        the ``meta`` device (the reference's ``jax.eval_shape`` of its init,
        model.py:135)."""
        return self.init(None, dtype, torch.device("meta"))

    def _block_init(self, generator, desc: BlockDesc, dtype, device):
        cfg = self.cfg
        if desc.mixer == "attn":
            p = {"attn": L.attention_init(generator, cfg, dtype, device)}
        else:
            init = RECURRENT[desc.mixer].init
            p = {desc.mixer: init(generator, cfg, dtype, device)}
        if desc.cross:
            p["xattn"] = L.attention_init(generator, cfg, dtype, device)
        if desc.mlp == "dense":
            p["mlp"] = L.mlp_init(generator, cfg, dtype, device)
        elif desc.mlp == "moe":
            p["moe"] = moe_lib.moe_init(generator, cfg, dtype, device)
        return p

    # ----------------------------------------------------------- caches ----

    def _kv_layout(self, rows, cols):
        """{"k", "v": (shape, dtype, fill)} of the K/V leaves: (P_attn, rows,
        cols, K, hd) zeros in bf16 (none without attention layers)."""
        cfg = self.cfg
        n_attn = self.mixers.count("attn")
        if not n_attn:
            return {}
        shape = (n_attn, rows, cols, cfg.num_kv_heads, cfg.resolved_head_dim)
        return dict.fromkeys(("k", "v"), (shape, KV_DTYPE, 0.0))

    def _cache_layout(self, batch, max_len):
        """{leaf: (shape, dtype, fill)} of the decode caches (module
        docstring): every leaf starts uniform, at 0 or at a recurrent
        kind's value (``-inf`` for its stabilisers), read from that kind's
        ``*_cache_init`` of one row on the CPU."""
        cfg = self.cfg
        layout = self._kv_layout(batch, max_len)
        if self.n_cross:
            shape = (self.n_cross, batch, ENC_CTX_DECODE, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            for name in CACHE_LEAVES["cross"]:
                layout[name] = (shape, L.COMPUTE_DTYPE, 0.0)
        for kind, mixer in RECURRENT.items():
            n = self.mixers.count(kind)
            if n:
                for name, t in mixer.cache_init(cfg, 1, "cpu").items():
                    fill = t.reshape(-1)[0]
                    assert bool((t == fill).all()), (kind, name)
                    layout[mixer.prefix + name] = (
                        (n, batch, *t.shape[1:]), t.dtype, float(fill))
        return layout

    def cache_init(self, batch, max_len, device):
        """The decode caches (module docstring): K/V zeros in bf16, each
        recurrent kind's state as its ``*_cache_init`` gives it (fp32
        states, ``-inf`` stabilisers, a bf16 conv state), stacked over the
        layers of that kind, and the cross layers' encoder K/V, zeros in
        the compute dtype (model.py:306-311).  Under a policy over a
        ``DeviceMesh`` they are DTensors laid out by ``cache_shardings``,
        each rank allocating only its local shards."""
        return _materialise(self._cache_layout(batch, max_len), device)

    def paged_cache_init(self, num_pages, block, device):
        """Global KV page pools (P, num_pages + 1, block, K, hd), zeros,
        bf16: the +1 is the reserved trash page 0 (inactive slots write
        there; never allocated).  Attention-only stacks, see
        :attr:`supports_paged_decode`."""
        if not self.supports_paged_decode:
            raise ValueError(f"{self.cfg.name}: paged KV needs a pure "
                             f"causal-attention stack")
        return _materialise(self._kv_layout(num_pages + 1, block), device)

    def _layer_cache(self, caches, i):
        """Layer i's views of ``caches``, under its block's own names (and
        ``xk``/``xv`` for a cross layer)."""
        kind, j = self.mixers[i], self.kind_row[i]
        names = CACHE_LEAVES[kind]
        prefix = "" if kind == "attn" else RECURRENT[kind].prefix
        views = {n[len(prefix):]: caches[n][j] for n in names}
        if self.layer_descs[i].cross:
            views.update((n, caches[n][self.cross_row[i]])
                         for n in CACHE_LEAVES["cross"])
        return views

    # The reference's capability gates (model.py:338-345, 400-418): each
    # needs a pure causal-attention stack; a recurrent mixer's state has no
    # block-granular form, absorbs padding and is not resumable.
    def _attention_only(self) -> bool:
        return (all(d.mixer == "attn" and not d.cross for d in self.descs)
                and self.cfg.family not in ("encdec", "vlm"))

    @property
    def supports_paged_decode(self) -> bool:
        """The shared page pool holds attention K/V only."""
        return self._attention_only()

    @property
    def supports_padded_prefill(self) -> bool:
        """Right-padded ragged prompt batches are exact for causal
        attention: a padding token is never attended by an earlier query."""
        return self._attention_only()

    @property
    def supports_prefill_resume(self) -> bool:
        """A resumed prompt pass needs every mixer's state in the KV
        cache."""
        return self._attention_only()

    # ------------------------------------------------------------ stack ----

    def _run_stack(self, params, x, caches, *, positions, write_index=None,
                   decode_impl="sdpa", page_table=None, remat=False,
                   enc_out=None):
        """The layers in order; returns (x, the sum of the MoE layers'
        ``moe_aux_loss``, a 0-d fp32 tensor, or 0.0 without MoE layers),
        as the reference's scan body sums it (model.py:206-237).
        ``caches=None`` is the loss's pass (no cache, nothing written; a
        cross layer attends to ``enc_out``); ``remat`` recomputes each
        layer in the backward pass instead of keeping its activations (the
        reference checkpoints the scan body, model.py:228-229)."""
        aux_sum = 0.0
        for i, lp in enumerate(params["layers"]):
            bc = None if caches is None else self._layer_cache(caches, i)
            args = (lp, self.layer_descs[i], x, bc, positions, write_index,
                    decode_impl, page_table, enc_out)
            if remat:
                x, aux = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                x, aux = self._layer(*args)
            if aux is not None:
                aux_sum = aux_sum + aux
        return x, aux_sum

    def _layer(self, lp, desc, x, bc, positions, write_index, decode_impl,
               page_table, enc_out, causal=True):
        """One block -> (x, its ``moe_aux_loss`` or None).  ``bc``, the
        layer's cache views, is written in place (model.py:141-192)."""
        cfg = self.cfg
        if desc.mixer == "attn":
            h, _ = L.attention(lp["attn"], x, cfg, positions=positions,
                               kv_cache=bc, write_index=write_index,
                               causal=causal, use_flash=self.use_flash,
                               decode_impl=decode_impl, page_table=page_table)
        else:
            is_step = x.shape[1] == 1 and bc is not None
            h, state = RECURRENT[desc.mixer].block(
                lp[desc.mixer], x, cfg, cache=bc if is_step else None)
            if bc is not None:
                for name, t in state.items():
                    bc[name].copy_(t)
        x = x + h
        if desc.cross:
            if bc is not None:
                h = self._cross_cached(lp["xattn"], x, bc["xk"], bc["xv"])
            else:
                h, _ = L.attention(lp["xattn"], x, cfg, kv_source=enc_out,
                                   causal=False, use_rope=False)
            x = x + h
        if "moe" in lp:
            h, aux = moe_lib.moe(lp["moe"], x, cfg)
            return x + h, aux["moe_aux_loss"]
        if "mlp" in lp:
            x = x + L.mlp(lp["mlp"], x, cfg)
        return x, None

    def _cross_cached(self, params, x, xk, xv):
        """Cross attention against the cached encoder K/V: every one of
        the cache's ``ENC_CTX_DECODE`` keys, zero padding included, with no
        mask (model.py:194-202)."""
        cfg = self.cfg
        dt = L.COMPUTE_DTYPE
        xn = L.rmsnorm(params["norm"], x, cfg.norm_eps)
        q = L.head_einsum("bsd,dhk->bshk", xn, params["wq"].to(dt),
                          w_heads=1, out_heads=2)
        out = L._attend_local(
            lambda q1, k1, v1: L._sdpa(q1, k1, v1, None, cfg.q_heads_per_kv),
            q, (xk.to(dt), xv.to(dt)))
        return L.head_einsum("bshk,hkd->bsd", out, params["wo"].to(dt),
                             w_heads=0, x_heads=2)

    def _run_encoder(self, params, frames):
        """The encoder over ``frames`` (B, S, frontend_dim): projected by
        ``frontend_proj``, then each ``ENC_DESC`` block with bidirectional
        self-attention, then ``enc_final_norm`` (model.py:239-253)."""
        dt = L.COMPUTE_DTYPE
        frames = torch.as_tensor(frames, device=params["embed"].device)
        x = torch.einsum("bsf,fd->bsd", frames.to(dt),
                         params["frontend_proj"].to(dt))
        x = shard(x, "batch", "seq", "act_embed")
        for lp in params["enc_layers"]:
            x, _ = self._layer(lp, ENC_DESC, x, None, None, None, "sdpa",
                               None, None, causal=False)
        return L.rmsnorm(params["enc_final_norm"], x, self.cfg.norm_eps)

    def _embed(self, params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()].to(L.COMPUTE_DTYPE)

    def _embed_inputs(self, params, batch):
        """(x, enc_out or None, label offset) of ``batch`` (model.py:
        257-271): an encoder-decoder runs its encoder on ``frames``; a
        VLM's ``patches``, projected, go in front of the tokens, and the
        offset is their count."""
        cfg = self.cfg
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self._run_encoder(params, batch["frames"])
        x = self._embed(params, batch["tokens"])
        offset = 0
        if cfg.family == "vlm" and "patches" in batch:
            dt = L.COMPUTE_DTYPE
            patches = torch.as_tensor(batch["patches"], device=x.device)
            pe = torch.einsum("bpf,fd->bpd", patches.to(dt),
                              params["frontend_proj"].to(dt))
            x = torch.cat([pe, x], dim=1)
            offset = pe.shape[1]
        return shard(x, "batch", "seq", "act_embed"), enc_out, offset

    def _fill_cross_cache(self, params, caches, enc_out):
        """Each cross layer's encoder K and V, cut or zero-padded to the
        cache's ``ENC_CTX_DECODE`` keys, into ``caches`` in place
        (model.py:447-464)."""
        dt = L.COMPUTE_DTYPE
        src = enc_out.to(dt)
        for i, lp in enumerate(params["layers"]):
            if not self.layer_descs[i].cross:
                continue
            j = self.cross_row[i]
            for name, w in (("xk", "wk"), ("xv", "wv")):
                kv = L.head_einsum("bsd,dhk->bshk", src,
                                   lp["xattn"][w].to(dt), w_heads=1,
                                   out_heads=2)
                dst = caches[name][j]
                dst.copy_(_fit_len(kv, dst.shape[1]))

    def _logits(self, params, x):
        """x: (B,1,D) -> fp32 (B,V) from the bf16 product with unembed."""
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x,
                              params["unembed"].to(L.COMPUTE_DTYPE))
        return logits[:, 0].float()

    # ------------------------------------------------------------- train ---

    def train_loss(self, params, batch, *, remat=True):
        """Next-token cross-entropy of ``batch["tokens"]`` (B,S) int, plus
        0.01 x the MoE aux loss per period when the model has MoE layers; a
        0-d fp32 tensor on the params' device (model.py:275-288).  A VLM's
        patch positions are left out of the loss."""
        x, enc_out, offset = self._embed_inputs(params, batch)
        x, aux = self._run_stack(params, x, None, positions=None,
                                 remat=remat, enc_out=enc_out)
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        if offset:
            x = x[:, offset:, :]
        tokens = torch.as_tensor(batch["tokens"], device=x.device).long()
        loss = _chunked_ce(x[:, :-1], tokens[:, 1:], params["unembed"])
        if self.cfg.moe is not None:
            loss = loss + 0.01 * aux / max(self.n_periods, 1)
        return loss

    # ----------------------------------------------------------- serving ---

    def prefill(self, params, batch, max_len=None):
        """batch: {"tokens": (B,S) int}, with ``frames`` (B, S_enc,
        frontend_dim) for an encoder-decoder or ``patches`` (B, P,
        frontend_dim) for a VLM.  Returns (last_logits (B,V) fp32, caches
        sized ``max_len``): a VLM's caches hold the P patch positions, then
        the tokens'; an encoder-decoder's hold its cross K/V
        (model.py:348-364)."""
        x, enc_out, _ = self._embed_inputs(params, batch)
        b, s = x.shape[0], x.shape[1]
        caches = self.cache_init(b, max_len or s, x.device)
        if self.cfg.family == "encdec" and enc_out is not None:
            self._fill_cross_cache(params, caches, enc_out)
        positions = torch.arange(s, device=x.device)
        x, _ = self._run_stack(params, x, caches, positions=positions,
                               write_index=0, enc_out=enc_out)
        return self._logits(params, x[:, -1:]), caches

    def prefill_batched(self, params, tokens, lengths, max_len=None):
        """Ragged prompt batch, each row right-padded to S; row i's logits
        are taken at position ``lengths[i] - 1`` (model.py:366-398)."""
        x = shard(self._embed(params, tokens), "batch", "seq", "act_embed")
        b, s = x.shape[0], x.shape[1]
        caches = self.cache_init(b, max_len or s, x.device)
        positions = torch.arange(s, device=x.device)
        x, _ = self._run_stack(params, x, caches, positions=positions,
                            write_index=0)
        lengths = torch.as_tensor(lengths, device=x.device).long()
        idx = torch.clamp(lengths - 1, 0, s - 1)
        x = x[torch.arange(b, device=x.device), idx][:, None]
        return self._logits(params, x), caches

    def prefill_resume(self, params, caches, tokens, start):
        """Continue a prompt pass from position ``start``: ``caches`` holds
        valid K/V below ``start``, and the suffix ``tokens`` (B, S) is
        written from ``start`` on into a copy of it, so the donor stays
        valid for the prefix cache that holds it.  Returns (last_logits
        (B,V), caches).  Attention-only models, see
        :attr:`supports_prefill_resume`."""
        if not self.supports_prefill_resume:
            raise ValueError(f"{self.cfg.name}: a resumed prompt pass needs "
                             f"every mixer's state in the KV cache")
        caches = {n: t.clone() for n, t in caches.items()}
        x = shard(self._embed(params, tokens), "batch", "seq", "act_embed")
        s = x.shape[1]
        start = int(start)
        positions = torch.arange(s, device=x.device) + start
        x, _ = self._run_stack(params, x, caches, positions=positions,
                            write_index=start)
        return self._logits(params, x[:, -1:]), caches

    def decode(self, params, caches, tokens, cur_index, decode_impl="sdpa",
               page_table=None):
        """One decode step, updating ``caches`` in place.  tokens: (B,1)
        int; cur_index: an int, or an int (B,) tensor for ragged continuous
        batching.  ``"pallas"`` runs the CUDA decode kernel, ``"paged"``
        the CUDA paged kernel over ``caches`` from :meth:`paged_cache_init`
        and ``page_table`` (B, W) int32; ``"sdpa"``/``"paged_sdpa"`` are
        the plain paths.  Returns (logits (B,V) fp32, caches)."""
        x = shard(self._embed(params, tokens), "decode_batch", None,
                  "act_embed")
        b = x.shape[0]
        if isinstance(cur_index, torch.Tensor) and cur_index.dim() == 1:
            cur = cur_index.to(device=x.device, dtype=torch.int32)
            positions = cur[:, None]
        else:
            cur = int(cur_index)
            positions = torch.full((b, 1), cur, dtype=torch.int32,
                                   device=x.device)
        x, _ = self._run_stack(params, x, caches, positions=positions,
                            write_index=cur, decode_impl=decode_impl,
                            page_table=page_table)
        return self._logits(params, x), caches

    # ----------------------------------------------------------- dry-run ----

    def input_specs(self, shape: ShapeConfig):
        """``meta`` tensors standing in for the step inputs (no allocation;
        the reference's ``ShapeDtypeStruct``s, model.py:496-511)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16

        def spec(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            if cfg.family == "encdec":
                dec = s if shape.kind == "train" else DEC_PREFIX
                return {"frames": spec((b, s, cfg.frontend_dim), bf16),
                        "tokens": spec((b, dec), i32)}
            if cfg.family == "vlm":
                return {"patches": spec((b, cfg.num_patches,
                                         cfg.frontend_dim), bf16),
                        "tokens": spec((b, s - cfg.num_patches), i32)}
            return {"tokens": spec((b, s), i32)}
        return {"tokens": spec((b, 1), i32), "cur_index": spec((), i32)}

    def cache_specs(self, shape: ShapeConfig):
        """The decode caches on the ``meta`` device (model.py:513-515),
        stacked by leaf kind as :meth:`cache_init` stacks them."""
        assert shape.kind == "decode"
        return self.cache_init(shape.global_batch, shape.seq_len,
                               torch.device("meta"))

    # ------------------------------------------------------------- flops ----

    def model_flops(self, shape: ShapeConfig) -> float:
        """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active
        params (model.py:519-527)."""
        n = self.cfg.active_param_count()
        if shape.kind == "train":
            return 6.0 * n * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n * shape.global_batch * shape.seq_len
        return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _materialise(layout, device):
    """The tensors of ``layout`` ({leaf: (shape, dtype, fill)}) on
    ``device``.  Under a policy over a ``DeviceMesh`` (a stub mesh only
    sizes the MoE's dispatch groups) each is a DTensor laid out by
    ``cache_spec``, every rank allocating only its local shard: a cache is
    never built whole on a rank."""
    policy = current_policy()
    if policy is None or not isinstance(policy.mesh, DeviceMesh):
        return {name: torch.full(shape, fill, dtype=dtype, device=device)
                for name, (shape, dtype, fill) in layout.items()}
    mesh, sizes = policy.mesh, mesh_sizes(policy.mesh)
    out = {}
    for name, (shape, dtype, fill) in layout.items():
        spec = cache_spec(name, shape, policy)
        local = [d // math.prod(sizes[a] for a in
                                ((e,) if isinstance(e, str) else (e or ())))
                 for d, e in zip(shape, spec)]
        stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        out[name] = DTensor.from_local(
            torch.full(local, fill, dtype=dtype, device=device), mesh,
            placements(mesh, spec), run_check=False, shape=torch.Size(shape),
            stride=tuple(stride))
    return out


LOSS_CHUNK = 512


def _fit_len(x, t):
    """x cut or zero-padded along axis 1 to ``t`` (model.py:568-575)."""
    if x.shape[1] >= t:
        return x[:, :t]
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, t - x.shape[1]))


def _pad_zeros(t, pad):
    """``t`` with ``pad`` zeros appended along axis 1: a concatenation,
    which DTensor takes on torch 2.11, where its ``pad`` fails."""
    zeros = torch.zeros((t.shape[0], pad, *t.shape[2:]), dtype=t.dtype,
                        device=t.device)
    return torch.cat([t, zeros], dim=1)


def _chunked_ce(x, tgt, unembed, chunk=LOSS_CHUNK):
    """Cross-entropy without the full (B,S,V) logits: ``chunk`` positions at
    a time, each chunk checkpointed so the backward pass stays chunk-sized
    too (model.py:530-565).  Logits from a bf16 product with ``unembed``,
    log-sum-exp in fp32; the padded tail has weight 0."""
    b, s, _ = x.shape
    w_bf16 = unembed.to(L.COMPUTE_DTYPE)

    def block(xb, tb, wb):
        logits = shard(torch.einsum("bsd,dv->bsv", xb, w_bf16),
                       "batch", "seq", "vocab").float()
        logz = torch.logsumexp(logits, dim=-1)
        if isinstance(logits, DTensor):
            # gather along the sharded vocab has no working DTensor form
            # (its masked partial fails on 3-D logits); the masked sum keeps
            # the vocab sharded and picks the same value exactly
            vocab = torch.arange(logits.shape[-1], device=tb.device)
            ll = torch.sum(torch.where(vocab == tb[..., None], logits, 0.0),
                           dim=-1)
        else:
            ll = torch.gather(logits, -1, tb[..., None])[..., 0]
        return torch.sum((logz - ll) * wb), torch.sum(wb)

    w = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if s <= chunk:
        tot, cnt = checkpoint(block, x, tgt, w, use_reentrant=False)
        return tot / cnt
    pad = (-s) % chunk
    if pad:
        x, tgt, w = (_pad_zeros(t, pad) for t in (x, tgt, w))
    tots, cnts = zip(*(checkpoint(block, x[:, i:i + chunk],
                                  tgt[:, i:i + chunk], w[:, i:i + chunk],
                                  use_reentrant=False)
                       for i in range(0, x.shape[1], chunk)))
    return torch.sum(torch.stack(tots)) / torch.sum(torch.stack(cnts))

"""Model assembly: embed -> block stack -> norm -> LM head.

The leading layers that do not repeat (deepseek's first dense layer)
run first, one by one; then depth runs as a Python loop over repetitions
of the config's block pattern (the reference's `lax.scan`): repetition r
of pattern slot s takes the views `[r]` of that slot's stacked
parameters and cache. A layer's descriptor is the reference's
`(kind, is_moe)`: its mixer ("attn": attention, sliding-window or MLA;
"mamba": the Mamba-2 mixer) and whether its FFN is the MoE, so one stack
may mix the kinds (jamba's 1 attention : 7 Mamba).

Caches: each attention layer writes a static-capacity ring `KVCache` in
place (`layers._cache_update`): K and V, or under MLA the latent c_kv
and the rotated k_rope; a sliding-window layer's ring holds at most the
window. Each Mamba layer writes its `MambaCache` (conv window and SSM
state) in place. A slot's cache tensors are stacked on the same leading
`[n_reps]` axis as its parameters, a prefix layer's are not; every
cursor is a host int. The port runs every architecture of the zoo:
the decoder-only ones (qwen1.5-4b, minitron-4b, starcoder2-7b,
command-r-35b, deepseek-v2-lite-16b, mixtral-8x7b, mamba2-370m,
jamba-1.5-large-398b), the encoder-decoder whisper-base and the
stub-frontend llava-next-mistral-7b.

Whisper (`n_enc_layers > 0`): `encode` runs the stub frontend's frame
embeddings through `frame_proj` and the stacked encoder layers
(non-causal attention, then the MLP) to `enc_out`; the decoder stack
(`backbone_with_cross`) follows each layer's self-attention block with
that layer's cross-attention over `enc_out`. `prefill` encodes inside;
`decode_step` takes `enc_out` from its caller. Llava (`frontend ==
"vision_stub"`): `embed_inputs` prepends the stub's patch embeddings,
projected by `patch_proj`, to the token embeddings, so the patches take
positions 0..P-1 and the caches; `loss` pads the targets with -1 over
them.

`loss` is training's objective, the reference's token-mean cross
entropy over sequence chunks plus 0.01 times the MoE load-balancing
loss. Under autograd each chunk's logits are recomputed in the backward
pass (`torch.utils.checkpoint`), so the [tokens, vocab] logits are held
one chunk at a time, as the reference's chunked scan bounds them.

Sharded serving (`parallel.spmd.run`, each mesh point calling `prefill`
and `decode_step` on its local parameters and batch rows): the
embedding is a vocab-parallel lookup (`layers.embed`), the LM head's
local vocabulary columns give local logits that are all-gathered over
"model", and `init_cache` holds the point's kv heads (`layers.
heads_split`), or, where they do not split whole, its range of the
slots (`layers.cache_split`: the sequence split), and at a batch the
data axes do not divide its range of the slots over "data" too. MLA's
latent and rope caches hold the point's columns (`layers.mla_split`),
or at that batch its range of the slots over "data" at every column,
or, where MLA splits by sequence, its range of the slots over "model"
(and "data" at that batch) at every column; a
Mamba layer's conv window holds the point's channels (`layers.
mamba_split`) and its SSM state the point's heads, over "model", or at
that batch over "data" (`layers.ssm_split`). So a point's cache bytes
are `cache_spec`'s local share, laid out as it lays them out. The stub
frontends' embeddings (llava's patches, whisper's frames) are projected
by the point's columns of `patch_proj` or `frame_proj` and all-gathered
(`_stub_proj`); whisper's encoder layers and cross-attention run on the
point's heads. Sharded training differentiates `loss` there: the
collectives carry gradients (`parallel.spmd`) and the loss is the
global batch's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import (
    ModelConfig, init_params, layer_layout, moe_layer_indices,
)
from repro_torch.parallel import spmd as SP


class Batch(NamedTuple):
    tokens: torch.Tensor                    # [B, S] integer
    targets: torch.Tensor                   # [B, S] integer (-1 = no loss)
    extra: Optional[torch.Tensor] = None    # vision/audio stub embeddings


def _at(tree, r: int):
    """The views `[r]` of a dict of stacked tensors (a sharded leaf's
    keeping its spec: `spmd.index`)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return SP.index(tree, r)


def _stacked(tree):
    """A dict of stacked tensors with each sharded leaf whose stacked dim
    is split (deepseek's shared experts under expert parallelism: the
    sharding rules give them the experts' spec, so a point holds a run of
    the layers) all-gathered along it, once a call, so `_at` can take any
    layer; the others as they are."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    axes = SP.split_axes(tree, 0)
    return SP.whole(tree, axes[0]) if axes else tree


def _slot_view(sc, r: int):
    """Repetition r's cache of a stacked slot cache: views `[r]` of its
    tensors, written in place by the layer; a `KVCache` keeps the slot's
    cursor."""
    if isinstance(sc, L.MambaCache):
        return L.MambaCache(sc.conv[r], sc.ssm[r])
    return dataclasses.replace(sc, k=sc.k[r], v=sc.v[r])


def _logits(h, w, vocab):
    """f32 logits of hidden `h` under the LM head `w` [d, V]; in
    `spmd.run`, with the vocabulary split over `vocab`, `w` holds the
    point's columns and their logits are all-gathered over `vocab`."""
    if not vocab:
        return (h @ w).float()
    logits = (SP.copy(h, vocab) @ w).float()
    return SP.all_gather(logits, vocab, -1)


def _stub_proj(w, emb):
    """The stub frontend's embeddings `emb` [B, n, d] projected by `w`
    (`patch_proj`, `frame_proj`); in `spmd.run` (`emb` the point's rows)
    `w`'s FSDP rows gathered, `emb` projected by the point's columns and
    the [B, n, d/tp] results all-gathered over their axes: the gather
    moves the projected embeddings, not the weight."""
    w = SP.whole(w, "data")
    split = SP.split_axes(w, -1)
    out = emb @ w
    return SP.all_gather(out, split, -1) if split else out


def _chunk_nll(xc, w, vocab, tc):
    """Summed NLL of one chunk: f32 logits, logsumexp minus the gold
    logit where the target is >= 0."""
    logits = _logits(xc, w, vocab)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, torch.clamp(tc, min=0)[:, None].long())
    return torch.where(tc >= 0, lse - gold[:, 0], 0.0).sum()


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.prefix_n, self.full_period, self.n_reps = layer_layout(cfg)
        moe_idx = set(moe_layer_indices(cfg))
        # static layer descriptors: (mixer kind, whether the FFN is the MoE)
        self.prefix_slots = [(cfg.layer_kind(i), i in moe_idx)
                             for i in range(self.prefix_n)]
        self.slots = [(cfg.layer_kind(i), i in moe_idx) for i in range(
            self.prefix_n, self.prefix_n + self.full_period)]

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters on `gen.device`, drawn from `gen`."""
        return init_params(gen, self.cfg)

    # ------------------------------------------------------------------
    def _apply_block(self, kind: str, is_moe: bool, p, x, positions, cache,
                     ring, collect_aux: bool = False):
        """One layer: (x, new cache, f32 MoE aux loss — the Python 0.0
        unless `collect_aux` on a MoE layer, so serving adds no work)."""
        cfg = self.cfg
        aux = 0.0
        if kind == "mamba":
            x, new_cache = L.mamba2(p["mixer"], x, cfg.mamba, cache,
                                    norm_kind=cfg.norm)
        else:
            x, new_cache = L.attention(p["mixer"], x, cfg.attn, positions,
                                       cache, norm_kind=cfg.norm, ring=ring)
        if is_moe:
            if collect_aux:
                aux = L.moe_aux_loss(p["ffn"], x, cfg, norm_kind=cfg.norm)
            x = L.moe(p["ffn"], x, cfg, norm_kind=cfg.norm)
        elif "ffn" in p:                # d_ff == 0: mixer-only block
            x = L.mlp(p["ffn"], x, cfg.act, norm_kind=cfg.norm)
        return x, new_cache, aux

    # ------------------------------------------------------------------
    def _empty_cache_slot(self, kind: str, batch: int, cap: int, device,
                          lead=()):
        cfg = self.cfg
        if kind == "mamba":
            mb = cfg.mamba
            d_inner = mb.expand * cfg.d_model
            tp = L.mamba_split(mb, cfg.d_model)  # the point's channels
            _, _, nh = L.ssm_split(mb, cfg.d_model,   # and SSM heads
                                   L.whole_batch(batch))
            return L.MambaCache(
                conv=torch.zeros((*lead, batch, mb.d_conv - 1,
                                  (d_inner + 2 * mb.d_state) // tp),
                                 dtype=cfg.dtype, device=device),
                ssm=torch.zeros((*lead, batch, nh, mb.head_dim, mb.d_state),
                                dtype=torch.float32, device=device))
        a = cfg.attn
        axes, start = L.cache_split(a, batch, cap)  # the point's slots
        ways = math.prod(SP.context().size(x) for x in axes)
        if a.kv_lora_rank:              # MLA: c_kv and k_rope, the point's
            # columns of each, or every column at a batch whole on every
            # point or under the sequence split (`mla_split` 1)
            tp = 1 if L.whole_batch(batch) else L.mla_split(a)
            k_shape = (*lead, batch, cap // ways, a.kv_lora_rank // tp)
            v_shape = (*lead, batch, cap // ways, a.rope_head_dim // tp)
        else:                           # the point's kv heads
            k_shape = v_shape = (*lead, batch, cap // ways,
                                 a.num_kv_heads // L.heads_split(a),
                                 a.head_dim)
        return L.KVCache(
            k=torch.zeros(k_shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(v_shape, dtype=cfg.dtype, device=device), index=0,
            start=start, slots=cap, axes=axes)

    def init_cache(self, batch: int, cap: int, device) -> Dict[str, Any]:
        """Empty caches: one per prefix layer, and one per pattern slot
        stacked on `[n_reps]`. A sliding-window layer's ring holds
        min(cap, window) slots (context_class "window"); a Mamba layer's
        state does not grow with `cap`. In `spmd.run` each holds this
        point's share (the module's note); `batch` is the point's rows."""
        window = self.cfg.attn and self.cfg.attn.sliding_window

        def cap_for(kind):
            return min(cap, window) if kind == "attn" and window else cap
        return {"prefix": [self._empty_cache_slot(k, batch, cap_for(k),
                                                  device)
                           for k, _ in self.prefix_slots],
                "slots": [self._empty_cache_slot(k, batch, cap_for(k),
                                                 device, (self.n_reps,))
                          for k, _ in self.slots]}

    # ------------------------------------------------------------------
    def backbone(self, params, x, positions, caches=None,
                 collect_aux: bool = False):
        """Embedded input -> final hidden. Returns (x, caches, aux), the
        caches written in place with the attention cursors moved on, aux
        the sum of the MoE layers' load-balancing losses (the Python 0.0
        unless `collect_aux`: no device work on the serving path). An
        attention cache's positions after this write are computed once
        per call (one for each prefix layer, one per slot) and shared by
        its layers; a Mamba cache has neither positions nor cursor."""
        b, s = x.shape[:2]
        aux = 0.0

        def ring(kind, sc, cap_dim):
            if kind != "attn":
                return None
            return L.cache_positions(sc, sc.index + s, b, x.device, cap_dim)
        prefix = []
        for i, (kind, is_moe) in enumerate(self.prefix_slots):
            c = caches["prefix"][i] if caches else None
            x, nc, a = self._apply_block(kind, is_moe,
                                         params["prefix_layers"][i], x,
                                         positions, c,
                                         ring(kind, c, 1) if caches else None,
                                         collect_aux)
            prefix.append(nc)
            if collect_aux:
                aux = aux + a
        rings = [ring(kind, sc, 2) for (kind, _), sc in
                 zip(self.slots, caches["slots"])] if caches else None
        stacks = [_stacked(lp) for lp in params["layers"]]
        for r in range(self.n_reps):
            for si, (kind, is_moe) in enumerate(self.slots):
                c = rg = None
                if caches:
                    c, rg = _slot_view(caches["slots"][si], r), rings[si]
                x, _, a = self._apply_block(
                    kind, is_moe, _at(stacks[si], r), x,
                    positions, c, rg, collect_aux)
                if collect_aux:
                    aux = aux + a
        if not caches:
            return x, None, aux
        slots = [dataclasses.replace(sc, index=sc.index + s)
                 if isinstance(sc, L.KVCache) else sc
                 for sc in caches["slots"]]
        return x, {"prefix": prefix, "slots": slots}, aux

    # ------------------------------------------------------------------
    def encode(self, params, frames):
        """Whisper's encoder: the stub frontend's frame embeddings [B, Se,
        d] -> enc_out [B, Se, d] in the model dtype. `frame_proj`, then
        each of the `[n_enc_layers]` stacked layers (attention with RoPE
        at positions 0..Se-1, non-causal and without a window, then the
        MLP), then `enc_ln_f`. In `spmd.run` (`frames` the point's rows)
        `frame_proj` projects as `_stub_proj` does and the layers run on
        the point's heads and hidden units, as the decoder's do."""
        cfg = self.cfg
        x = _stub_proj(params["frame_proj"], frames.to(cfg.dtype))
        b, se, _ = x.shape
        pos = torch.arange(se, dtype=torch.int32,
                           device=x.device)[None].expand(b, se)
        enc = dataclasses.replace(cfg.attn, causal=False,
                                  sliding_window=None)
        for r in range(cfg.n_enc_layers):
            lp = _at(params["encoder"], r)
            x, _ = L.attention(lp["mixer"], x, enc, pos, None,
                               norm_kind=cfg.norm)
            x = L.mlp(lp["ffn"], x, cfg.act, norm_kind=cfg.norm)
        return L.norm(x, params["enc_ln_f"], cfg.norm)

    def backbone_with_cross(self, params, x, positions, enc_out,
                            caches=None):
        """Whisper's decoder stack: each layer's block (self-attention,
        its ring cache written when `caches` is given, then the MLP),
        then that layer's cross-attention over `enc_out`. The ring's
        positions after this write are computed once a call. Returns (x,
        caches with the cursor moved on, the Python 0.0)."""
        cfg = self.cfg
        b, s = x.shape[:2]
        sc = caches["slots"][0] if caches else None
        ring = L.cache_positions(sc, sc.index + s, b, x.device, 2) \
            if caches else None
        for r in range(self.n_reps):
            c = _slot_view(sc, r) if caches else None
            x, _, _ = self._apply_block("attn", False,
                                        _at(params["layers"][0], r), x,
                                        positions, c, ring)
            x = L.cross_attention(_at(params["cross"], r), x, enc_out,
                                  cfg.attn, norm_kind=cfg.norm)
        if not caches:
            return x, None, 0.0
        return x, {"prefix": [], "slots": [
            dataclasses.replace(sc, index=sc.index + s)]}, 0.0

    # ------------------------------------------------------------------
    def embed_inputs(self, params, batch: Batch):
        """Token embeddings; under the vision stub, the patch embeddings
        `batch.extra` [B, P, d] projected by `patch_proj` (`_stub_proj`,
        sharded in `spmd.run`) go first."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch.tokens)
        if cfg.frontend == "vision_stub" and batch.extra is not None:
            x = torch.cat([_stub_proj(params["patch_proj"],
                                      batch.extra.to(cfg.dtype)), x], dim=1)
        return x

    def _head(self, params):
        """(the LM head [d, V] as this point uses it, the axes its
        vocabulary is split over): in `spmd.run` its FSDP rows gathered,
        its columns the point's share of the vocabulary."""
        if self.cfg.tie_embeddings:
            table = SP.whole(params["embed"], "data")
            return table.T, SP.split_axes(table, 0)
        w = SP.whole(params["unembed"], "data")
        return w, SP.split_axes(w, 1)

    def hidden_to_logits(self, params, h):
        """f32 logits; in `spmd.run` the LM head's FSDP rows gathered and
        the local vocabulary columns' logits all-gathered over the
        vocabulary's axes."""
        return _logits(h, *self._head(params))

    # ------------------------------------------------------------------
    def loss(self, params, batch: Batch, loss_chunk: int = 2048):
        """Token-mean cross entropy (targets -1 carry no loss) over
        `loss_chunk`-token chunks of the flattened batch — the tokens
        past the last whole chunk are dropped, as the reference's — plus
        0.01 times the MoE auxiliary loss. A scalar f32 tensor. Whisper:
        `batch.extra` is the encoder's frame embeddings; llava: the patch
        embeddings, prepended, whose positions carry no loss.

        In `spmd.run` (each point its rows of the batch) the loss is the
        global batch's, the same on every point: the chunks are cut from
        the global flattened batch as above (a point's rows are its
        range of it), each point's NLL sum and count of targets are
        all-reduced over the batch's axes, and the MoE's auxiliary loss
        is the global batch's (`layers.moe_aux_loss`)."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device)[None].expand(b, s)
        if cfg.n_enc_layers:
            x, _, aux = self.backbone_with_cross(
                params, x, pos, self.encode(params, batch.extra))
        else:
            x, _, aux = self.backbone(params, x, pos, None,
                                      collect_aux=cfg.moe is not None)
        x = L.norm(x, params["ln_f"], cfg.norm)
        targets = batch.targets
        if cfg.frontend == "vision_stub" and batch.extra is not None:
            targets = torch.cat([targets.new_full(
                (b, batch.extra.shape[1]), -1), targets], dim=1)
        t = b * s
        xf = x.reshape(t, cfg.d_model)
        tf = targets.reshape(t)
        axes = SP.batch_axes()
        ways = SP.context().size(axes) if axes else 1
        nchunk = max(1, t * ways // max(loss_chunk, 1))
        csize = t * ways // nchunk

        def cuts(start):
            """The chunk bounds of the tokens at `start` of the global
            flattened batch: those before the end of the last whole
            chunk, cut where the global chunks are."""
            keep = min(max(nchunk * csize - start, 0), t)
            return [0] + [c * csize - start for c in range(1, nchunk)
                          if 0 < c * csize - start < keep] + [keep]
        # every point runs as many chunks (each chunk's collectives are a
        # rendezvous of the whole mesh): empty ones where it has fewer
        mine = cuts(SP.batch_offset() * t)
        most = max(len(cuts(i * t)) for i in range(ways))
        mine += mine[-1:] * (most - len(mine))
        w, vocab = self._head(params)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo, hi in zip(mine[:-1], mine[1:]):
            xc, tc = xf[lo:hi], tf[lo:hi]
            if torch.is_grad_enabled():
                nll = torch.utils.checkpoint.checkpoint(
                    _chunk_nll, xc, w, vocab, tc, use_reentrant=False)
            else:
                nll = _chunk_nll(xc, w, vocab, tc)
            total = total + nll
            count = count + (tc >= 0).sum()
        if axes:
            sums = SP.all_reduce(torch.stack([total, count.float()]), axes)
            total, count = sums[0], sums[1]
        return total / torch.clamp(count, min=1) + 0.01 * aux

    # ------------------------------------------------------------------
    def prefill(self, params, batch: Batch, cap: int):
        """Run the full prompt (after the patches, under the vision
        stub), returning (last-token logits, caches). Whisper encodes
        `batch.extra` here."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        b, s, _ = x.shape
        caches = self.init_cache(b, cap, x.device)
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device)[None].expand(b, s)
        if cfg.n_enc_layers:
            x, caches, _ = self.backbone_with_cross(
                params, x, pos, self.encode(params, batch.extra), caches)
        else:
            x, caches, _ = self.backbone(params, x, pos, caches)
        x = L.norm(x, params["ln_f"], cfg.norm)
        return self.hidden_to_logits(params, x[:, -1:]), caches

    def decode_step(self, params, tokens, caches, position: int,
                    enc_out=None):
        """One token step. tokens [B, 1]; position a host int (past the
        patches, under the vision stub); whisper's `enc_out` from
        `encode`."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        b = x.shape[0]
        pos = torch.full((b, 1), int(position), dtype=torch.int32,
                         device=x.device)
        if cfg.n_enc_layers:
            x, caches, _ = self.backbone_with_cross(params, x, pos, enc_out,
                                                    caches)
        else:
            x, caches, _ = self.backbone(params, x, pos, caches)
        x = L.norm(x, params["ln_f"], cfg.norm)
        return self.hidden_to_logits(params, x), caches


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

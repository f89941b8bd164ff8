"""Oracle for the flash-attention kernel: dense fp32-softmax SDPA, and
the one mask every attention path of the port builds.

`sdpa_ref` is also the model's dense attention (`layers._sdpa_dense`)
and `masked_logits` the score block of its chunked path: causal +
sliding window + kv-validity masking over GQA-expanded inputs, f32
logits, masked entries set to -1e30, the softmax cast to q's dtype
before the product with v. A row with no valid key averages v over all
Skv keys.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def attend_mask(q_pos, kv_pos, kv_valid, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """[B, Sq, Skv] bool: key j is valid and, if `causal`, not after
    query i, and, with a `window`, fewer than `window` positions before
    it."""
    mask = kv_valid[:, None, :].expand(-1, q_pos.shape[1], -1)
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return mask


def masked_logits(q, k, q_pos, kv_pos, kv_valid, *, causal: bool,
                  window: Optional[int]) -> torch.Tensor:
    """f32 q.k / sqrt(d) over [B,H,Sq,Skv] with masked entries -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    mask = attend_mask(q_pos, kv_pos, kv_valid, causal=causal,
                       window=window)
    return torch.where(mask[:, None], logits, NEG)


def sdpa_ref(q, k, v, q_pos, kv_pos, kv_valid, *, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """q [B,Sq,H,D], k [B,Skv,H,D], v [B,Skv,H,Dv] (pre-expanded heads;
    the scale is 1/sqrt(D) whatever Dv is). Returns [B,Sq,H,Dv]."""
    logits = masked_logits(q, k, q_pos, kv_pos, kv_valid, causal=causal,
                           window=window)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)

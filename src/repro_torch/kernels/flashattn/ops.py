"""Flash attention (K8): the public `flash_attention`, its launch wrapper
and its plain torch version `flash_plain`.

`flash_attention` takes the reference's layout: q [B, Sq, H, D], k
[B, Skv, KVH, D] and v [B, Skv, KVH, Dv] with KVH dividing H (GQA) and
Dv <= D, q_pos [B, Sq] and kv_pos / kv_valid [B, Skv]; it returns
[B, Sq, H, Dv] in q's dtype, with scores scaled by 1/sqrt(D). A Dv below
D is MLA's call (q/k 192 = 128 + 64 RoPE dims, v 128): the reference pads
v with zeros to D and slices the output back to Dv, which gives exactly
this. On a CUDA tensor it launches the hand-written kernel of
`csrc/flashattn.cu` on the current stream (the decode variant when
Sq == 1, else the prefill variant), reading q, k and v through their
strides, and raises on what the kernel does not take (any dtype but
bf16, a (D, Dv) pair other than those of `HEAD_DIMS`): it never runs the
plain version there. The prefill variant
loads q, k and v by TMA through tensor maps over those strides (hence
the 16-byte alignment and strides in multiples of 8 elements the checks
ask for), runs `wgmma` on 128-row q-tiles, and skips the 128-key tiles
that no row of a q-tile may see; a row that sees no key at all makes
its q-tile run again over every key. The decode variant splits the
cache over CTAs for one (kv head, batch) each (the kernel picks the
splits; `flash_decode_splits` says how many); each walks its tiles with
an online softmax, skipping those it may not see, and writes its partial
state to f32 scratch taken here with `torch.empty`; the last CTA of a
(kv head, batch), found by a ticket on an int32 counter, merges them in
the same launch. The counters live in a zeroed buffer kept per (device,
stream), so calls on different streams never share one (the points of a
sharded run on one card each run on a stream of their own); the kernel
sets each counter it used back to 0, and the buffers are grown under a
lock. On a CPU tensor it runs `flash_plain`,
the same online-softmax algorithm in torch over 128-row Q and KV blocks,
at every Sq — the port's counterpart of running the reference's Pallas
kernel in interpret mode. Any other device raises.

Numerics (both versions, as the TPU kernel): scores are the f32 dot
times 1/sqrt(D); masked entries are -1e30 and the running max starts at
-1e30; p is rounded to v's dtype before the P.V product; o and l
accumulate in f32; the finish is o / max(l, 1e-30), cast to q's dtype.
Keys past Skv take no part (nothing is padded), so a row with no valid
key averages v over the Skv keys, as `ref.sdpa_ref` does.

`return_lse=True` (decode, Sq == 1) also returns each row's log-sum-exp
[B, H] f32, m + log(l) of the online softmax: the log of the row's sum
of exp(score) over the keys it may see, -inf where it may see none
(whatever its output, the mean of v above). A caller that cut the cache
into slot ranges merges the ranges' outputs o_r by the weights
exp(lse_r - max_r lse_r) (`merge_partials`): a range with no valid key
carries weight 0. The output stays in q's dtype.

`LAUNCHES` counts kernel launches per variant (bumped under a lock, only
where a kernel is launched).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import LaunchCounts, check, library
from repro_torch.kernels.flashattn.ref import NEG, attend_mask

BLOCK = 128
#: the (q/k, v) head sizes the CUDA kernel is compiled for
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
#: the most query heads per kv head the decode variant serves
#: (`kMaxGroup` in csrc/flashattn.cu)
MAX_GROUP = 16

LAUNCHES = LaunchCounts("flash_prefill", "flash_decode")

_LIB: Optional[ctypes.CDLL] = None
#: the decode variant's ticket counters, one int32 per (batch, kv head),
#: zeroed, per (device index, stream handle); grown by a fresh
#: `torch.zeros` only when a call has more groups
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = library("flashattn")
        common = [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.flash_prefill.argtypes = common + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.flash_prefill.restype = ctypes.c_int
        lib.flash_decode.argtypes = common + [ctypes.c_int] * 9 + [
            ctypes.c_float] + [ctypes.c_void_p] * 4
        lib.flash_decode.restype = ctypes.c_int
        lib.flash_decode_splits.argtypes = [ctypes.c_int] * 3
        lib.flash_decode_splits.restype = ctypes.c_int
        lib.flash_prefill_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_prefill_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def reset_launches() -> None:
    LAUNCHES.reset()


def prefill_smem_bytes(d: int, dv: int) -> int:
    """Shared memory (static and dynamic bytes) one CTA of the prefill
    kernel takes at head sizes (`d`, `dv`)."""
    return int(_lib().flash_prefill_smem_bytes(d, dv))


def flash_decode_splits(b: int, kvh: int, skv: int) -> int:
    """Splits of the decode kernel's grid over the cache for B `b`, `kvh`
    kv heads and `skv` slots (the rule in csrc/flashattn.cu's note)."""
    return int(_lib().flash_decode_splits(b, kvh, skv))


def _check_shapes(q, k, v, q_pos, kv_pos, kv_valid) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or v.shape[3] > k.shape[3]:
        raise ValueError("q must be [B,Sq,H,D], k [B,Skv,KVH,D] and v "
                         "[B,Skv,KVH,Dv] with Dv <= D")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (KVH must divide H)")
    skv = k.shape[1]
    if tuple(q_pos.shape) != (b, sq):
        raise ValueError(f"q_pos must be [{b}, {sq}]")
    if tuple(kv_pos.shape) != (b, skv) or tuple(kv_valid.shape) != (b, skv):
        raise ValueError(f"kv_pos and kv_valid must be [{b}, {skv}]")


def _check_lse(q, return_lse: bool) -> None:
    if return_lse and q.shape[1] != 1:
        raise ValueError("flash_attention returns the log-sum-exp for a "
                         "decode call (Sq == 1) only")


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention output over a cache cut into slot ranges, from the
    ranges' outputs `o` [n, ..., H, Dv] and log-sum-exps `lse` [n, ...,
    H]: sum_r w_r o_r / sum_r w_r in f32 with w_r = exp(lse_r - max_r
    lse_r), a range whose lse is -inf weighing 0; f32. A row whose every
    range is -inf (no valid key anywhere) comes out 0."""
    o = o.float()
    top = lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - top)
    return (w[..., None] * o).sum(0) / torch.clamp(w.sum(0), min=1e-30)[
        ..., None]


def flash_plain(q, k, v, q_pos, kv_pos, kv_valid, *, causal: bool = True,
                window: Optional[int] = None, return_lse: bool = False):
    """Plain torch K8: the kernel's online softmax over 128-row Q and KV
    blocks (the last block of each is ragged, not padded). With
    `return_lse` (Sq == 1) also each row's log-sum-exp [B, H] f32."""
    _check_shapes(q, k, v, q_pos, kv_pos, kv_valid)
    _check_lse(q, return_lse)
    b, sq, h, d = q.shape
    dv = v.shape[3]
    skv, rep = k.shape[1], h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qh = q.permute(0, 2, 1, 3)                       # [B,H,Sq,D]
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if rep > 1:                                      # jnp.repeat(k, rep, 2)
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    out = q.new_empty((b, sq, h, dv))
    lse = None
    for i in range(0, sq, BLOCK):
        qb = qh[:, :, i:i + BLOCK].float()
        qp = q_pos[:, i:i + BLOCK]
        m = torch.full(qb.shape[:3], NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*qb.shape[:3], dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, skv, BLOCK):
            s = (qb @ kh[:, :, j:j + BLOCK].float().transpose(-1, -2)) * scale
            mask = attend_mask(qp, kv_pos[:, j:j + BLOCK],
                               kv_valid[:, j:j + BLOCK], causal=causal,
                               window=window)
            s = torch.where(mask[:, None], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + (
                p.to(v.dtype).float() @ vh[:, :, j:j + BLOCK].float())
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, i:i + BLOCK] = res.to(q.dtype).permute(0, 2, 1, 3)
        if return_lse:              # m stays NEG where no key is allowed
            lse = torch.where(m > NEG, m + torch.log(l), -math.inf)[..., 0]
    return (out, lse) if return_lse else out


def _decode_tickets(dev: torch.device, stream: int,
                    groups: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _TICKETS_LOCK:
        t = _TICKETS.get(key)
        if t is None or t.numel() < groups:
            t = torch.zeros(groups, dtype=torch.int32, device=dev)
            _TICKETS[key] = t
    return t


def _kernel_checks(q, k, v, dev) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention's CUDA kernel takes bf16, "
                             f"got {name} {t.dtype}")
        if t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a dense head dimension, strides "
                             f"in multiples of 8 and 16-byte alignment")
    dims = (q.shape[3], v.shape[3])
    if dims not in HEAD_DIMS:
        raise ValueError(f"flash_attention's CUDA kernel takes (head_dim, "
                         f"v head_dim) in {HEAD_DIMS}, got {dims}")


def flash_attention(q, k, v, q_pos, kv_pos, kv_valid, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """K8. q [B,Sq,H,D]; k [B,Skv,KVH,D], v [B,Skv,KVH,Dv] (KVH | H,
    Dv <= D); positions [B,S*]. Returns [B,Sq,H,Dv]; with `return_lse`
    (Sq == 1), (that, the rows' log-sum-exp [B, H] f32).

    K8 has no backward: under grad mode with an input that requires
    grad it raises (the kernel's output would leave the graph and the
    inputs get no gradient); run such a pass on the "auto" attention
    backend (`models.layers.attention_backend`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: its output would carry no "
            "gradient to q, k, v; run training on the 'auto' attention "
            "backend")
    _check_shapes(q, k, v, q_pos, kv_pos, kv_valid)
    _check_lse(q, return_lse)
    dev = q.device
    if dev.type == "cpu":
        return flash_plain(q, k, v, q_pos, kv_pos, kv_valid, causal=causal,
                           window=window, return_lse=return_lse)
    if dev.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {dev}")
    _kernel_checks(q, k, v, dev)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq == 1 and h // kvh > MAX_GROUP:
        raise ValueError(f"flash_attention's decode kernel takes at most "
                         f"{MAX_GROUP} query heads per kv head")
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos),
                    ("kv_valid", kv_valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    kv_valid = kv_valid.to(torch.bool).contiguous()
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in range(3)])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), kv_valid.data_ptr(),
            strides)
    flags = (int(causal), int(window is not None),
             0 if window is None else int(window))
    scale = ctypes.c_float(1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if sq == 1:
        splits = flash_decode_splits(b, kvh, skv)
        scratch = torch.empty(b * h * splits * (dv + 2),
                              dtype=torch.float32, device=dev)
        tickets = _decode_tickets(dev, stream, b * kvh)
        err = lib.flash_decode(*ptrs, b, skv, h, kvh, d, dv, *flags, scale,
                               None if lse is None else lse.data_ptr(),
                               scratch.data_ptr(), tickets.data_ptr(),
                               stream)
        check(err, "flash_decode")
        LAUNCHES.bump("flash_decode")
    else:
        err = lib.flash_prefill(*ptrs, b, sq, skv, h, kvh, d, dv, *flags,
                                scale, stream)
        check(err, "flash_prefill")
        LAUNCHES.bump("flash_prefill")
    return (out, lse) if return_lse else out

"""Attention in plain PyTorch (the port's ``src/repro/models/attention.py``).

* ``flash_attention``: chunked online softmax over KV blocks; the
  (Sq, Skv) score matrix never materializes beyond one (Sq, chunk) block.
  It is the plain path of the model (``impl="plain"``); the CUDA kernel
  ``kernels/flash_attention`` is the path on the card.
* ``attention_reference``: the unchunked O(S^2) oracle, the plain version
  the kernel is held against.
* ``decode_attention``: one query token against a full cache.

Shapes follow the (B, S, H, D) convention with grouped KV heads:
q: (B, Sq, H, D);  k, v: (B, Skv, KV, D);  H % KV == 0.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.ctx import constrain

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - kv_pos[None, :] < window
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Chunked attention with online softmax over KV blocks.

    Queries sit at absolute positions ``q_offset + [0..Sq)``, keys at
    ``[0..Skv)``.  ``Skv`` must be a multiple of ``min(chunk, Skv)``.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    chunk = min(chunk, Skv)
    assert Skv % chunk == 0, (Skv, chunk)
    scale = D ** -0.5

    qf = (q * scale).float().reshape(B, Sq, KV, G, D)
    # the JAX package's layout hints: on a mesh the model calls this on each
    # rank's own sequences and heads (transformer._attention_mesh), plain
    # tensors, which constrain passes through
    qf = constrain(qf, ("batch", None, None, None, None))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    bkg = ("batch", None, None, None)
    m = constrain(torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                             device=q.device), bkg)
    l = constrain(torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device), bkg)
    acc = constrain(torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device),
                    bkg + (None,))
    for start in range(0, Skv, chunk):
        kc = constrain(k[:, start:start + chunk].float(), ("batch", None, None, None))
        vc = constrain(v[:, start:start + chunk].float(), ("batch", None, None, None))
        kv_pos = start + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kc)
        msk = _mask(q_pos, kv_pos, causal, window)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B, KV, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Unchunked O(S^2) oracle: the plain version of the attention kernel."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qf = (q * D ** -0.5).float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k.float())
    msk = _mask(q_offset + torch.arange(Sq, device=q.device),
                torch.arange(Skv, device=q.device), causal, window)
    s = torch.where(msk, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _decode_scores(qf: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, Sq, S) float32 scores of ``qf`` (B, Sq, KV, G, D) against the
    cache (B, S, KV, D), both in the cache's dtype.  On CUDA with a 16-bit
    cache: one ``bmm`` per sequence with float32 accumulation and a float32
    result (``out_dtype``), reading the cache in place (its (KV, D, S) view
    is a strided batch cuBLAS takes as is); elsewhere the widened einsum."""
    if not _half_on_cuda(k_cache):
        return torch.einsum("bqkgd,bskd->bkgqs", qf.float(), k_cache.float())
    B, S, KV, D = k_cache.shape
    Sq, G = qf.shape[1], qf.shape[3]
    q = qf.permute(0, 2, 3, 1, 4).reshape(B, KV, G * Sq, D)
    s = torch.empty((B, KV, G * Sq, S), dtype=torch.float32, device=k_cache.device)
    for b in range(B):
        torch.bmm(q[b], k_cache[b].permute(1, 2, 0), out_dtype=torch.float32, out=s[b])
    return s.view(B, KV, G, Sq, S)


def _decode_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, Sq, D) float32 of the probabilities ``p`` (B, KV, G, Sq, S),
    already in the cache's dtype, against v (B, S, KV, D), as
    ``_decode_scores`` reads k."""
    if not _half_on_cuda(v_cache):
        return torch.einsum("bkgqs,bskd->bkgqd", p.float(), v_cache.float())
    B, S, KV, D = v_cache.shape
    G, Sq = p.shape[2], p.shape[3]
    pr = p.reshape(B, KV, G * Sq, S)
    out = torch.empty((B, KV, G * Sq, D), dtype=torch.float32, device=v_cache.device)
    for b in range(B):
        torch.bmm(pr[b], v_cache[b].permute(1, 0, 2), out_dtype=torch.float32, out=out[b])
    return out.view(B, KV, G, Sq, D)


def _half_on_cuda(cache: torch.Tensor) -> bool:
    return cache.is_cuda and cache.dtype in (torch.bfloat16, torch.float16)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     window: int = 0, valid_len=None) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) against a full cache (B, S, KV, D).

    ``valid_len`` (int or (B,)) masks cache rows ``>= valid_len``;
    ``window`` masks a linear-layout cache to its trailing window.  As in
    the JAX package the query is rounded to the cache's dtype and the
    probabilities to v's dtype, and both products accumulate in float32
    (``preferred_element_type=float32``) with the cache read in its own
    dtype: on the card a bf16 cache is never copied; on the CPU, the plain
    version, the rows are widened to float32 (exact for bf16).
    """
    B, Sq, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qf = (q * D ** -0.5).to(k_cache.dtype).reshape(B, Sq, KV, G, D)
    s = _decode_scores(qf, k_cache)
    pos = torch.arange(S, device=q.device)
    if window > 0:
        ok = pos >= (S - window)  # query sits at position S-1
        s = torch.where(ok, s, NEG_INF)
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=q.device).expand(B)
        ok = pos[None, :] < vl[:, None]  # (B, S)
        s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _decode_values(p.to(v_cache.dtype), v_cache)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_parts(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           ok: torch.Tensor, reduce) -> torch.Tensor:
    """``decode_attention`` over a cache whose rows are split across ranks:
    q (B, 1, H, D) against this rank's rows (B, S_loc, KV, D), ``ok``
    (B, S_loc) its valid rows, and ``reduce(t, op)`` a float32 tensor
    reduced ("max" / "sum") over the ranks that split the rows.  The max
    and the softmax's sum are taken over every rank's rows, so each rank's
    probabilities are the single-cache ones (rounded to v's dtype as
    there), and the ranks' ``p @ V`` partial sums add up in float32."""
    B, Sq, H, D = q.shape
    KV = k_cache.shape[2]
    qf = (q * D ** -0.5).to(k_cache.dtype).reshape(B, Sq, KV, H // KV, D)
    s = torch.where(ok[:, None, None, None, :], _decode_scores(qf, k_cache), NEG_INF)
    e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
    p = e / reduce(e.sum(dim=-1, keepdim=True), "sum")
    out = reduce(_decode_values(p.to(v_cache.dtype), v_cache), "sum")
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)

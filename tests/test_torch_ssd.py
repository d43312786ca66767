"""The port's SSD scan against the JAX package's, on the CPU.

Same inputs (numpy, seeded) through both packages: ``ssd_chunked``,
``ssd_sequential`` and ``ssd_decode_step`` against the JAX references, and
the kernel wrapper (its plain version on the CPU) against the JAX Pallas
wrapper in interpret mode, on the sweep shapes of ``tests/test_kernels.py``
plus S=96 (one chunk of 96, which the model's ``chunk=min(128, S)`` gives).
Tolerances: 1e-4 absolute in float32 as the JAX kernel tests hold theirs,
plus 1e-5 of the output's largest magnitude (y reaches ~200 at N=128).
The extra term is the cumsum: XLA on the CPU does not add the chunk's
log-decays in sequence as torch does, so cum (tens to hundreds in size)
differs by a few float32 ulps in many entries, and every decay factor
exp(cum_i - cum_j) by that relative amount.  bf16 inputs: 2e-2 (one bf16
rounding of y).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref

SWEEP = [  # tests/test_kernels.py:70-75, plus one chunk of 96 rows
    (2, 256, 4, 64, 128, 128),
    (1, 128, 8, 32, 64, 32),
    (2, 64, 2, 16, 32, 64),
    (1, 512, 4, 64, 128, 128),
    (1, 96, 4, 16, 32, 128),
]


def _inputs(seed, B, S, H, P, N, G=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _j(xs, dtype=jnp.float32):
    return [jnp.asarray(x).astype(dtype) if x.ndim > 1 else jnp.asarray(x) for x in xs]


def _t(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) if x.ndim > 1 else torch.from_numpy(x)
            for x in xs]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(actual, desired):
    a, d = _np(actual), _np(desired)
    np.testing.assert_allclose(a, d, rtol=0, atol=1e-4 + 1e-5 * np.abs(d).max())


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ssd_chunked_matches_reference_package(B, S, H, P, N, chunk):
    ins = _inputs(S + P + N, B, S, H, P, N)
    x, dt, A, Bm, Cm = ins
    jx, jdt, jA, jB, jC = _j([x, dt]) + [jnp.asarray(A)] + _j([Bm, Cm])
    tx, tdt, tA, tB, tC = _t([x, dt]) + [torch.from_numpy(A)] + _t([Bm, Cm])
    y_r, h_r = jref.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk)
    y_t, h_t = tref.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk)
    _close(y_t, y_r)
    _close(h_t, h_r)
    # the kernel wrapper (plain version on the CPU) against the Pallas
    # kernel in interpret mode
    y_p, h_p = jops.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk)
    y_w, h_w = tops.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk)
    _close(y_w, y_p)
    _close(h_w, h_p)


def test_ssd_bf16_inputs_match_reference_package():
    x, dt, A, Bm, Cm = _inputs(7, 1, 256, 4, 16, 32)
    jy, jh = jref.ssd_chunked(*_j([x], jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
                              *_j([Bm, Cm], jnp.bfloat16))
    ty, th = tops.ssd_chunked(*_t([x], torch.bfloat16), torch.from_numpy(dt),
                              torch.from_numpy(A), *_t([Bm, Cm], torch.bfloat16))
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    _close(th, jh)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-2, atol=2e-2)


def test_ssd_sequential_and_h0_match_reference_package():
    B, S, H, P, N, G = 2, 64, 4, 8, 16, 2
    x, dt, A, Bm, Cm = _inputs(3, B, S, H, P, N, G)
    h0 = np.random.default_rng(4).standard_normal((B, H, N, P)).astype(np.float32)
    ys, hs = jref.ssd_sequential(*_j([x, dt]), jnp.asarray(A), *_j([Bm, Cm]),
                                 h0=jnp.asarray(h0))
    yt, ht = tref.ssd_sequential(*_t([x, dt]), torch.from_numpy(A), *_t([Bm, Cm]),
                                 h0=torch.from_numpy(h0))
    _close(yt, ys)
    _close(ht, hs)
    yc, hc = tref.ssd_chunked(*_t([x, dt]), torch.from_numpy(A), *_t([Bm, Cm]),
                              h0=torch.from_numpy(h0), chunk=16)
    np.testing.assert_allclose(_np(yc), _np(ys), atol=2e-3)  # chunked vs sequential
    np.testing.assert_allclose(_np(hc), _np(hs), atol=2e-3)


def test_ssd_decode_steps_match_reference_package_and_scan():
    B, S, H, P, N = 1, 16, 2, 8, 16
    x, dt, A, Bm, Cm = _inputs(5, B, S, H, P, N)
    hj = jnp.zeros((B, H, N, P), jnp.float32)
    ht = torch.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        yj, hj = jref.ssd_decode_step(jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
                                      jnp.asarray(A), jnp.asarray(Bm[:, t]),
                                      jnp.asarray(Cm[:, t]), hj)
        yt, ht = tref.ssd_decode_step(torch.from_numpy(x[:, t]), torch.from_numpy(dt[:, t]),
                                      torch.from_numpy(A), torch.from_numpy(Bm[:, t]),
                                      torch.from_numpy(Cm[:, t]), ht)
        _close(yt, yj)
        ys.append(yt)
    _close(ht, hj)
    yc, hc = tref.ssd_chunked(*_t([x, dt]), torch.from_numpy(A), *_t([Bm, Cm]), chunk=8)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(yc), atol=2e-3)
    np.testing.assert_allclose(_np(ht), _np(hc), atol=2e-3)


def test_ssd_wrapper_refuses_what_the_reference_package_refuses():
    x, dt, A, Bm, Cm = _inputs(6, 1, 200, 2, 8, 16)
    with pytest.raises(AssertionError):
        jref.ssd_chunked(*_j([x, dt]), jnp.asarray(A), *_j([Bm, Cm]), chunk=128)
    with pytest.raises(AssertionError):
        tops.ssd_chunked(*_t([x, dt]), torch.from_numpy(A), *_t([Bm, Cm]), chunk=128)


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (1, 128, 8, 32, 64, 32, torch.float32),
    (1, 96, 4, 16, 32, 128, torch.float32),
    (1, 256, 4, 16, 32, 128, torch.bfloat16),
])
def test_ssd_float64_scan_matches_reference_package(B, S, H, P, N, chunk, dtype):
    """The plain scan with ``compute_dtype=float64`` (chip_smoke.py's
    oracle for the float32 rounding of mamba2's prefill): y in x's dtype,
    the state in float64, both within the float32 tolerance of the JAX
    package's float32 scan, and the state closer to the recurrence run in
    float64 than the float32 scan's."""
    x, dt, A, Bm, Cm = _inputs(31, B, S, H, P, N)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jy, jh = jref.ssd_chunked(*_j([x], jdt), jnp.asarray(dt), jnp.asarray(A),
                              *_j([Bm, Cm], jdt), chunk=chunk)
    args = (*_t([x], dtype), torch.from_numpy(dt), torch.from_numpy(A),
            *_t([Bm, Cm], dtype))
    y64, h64 = tref.ssd_chunked(*args, chunk=chunk, compute_dtype=torch.float64)
    y32, h32 = tref.ssd_chunked(*args, chunk=chunk)
    assert y64.dtype == dtype and h64.dtype == torch.float64
    _close(h64, jh)
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(_np(y64), _np(jy), rtol=2e-2, atol=2e-2)
    else:
        _close(y64, jy)
    # the recurrence itself, in float64
    x_, dt_, A_, B_, C_ = (t.double() for t in args)
    h = torch.zeros((B, H, N, P), dtype=torch.float64)
    for t in range(S):
        h = (h * torch.exp(dt_[:, t] * A_)[..., None, None]
             + torch.einsum("bn,bh,bhp->bhnp", B_[:, t, 0], dt_[:, t], x_[:, t]))
    assert (h64 - h).abs().max() < (h32.double() - h).abs().max()


# ------------------------------------------- the CUDA kernel's arithmetic
# ``csrc/ssd_scan.cu`` runs every product on the tensor cores: bf16
# operands, float32 sums.  An operand that is float32 (L, B o w, h_in; and
# x, B, C for float32 inputs) goes in as a sum of bf16 terms, hi = bf16(v),
# lo = bf16(v - hi), ...; a product of two split operands keeps the term
# pairs (a, b) with a + b < the number of terms (hi.hi + hi.lo + lo.hi for
# two).  This emulation repeats that arithmetic with float32 matmuls of
# bf16-exact values (exact products, float32 sums, another summation order
# than the card's) so the number of terms is chosen here, before the card.
SPLIT_TERMS = 2
# chip_smoke.py's per-call margin: a scan's y may lie this much (of the
# call's largest |y|) further from the float64 scan than the plain scan's y
SSD_Y_MARGIN = 2.0 ** -7


def _terms(v, k):
    out, rest = [], v.float()
    for _ in range(k):
        hi = rest.to(torch.bfloat16).float()
        out.append(hi)
        rest = rest - hi
    return out


def _split_mm(eq, a_terms, b_terms):
    k = max(len(a_terms), len(b_terms))
    acc = None
    for ia, a in enumerate(a_terms):
        for ib, b in enumerate(b_terms):
            if ia + ib < k:
                part = torch.einsum(eq, a, b)
                acc = part if acc is None else acc + part
    return acc


def _emulate_kernel(x, dt, A, Bm, Cm, h0=None, *, chunk=128, terms=SPLIT_TERMS):
    """The kernel's chunked scan: chunk states h^T = (x o w)^T B, the state
    pass in float32, then per chunk y = exp(cum) o (C h_in) + L x with
    L = (C B^T) o exp(cum_i - cum_j) o dt_j (j <= i), every product of
    split operands as above.  bf16 x, B, C are exact operands."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    k_in = 1 if x.dtype == torch.bfloat16 else terms
    xs = _terms(x.reshape(Bsz, nc, Q, H, P), k_in)
    bs = _terms(Bm[:, :, 0].reshape(Bsz, nc, Q, N), k_in)
    cs = _terms(Cm[:, :, 0].reshape(Bsz, nc, Q, N), k_in)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtf * A.float(), dim=2)
    total = cum[:, :, -1]
    w = torch.exp(total[:, :, None] - cum) * dtf  # (B, nc, Q, H)
    xw = x.float().reshape(Bsz, nc, Q, H, P) * w[..., None]
    s_c = _split_mm("bcjhp,bcjn->bchpn", _terms(xw, terms), bs)  # h^T per chunk
    h = (torch.zeros((Bsz, H, P, N)) if h0 is None else h0.float().transpose(-1, -2))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + s_c[:, c]
    h_in = torch.stack(h_in, 1)  # (B, nc, H, P, N)
    cb = _split_mm("bcin,bcjn->bcij", cs, bs)
    y = _split_mm("bcin,bchpn->bcihp", cs, _terms(h_in, terms)) * torch.exp(cum)[..., None]
    li = torch.arange(Q)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    diff = torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf)
    L = cb[..., None] * torch.exp(diff) * dtf[:, :, None, :, :]  # (B, nc, Qi, Qj, H)
    y = y + _split_mm("bcijh,bcjhp->bcihp", _terms(L, terms), xs)
    return y.reshape(Bsz, S, H, P).to(x.dtype), h.transpose(-1, -2)


def _gap(y, y64):
    """max |y - y64| over the largest |y64|."""
    return float((y.double() - y64).abs().max() / y64.abs().max())


EMULATED = [  # B, S, H, P, N, chunk: N=128 (mamba2) and N=16 (jamba), ragged chunk
    (1, 256, 3, 16, 128, 128),
    (2, 256, 4, 16, 16, 128),
    (1, 96, 2, 16, 128, 128),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,P,N,chunk", EMULATED)
def test_kernel_emulation_within_the_float64_margin(B, S, H, P, N, chunk, dtype):
    """With the split of ``SPLIT_TERMS`` bf16 terms the kernel's
    arithmetic stays within the per-call margin of the float64 scan
    (``chip_smoke.py``'s check) and within the kernel's tolerances of the
    plain scan and of the JAX package's ``ssd_chunked``: float32 y within
    1e-4 of the output's scale (``chip_smoke.py``'s B4 cases; two terms
    read ~1e-5 of it, three ~4e-7, one ~5e-3), bf16 y within 2e-2, the
    state within 1e-4 of its scale."""
    x, dt, A, Bm, Cm = _inputs(B + S + N, B, S, H, P, N)
    h0 = np.random.default_rng(N).standard_normal((B, H, N, P)).astype(np.float32)
    args = (*_t([x], dtype), torch.from_numpy(dt), torch.from_numpy(A),
            *_t([Bm, Cm], dtype))
    for init in (None, torch.from_numpy(h0)):
        y, h = _emulate_kernel(*args, init, chunk=chunk)
        yp, hp = tref.ssd_chunked(*args, init, chunk=chunk)
        y64, h64 = tref.ssd_chunked(*(t.double() for t in args),
                                    None if init is None else init.double(),
                                    chunk=chunk, compute_dtype=torch.float64)
        assert y.dtype == dtype and h.dtype == torch.float32
        assert _gap(y, y64) - _gap(yp, y64) <= SSD_Y_MARGIN
        assert float((h.double() - h64).abs().max()) <= 1e-4 * max(1.0, float(h64.abs().max()))
        if dtype == torch.float32:
            scale = max(1.0, float(yp.abs().max()))
            assert float((y - yp).abs().max()) <= 1e-4 * scale
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jy, jh = jref.ssd_chunked(*_j([x], jdt), jnp.asarray(dt), jnp.asarray(A),
                              *_j([Bm, Cm], jdt), chunk=chunk)
    y, h = _emulate_kernel(*args, chunk=chunk)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(_np(jh)).max())))
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(_np(y), _np(jy), rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(_np(y), _np(jy), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(_np(jy)).max())))


@pytest.mark.parametrize("B,S,H,P,N,chunk", EMULATED[:2])
def test_kernel_emulation_with_one_bf16_term(B, S, H, P, N, chunk):
    """Why the split: with one bf16 term per float32 operand the float32
    scan misses its 1e-4 tolerance by far (~5e-3 of the output's scale),
    and the bf16 scan comes close: its y lies ~1.7e-3 of its largest |y|
    further from float64 than the plain scan's, a fifth of the per-call
    margin on its own, where two terms read as the plain scan within a
    hundredth of the margin."""
    x, dt, A, Bm, Cm = _inputs(B + S + N, B, S, H, P, N)
    a32 = (*_t([x]), torch.from_numpy(dt), torch.from_numpy(A), *_t([Bm, Cm]))
    yp, _ = tref.ssd_chunked(*a32, chunk=chunk)
    tol = 1e-4 * max(1.0, float(yp.abs().max()))
    assert float((_emulate_kernel(*a32, chunk=chunk, terms=1)[0] - yp).abs().max()) > 10 * tol
    assert float((_emulate_kernel(*a32, chunk=chunk)[0] - yp).abs().max()) <= tol
    a16 = (*_t([x], torch.bfloat16), torch.from_numpy(dt), torch.from_numpy(A),
           *_t([Bm, Cm], torch.bfloat16))
    y64, _ = tref.ssd_chunked(*(t.double() for t in a16), chunk=chunk,
                              compute_dtype=torch.float64)
    plain = _gap(tref.ssd_chunked(*a16, chunk=chunk)[0], y64)
    one = _gap(_emulate_kernel(*a16, chunk=chunk, terms=1)[0], y64) - plain
    two = _gap(_emulate_kernel(*a16, chunk=chunk)[0], y64) - plain
    print(f"extra gap to float64: one term {one:.3g}, two terms {two:.3g}")
    assert two <= SSD_Y_MARGIN / 100
    assert SSD_Y_MARGIN / 10 < one <= SSD_Y_MARGIN

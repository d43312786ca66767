"""Genetic algorithm (paper Sec. III-C), batched over independent searches.

pymoo-equivalent operators:
  * binary-tournament parent selection,
  * simulated binary crossover  (p_c = 0.95, eta = 3, the paper's values),
  * polynomial mutation         (p_m = 1/n_genes, eta = 3),
  * (mu + lambda) elitist survival,
with the population history (every sampled design + score, per
generation) returned, as the paper selects its best set from the stored
history.

Every tensor carries an explicit leading batch axis ``B``: B independent
GAs (per-workload searches, seeds, mixed requests) advance together, one
generation per loop iteration.  All randomness of a generation comes from
ONE uniform block per search, sliced at fixed offsets exactly as the JAX
package's ``core.ga._make_gen_step`` slices its block:

    tot = 2*n_contest + n_pairs*n + n_pairs + n_pairs*n + 2*P*n

The blocks are either given (``u_blocks (G, B, tot)``: the tests feed the
JAX package's own draws) or drawn up front, one ``(G, tot)`` call per
search from that search's ``torch.Generator``, so a search's stream does
not depend on which batch it ran in.

The evaluation callback ``eval_fn(genomes (B, P, n), ctx) -> (B, P)`` is a
parameter.  A callback may carry a ``gen_step`` attribute: a
whole-generation step for its ctx (the engine attaches the
``ga_gen_step`` kernel wrapper to its table-backend callback), which then
replaces the plain step below.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

SBX_PROB = 0.95
SBX_ETA = 3.0
MUT_ETA = 3.0
GENE_MAX = 1.0 - 1e-7  # genes live in [0, GENE_MAX]


class GAResult(NamedTuple):
    genomes: torch.Tensor  # (B, G+1, P, n) every generation incl. initial
    scores: torch.Tensor  # (B, G+1, P)
    best_genome: torch.Tensor  # (B, n)
    best_score: torch.Tensor  # (B,)


class BlockLayout(NamedTuple):
    """Offsets into one generation's uniform block."""

    n_pairs: int
    n_contest: int
    o_t: int  # end of tournament contestants
    o_u: int  # end of SBX spread u
    o_p: int  # end of SBX per-pair gate
    o_g: int  # end of SBX per-gene gate
    o_mu: int  # end of mutation u
    tot: int  # end of mutation per-gene gate == block length


def block_layout(pop_size: int, n_genes: int) -> BlockLayout:
    P, n = int(pop_size), int(n_genes)
    # odd P: select one extra pair and truncate the children back to P
    n_pairs = (P + 1) // 2
    n_contest = 2 * n_pairs
    o_t = 2 * n_contest
    o_u = o_t + n_pairs * n
    o_p = o_u + n_pairs
    o_g = o_p + n_pairs * n
    o_mu = o_g + P * n
    tot = o_mu + P * n
    return BlockLayout(n_pairs, n_contest, o_t, o_u, o_p, o_g, o_mu, tot)


def _pow_recip_eta1(x: torch.Tensor, eta: float) -> torch.Tensor:
    """``x ** (1 / (eta + 1))``; eta = 3 is two square roots."""
    if eta == 3.0:
        return torch.sqrt(torch.sqrt(x))
    return x ** (1.0 / (eta + 1.0))


def _pow_eta1(x: torch.Tensor, eta: float) -> torch.Tensor:
    """``x ** (eta + 1)``; eta = 3 is two multiplies."""
    if eta == 3.0:
        x2 = x * x
        return x2 * x2
    return x ** (eta + 1.0)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, n), idx (B, K) -> x[b, idx[b]] (B, K, n)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 -> total-order int32 (negative floats map to -magnitude,
    both zero signs to 0): ascending key order is ascending float order
    for every non-NaN value, and +inf stays below INT32_MAX."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def survivor_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) scores -> (B, k) indices of the k lowest, best first, ties by
    index: one sort of the unique int64 key ``okey * 2^32 + index``, so
    any correct sort gives the same permutation."""
    N = scores.shape[-1]
    iota = torch.arange(N, device=scores.device, dtype=torch.int64)
    key = order_keys(scores).to(torch.int64) * (1 << 32) + iota
    return torch.argsort(key, dim=-1)[..., :k]


def variation(pop: torch.Tensor, scores: torch.Tensor, u: torch.Tensor, *,
              sbx_prob: float = SBX_PROB, sbx_eta: float = SBX_ETA,
              mut_eta: float = MUT_ETA) -> torch.Tensor:
    """Tournament -> SBX -> polynomial mutation from the uniform block
    ``u (B, tot)``: returns children (B, P, n)."""
    B, P, n = pop.shape
    lay = block_layout(P, n)
    n_pairs, n_contest = lay.n_pairs, lay.n_contest
    # binary tournament: 2*n_pairs contests of 2 contestants each; an index
    # that rounds up to P takes the last slot, as the reference's clamped
    # gather does
    ti = (u[:, : lay.o_t] * P).to(torch.int64).clamp_max(P - 1)
    ca, cb = ti[:, :n_contest], ti[:, n_contest:]
    parents = torch.where(
        torch.gather(scores, 1, ca) <= torch.gather(scores, 1, cb), ca, cb)
    p1 = _rows(pop, parents[:, :n_pairs])
    p2 = _rows(pop, parents[:, n_pairs:])
    # SBX from the pre-drawn uniforms
    ub = u[:, lay.o_t: lay.o_u].reshape(B, n_pairs, n)
    beta = torch.where(
        ub <= 0.5,
        _pow_recip_eta1(2.0 * ub, sbx_eta),
        _pow_recip_eta1(torch.reciprocal(2.0 * (1.0 - ub)), sbx_eta),
    )
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    do_pair = u[:, lay.o_u: lay.o_p].reshape(B, n_pairs, 1) < sbx_prob
    do_gene = u[:, lay.o_p: lay.o_g].reshape(B, n_pairs, n) < 0.5
    use = do_pair & do_gene
    c1 = torch.clamp(torch.where(use, c1, p1), 0.0, GENE_MAX)
    c2 = torch.clamp(torch.where(use, c2, p2), 0.0, GENE_MAX)
    children = torch.cat([c1, c2], dim=1)[:, :P]
    # polynomial mutation
    um = u[:, lay.o_g: lay.o_mu].reshape(B, P, n)
    lo = children  # delta to bounds (range = 1)
    hi = 1.0 - children
    d1 = _pow_recip_eta1(
        2 * um + (1 - 2 * um) * _pow_eta1(1 - lo, mut_eta), mut_eta) - 1
    d2 = 1 - _pow_recip_eta1(
        2 * (1 - um) + (2 * um - 1) * _pow_eta1(1 - hi, mut_eta), mut_eta)
    delta = torch.where(um <= 0.5, d1, d2)
    do = u[:, lay.o_mu: lay.tot].reshape(B, P, n) < 1.0 / n
    return torch.clamp(torch.where(do, children + delta, children), 0.0, GENE_MAX)


def survive(pop, scores, children, child_scores):
    """(mu + lambda) elitist survival over the 2P candidates."""
    P = pop.shape[1]
    allg = torch.cat([pop, children], dim=1)
    alls = torch.cat([scores, child_scores], dim=1)
    idx = survivor_indices(alls, P)
    return _rows(allg, idx), torch.gather(alls, 1, idx)


def plain_gen_step(pop, scores, u, eval_fn, ctx, *, sbx_prob=SBX_PROB,
                   sbx_eta=SBX_ETA, mut_eta=MUT_ETA):
    """One generation in plain PyTorch.  Returns
    ``(new_pop, new_scores, children, child_scores)``."""
    children = variation(pop, scores, u, sbx_prob=sbx_prob,
                         sbx_eta=sbx_eta, mut_eta=mut_eta)
    child_scores = eval_fn(children, ctx)
    new_pop, new_scores = survive(pop, scores, children, child_scores)
    return new_pop, new_scores, children, child_scores


def make_gen_step(eval_fn: Callable, ctx, *, sbx_prob=SBX_PROB,
                  sbx_eta=SBX_ETA, mut_eta=MUT_ETA) -> Callable:
    """``gen(pop, scores, u) -> (new_pop, new_scores, children,
    child_scores)`` for this callback: its own whole-generation step when
    it carries one, else ``plain_gen_step``."""
    whole = getattr(eval_fn, "gen_step", None)
    kw = dict(sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta)
    if whole is not None:
        return lambda pop, scores, u: whole(pop, scores, u, ctx, **kw)
    return lambda pop, scores, u: plain_gen_step(pop, scores, u, eval_fn, ctx, **kw)


def draw_u_blocks(generators: Sequence[torch.Generator], generations: int,
                  tot: int, device) -> torch.Tensor:
    """(G, B, tot) uniform blocks: one (G, tot) draw per search from its
    own generator."""
    return torch.stack([
        torch.rand((int(generations), int(tot)), generator=g, device=device,
                   dtype=torch.float32)
        for g in generators
    ], dim=1)


def run_ga_batched(
    eval_fn: Callable,
    *,
    pop_size: int,
    generations: int,
    init_genomes: torch.Tensor,
    ctx: Any = None,
    u_blocks: Optional[torch.Tensor] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    sbx_prob: float = SBX_PROB,
    sbx_eta: float = SBX_ETA,
    mut_eta: float = MUT_ETA,
) -> GAResult:
    """B independent GAs.  ``init_genomes`` (B, P, n) (not modified);
    every leaf of ``ctx`` carries a leading B axis.  Randomness comes from
    ``u_blocks`` (G, B, tot) or, when absent, from one ``generators``
    entry per search.  Lower score = better."""
    B, P, n = init_genomes.shape
    if P != int(pop_size):
        raise ValueError(f"init_genomes holds {P} genomes, pop_size={pop_size}")
    G = int(generations)
    tot = block_layout(P, n).tot
    dev = init_genomes.device
    if u_blocks is None:
        if generators is None or len(generators) != B:
            raise ValueError("pass u_blocks (G, B, tot) or one generator per search")
        u_blocks = draw_u_blocks(generators, G, tot, dev)
    if tuple(u_blocks.shape) != (G, B, tot):
        raise ValueError(f"u_blocks must be {(G, B, tot)}, got {tuple(u_blocks.shape)}")
    u_blocks = u_blocks.to(device=dev, dtype=torch.float32)

    pop = init_genomes.to(torch.float32).clone()
    scores = eval_fn(pop, ctx)
    gen = make_gen_step(eval_fn, ctx, sbx_prob=sbx_prob, sbx_eta=sbx_eta,
                        mut_eta=mut_eta)
    hist_g, hist_s = [pop], [scores]
    for g in range(G):
        pop, scores, children, child_scores = gen(pop, scores, u_blocks[g])
        hist_g.append(children)
        hist_s.append(child_scores)
    genomes = torch.stack(hist_g, dim=1)  # (B, G+1, P, n)
    scores_h = torch.stack(hist_s, dim=1)  # (B, G+1, P)
    flat_s = scores_h.reshape(B, -1)
    best = torch.argmin(flat_s, dim=1)
    bidx = torch.arange(B, device=dev)
    return GAResult(
        genomes=genomes,
        scores=scores_h,
        best_genome=genomes.reshape(B, -1, n)[bidx, best],
        best_score=flat_s[bidx, best],
    )


def _add_batch(tree):
    if isinstance(tree, torch.Tensor):
        return tree.unsqueeze(0)
    if isinstance(tree, tuple):
        items = [_add_batch(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"ctx leaves must be tensors or tuples, got {type(tree)}")


def run_ga(
    eval_fn: Callable,
    *,
    pop_size: int,
    generations: int,
    init_genomes: torch.Tensor,
    ctx: Any = (),
    u_blocks: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sbx_prob: float = SBX_PROB,
    sbx_eta: float = SBX_ETA,
    mut_eta: float = MUT_ETA,
) -> GAResult:
    """One GA: ``run_ga_batched`` with B = 1.  ``init_genomes`` (P, n),
    ``ctx`` unbatched, ``u_blocks`` (G, tot) or ``generator``; every field
    of the result drops the batch axis."""
    res = run_ga_batched(
        eval_fn, pop_size=pop_size, generations=generations,
        init_genomes=init_genomes[None], ctx=_add_batch(ctx),
        u_blocks=None if u_blocks is None else u_blocks[:, None],
        generators=None if generator is None else [generator],
        sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta,
    )
    return GAResult(*(f[0] for f in res))


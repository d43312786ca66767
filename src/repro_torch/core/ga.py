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

Captured generations: a callback may declare a ``capture_plan``
(``CapturePlan``; the engine's dense and kernel callbacks do).  On CUDA
populations ``run_ga_batched_segment`` then replays its plain generation
from cached CUDA graphs over static buffers, in place of the step's ~190
small operator calls: one graph, or two around the plan's eager ``call``
(the ``imc_eval`` operator, which a device trace and the launch counter
see as themselves).  A shape is captured on its second sighting, the first
run eager (its warm-up); ``GRAPH_CACHE_KEYS`` shapes are kept, least
recently used first.  A replay runs the same kernels on the same inputs as
the eager step, so its bits are the eager step's.

Segments: ``GAState`` is the loop's carry as a value (population, scores,
the run's whole uniform stream and the generations applied), and
``run_ga_batched_segment`` advances it k generations.  The stream is drawn
once, at init, so a segment reads ``u[gen:gen + k]``: N segments of k
generations are the same calls on the same tensors as one run of N*k, bit
for bit, and a checkpointed state restores the same stream on any device.

The thin epilogue (``ga_epilogue_batched``) reduces a history on the
device to each search's best unique designs and its convergence curve, so
a launch brings back (B, K, n) genomes instead of (B, G+1, P, n).

Pareto-front search (NSGA-II, ``run_pareto_batched``) shares the variation
above and swaps the fitness plumbing: ``eval_fn`` returns (B, P, M)
objective vectors, survival keeps the 2P candidates' first P in crowded
order (non-domination rank, then crowding distance, then index: a unique
total order, ``_crowded_order``), and the tournament compares crowded
positions.  ``pareto_epilogue_batched`` picks each search's best front
members, one per decoded grid cell, over its whole history.  The front
peel syncs the host once every ``PEEL_BLOCK`` fronts, not once a front.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import space
from repro_torch.core.objectives import pareto_scalar

SBX_PROB = 0.95
SBX_ETA = 3.0
MUT_ETA = 3.0
GENE_MAX = 1.0 - 1e-7  # genes live in [0, GENE_MAX]


class GAResult(NamedTuple):
    genomes: torch.Tensor  # (B, G+1, P, n) every generation incl. initial
    scores: torch.Tensor  # (B, G+1, P)
    best_genome: torch.Tensor  # (B, n)
    best_score: torch.Tensor  # (B,)


class GAState(NamedTuple):
    """The GA loop's carry as a resumable value.  ``u`` is the run's whole
    uniform stream, drawn once at init; ``gen`` counts the generations
    applied (a host int).  Batched states carry a leading B axis on
    ``genomes`` and ``scores`` and hold ``u`` as (G, B, tot), the layout
    ``run_ga_batched`` takes."""

    genomes: torch.Tensor  # (B, P, n) current population
    scores: torch.Tensor  # (B, P)
    u: torch.Tensor  # (G, B, tot) every generation's uniform block
    gen: int  # generations completed so far


class GAThin(NamedTuple):
    """What a launch brings back instead of its history: per search the
    best ``min(top_k, (G+1)*P)`` designs that are unique by decoded grid
    cell, best first (rows past ``n_kept`` are padding: genome 0, score
    +inf), and the best-so-far score per generation."""

    top_genomes: torch.Tensor  # (B, K, n)
    top_scores: torch.Tensor  # (B, K)
    n_kept: torch.Tensor  # (B,) int64
    convergence: torch.Tensor  # (B, G+1)


class ParetoThin(NamedTuple):
    """``GAThin``'s twin for Pareto searches: per search the best
    ``min(top_k, unique feasible cells)`` front members in crowded order
    (ascending rank, descending crowding, flat history index), one per
    decoded grid cell, with their (E, L, A) vectors and their scalar E*L*A
    proxy (the ``ela`` bits); ``convergence`` is the running best proxy.
    Rows past ``n_kept`` are padding (genome 0, vector and score +inf)."""

    top_genomes: torch.Tensor  # (B, K, n)
    top_vectors: torch.Tensor  # (B, K, M)
    top_scores: torch.Tensor  # (B, K)
    n_kept: torch.Tensor  # (B,) int64
    convergence: torch.Tensor  # (B, G+1)


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


# --------------------------------------------- NSGA-II building blocks
PEEL_BLOCK = 8  # fronts peeled between two host checks


def _dominance_rank(objs: torch.Tensor) -> torch.Tensor:
    """(B, N, M) objective vectors -> (B, N) int64 non-domination rank (0 =
    the Pareto front), minimization on every component: the dense O(N^2)
    dominance mask and front peeling of the JAX package.  A row with a NaN
    compares False both ways, so it neither dominates nor is dominated;
    all-+inf infeasible rows tie with each other and are dominated by every
    feasible one.  The peel runs ``PEEL_BLOCK`` rounds between two host
    reads of "any row unranked"; a round after the last front assigns
    nothing, so the ranks are those of a check every round."""
    B, N, _ = objs.shape
    a, b = objs[:, :, None, :], objs[:, None, :, :]
    dom = (a <= b).all(dim=-1) & (a < b).any(dim=-1)  # dom[., i, j]: i dominates j
    rank = torch.full((B, N), -1, dtype=torch.int64, device=objs.device)
    r = 0
    while True:
        for _ in range(PEEL_BLOCK):
            unassigned = rank < 0
            blocked = (dom & unassigned[:, :, None]).any(dim=1)
            rank = torch.where(unassigned & ~blocked, r, rank)
            r += 1
        if r >= N or not bool((rank < 0).any()):
            return rank


def _crowding(objs: torch.Tensor) -> torch.Tensor:
    """(B, N, M) -> (B, N) float32 crowding distance in sign-folded bit
    space (``order_keys``), one unique (key, index) sort per objective: the
    two boundary designs get +inf, interior ones their neighbour gap over
    the span, summed over the objectives in order.  The fold maps +-inf to
    finite keys, so all-+inf rows never make inf - inf."""
    B, N, M = objs.shape
    total = torch.zeros((B, N), dtype=torch.float32, device=objs.device)
    for m in range(M):
        key = order_keys(objs[..., m])
        perm = torch.argsort(key, dim=-1, stable=True)
        kf = torch.gather(key, 1, perm).to(torch.float32)
        span = (kf[:, -1] - kf[:, 0])[:, None]
        prev = torch.cat([kf[:, :1], kf[:, :-1]], dim=1)
        nxt = torch.cat([kf[:, 1:], kf[:, -1:]], dim=1)
        d = torch.where(span > 0, (nxt - prev) / span, 0.0)
        d[:, 0] = math.inf
        d[:, N - 1] = math.inf
        total.scatter_add_(1, perm, d)
    return total


def _crowded_order_keys(objs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The survival keys (rank, -crowding bits) (B, N) each: crowding is
    non-negative and never NaN, so its negated bit pattern sorts it
    descending."""
    rank = _dominance_rank(objs)
    ckey = -_crowding(objs).view(torch.int32)
    return rank, ckey


def _crowded_order(rank: torch.Tensor, ckey: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation sorting by (rank, ckey, index), NSGA-II's crowded
    comparison as one unique total order: the pair packed into one int64,
    the index by a stable sort."""
    key = rank * (1 << 32) + (ckey.to(torch.int64) + (1 << 31))
    return torch.argsort(key, dim=-1, stable=True)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation -> its inverse: position of each index."""
    pos = torch.empty_like(perm)
    pos.scatter_(1, perm, torch.arange(perm.shape[1], device=perm.device)
                 .expand_as(perm).contiguous())
    return pos


def _crowded_positions(objs: torch.Tensor) -> torch.Tensor:
    """(B, P, M) -> (B, P) float32 crowded position (0 = best) of each
    design, without reordering: the tournament key of the initial
    population (survival emits later ones in crowded order)."""
    return _inverse(_crowded_order(*_crowded_order_keys(objs))).to(torch.float32)


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


def pareto_gen_step(pop, objs, sel, u, eval_fn, ctx, *, sbx_prob=SBX_PROB,
                    sbx_eta=SBX_ETA, mut_eta=MUT_ETA):
    """One NSGA-II generation: the shared variation with the crowded
    position ``sel`` (B, P) as the tournament key, then the first P of
    the 2P candidates in crowded order.  Returns ``(new_pop, new_objs,
    new_sel, children, child_objs)``; survivors come in crowded order, so
    the next tournament key is the position itself."""
    B, P, _ = pop.shape
    children = variation(pop, sel, u, sbx_prob=sbx_prob, sbx_eta=sbx_eta,
                         mut_eta=mut_eta)
    child_objs = eval_fn(children, ctx)
    allg = torch.cat([pop, children], dim=1)
    allo = torch.cat([objs, child_objs], dim=1)
    idx = _crowded_order(*_crowded_order_keys(allo))[:, :P]
    new_sel = torch.arange(P, device=pop.device, dtype=torch.float32).expand(B, P)
    return _rows(allg, idx), _rows(allo, idx), new_sel, children, child_objs


def draw_u_blocks(generators: Sequence[torch.Generator], generations: int,
                  tot: int, device) -> torch.Tensor:
    """(G, B, tot) uniform blocks: one (G, tot) draw per search from its
    own generator."""
    return torch.stack([
        torch.rand((int(generations), int(tot)), generator=g, device=device,
                   dtype=torch.float32)
        for g in generators
    ], dim=1)


def _stream(u_blocks, generators, G: int, B: int, tot: int, dev) -> torch.Tensor:
    """The run's (G, B, tot) uniform stream: ``u_blocks`` checked and moved
    to ``dev``, or drawn from one generator per search."""
    if u_blocks is None:
        if generators is None or len(generators) != B:
            raise ValueError("pass u_blocks (G, B, tot) or one generator per search")
        u_blocks = draw_u_blocks(generators, G, tot, dev)
    if tuple(u_blocks.shape) != (G, B, tot):
        raise ValueError(f"u_blocks must be {(G, B, tot)}, got {tuple(u_blocks.shape)}")
    return u_blocks.to(device=dev, dtype=torch.float32)


def init_ga_state_batched(eval_fn: Callable, init_genomes: torch.Tensor,
                          u_blocks: torch.Tensor, ctx: Any = None) -> GAState:
    """Score the seed populations (B, P, n) into a ``GAState`` at
    generation 0 that carries the run's stream ``u_blocks`` (G, B, tot).
    ``init_genomes`` is copied, never modified."""
    B, P, n = init_genomes.shape
    tot = block_layout(P, n).tot
    if u_blocks.dim() != 3 or u_blocks.shape[1:] != (B, tot):
        raise ValueError(f"u_blocks must be (G, {B}, {tot}), got {tuple(u_blocks.shape)}")
    pop = init_genomes.to(torch.float32).clone()
    return GAState(genomes=pop, scores=eval_fn(pop, ctx),
                   u=u_blocks.to(device=pop.device, dtype=torch.float32), gen=0)


# ------------------------------------------------- captured generations
GRAPH_CACHE_KEYS = 8  # shapes remembered, least recently used first


class CapturePlan(NamedTuple):
    """A callback's declaration that its plain generation may replay as
    CUDA graphs.  Without ``call`` the whole generation is one graph.  With
    it the generation splits around ``call``: graph A runs the variation
    and ``head(children, ctx) -> mid`` (a tuple of tensors), the host makes
    ``call(mid, ctx) -> out`` (one tensor) as an eager operator call, and
    graph B runs ``tail(children, mid, out, ctx) -> child scores`` and the
    survival.  The three composed must be the callback's scores, bit for
    bit, and nothing in ``head`` or ``tail`` may read the host."""

    head: Optional[Callable] = None
    call: Optional[Callable] = None
    tail: Optional[Callable] = None


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a ctx tree (tensors and tuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _leaves(sub)]
    raise TypeError(f"ctx leaves must be tensors or tuples, got {type(tree)}")


def captures(eval_fn: Callable, pop: torch.Tensor) -> bool:
    """Whether ``run_ga_batched_segment`` may replay this callback's
    generations as CUDA graphs: it declares a ``capture_plan``, has no
    ``gen_step`` of its own, and the populations are on a CUDA device
    (and real: a fake trace captures nothing)."""
    return (getattr(eval_fn, "capture_plan", None) is not None
            and getattr(eval_fn, "gen_step", None) is None
            and pop.device.type == "cuda" and type(pop) is torch.Tensor)


def graph_key(eval_fn: Callable, pop: torch.Tensor, ctx, *, sbx_prob: float,
              sbx_eta: float, mut_eta: float) -> tuple:
    """What a captured generation depends on beyond the values in its
    static buffers: the callback (its tech, backend and tail), the
    populations' shape and device, every ctx tensor's shape and dtype, the
    grid and the variation's parameters."""
    return (eval_fn, tuple(pop.shape), str(pop.device),
            tuple((tuple(t.shape), t.dtype) for t in _leaves(ctx)),
            space.grid_token(), float(sbx_prob), float(sbx_eta), float(mut_eta))


class _Graphs:
    """One key's static buffers and its graphs, captured by the first
    generation that runs from them.  A segment holds ``lock`` while it
    uses them."""

    def __init__(self, eval_fn: Callable, pop, scores, u, ctx, kw: dict):
        self.eval_fn, self.plan, self.kw = eval_fn, eval_fn.capture_plan, kw
        self.lock = threading.Lock()
        self.device = pop.device
        self.shape = tuple(pop.shape)
        self.pop, self.scores = torch.empty_like(pop), torch.empty_like(scores)
        self.u = torch.empty_like(u)
        self.ctx = _map(torch.empty_like, ctx)
        self.stream = None  # the stream of the last segment
        self.ready = False  # graphs captured (a failed capture runs again)
        self.graph_a = self.graph_b = None
        self.mid = self.out = self.children = self.child_scores = None

    def load(self, pop, scores, ctx) -> None:
        """A segment's start: its state and ctx into the static buffers,
        after the last segment's work if that ran on another stream."""
        cur = torch.cuda.current_stream()
        if self.stream is not None and self.stream != cur:
            cur.wait_stream(self.stream)
        self.stream = cur
        self.pop.copy_(pop)
        self.scores.copy_(scores)
        for dst, src in zip(_leaves(self.ctx), _leaves(ctx)):
            dst.copy_(src)

    def _survive(self, children, child_scores) -> None:
        new_pop, new_scores = survive(self.pop, self.scores, children, child_scores)
        self.pop.copy_(new_pop)
        self.scores.copy_(new_scores)
        self.children, self.child_scores = children, child_scores

    def _capture(self) -> None:
        """Capture this key's graphs within its first generation: graph A
        alone, or graph A, its replay and the eager call (whose output
        becomes graph B's static input), then graph B.  Capture records on
        a side stream and runs nothing, so unlike ``torch.cuda.graph`` it
        neither waits for the card nor empties the allocators' caches."""
        plan, ctx = self.plan, self.ctx
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream())

        def record(body):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    g.capture_end()
            return g

        def graph_a():
            children = variation(self.pop, self.scores, self.u, **self.kw)
            if plan.call is None:
                self._survive(children, self.eval_fn(children, ctx))
            else:
                self.children, self.mid = children, plan.head(children, ctx)

        self.graph_a = record(graph_a)
        if plan.call is not None:
            self.graph_a.replay()
            self.out = plan.call(self.mid, ctx)
            self.graph_b = record(lambda: self._survive(
                self.children, plan.tail(self.children, self.mid, self.out, ctx)))
        self.ready = True

    def step(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One generation from the static state, which it advances; returns
        fresh ``(children, child_scores)``."""
        self.u.copy_(u)
        if not self.ready:
            with spans.span("ga.graph_capture", key=self.shape):
                self._capture()
        elif self.graph_b is not None:
            self.graph_a.replay()
            self.out.copy_(self.plan.call(self.mid, self.ctx))
        (self.graph_b or self.graph_a).replay()
        return self.children.clone(), self.child_scores.clone()


class _GraphCache:
    """Captured generations by ``graph_key``, at most ``cap`` keys, least
    recently used first.  A key seen once holds a slot with no buffers: its
    run was eager, and warmed up every lazy cache its capture needs."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._entries: "OrderedDict[tuple, Optional[_Graphs]]" = OrderedDict()
        self._lock = threading.Lock()

    def sight(self, key, make: Callable[[], "_Graphs"]) -> Optional["_Graphs"]:
        """``key``'s entry, made by ``make`` on its second sighting; ``None``
        on its first."""
        with self._lock:
            if key not in self._entries:
                self._entries[key] = None
                if len(self._entries) > self.cap:
                    self._entries.popitem(last=False)
                return None
            self._entries.move_to_end(key)
            entry = self._entries[key]
            if entry is None:
                entry = self._entries[key] = make()
            return entry

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


GRAPHS = _GraphCache(GRAPH_CACHE_KEYS)


def _captured_segment(graphs: _Graphs, state: GAState, ctx, gens: range):
    """``gens`` generations replayed from ``graphs``: the segment's new
    (population, scores) and its children and scores, one per generation."""
    hist_g, hist_s = [], []
    try:
        with torch.cuda.device(graphs.device):
            graphs.load(state.genomes, state.scores, ctx)
            for g in gens:
                with spans.span("ga.generation"), spans.span("ga.graph_replay"):
                    children, child_scores = graphs.step(state.u[g])
                hist_g.append(children)
                hist_s.append(child_scores)
            return (graphs.pop.clone(), graphs.scores.clone()), hist_g, hist_s
    finally:
        graphs.lock.release()


def run_ga_batched_segment(
    state: GAState,
    eval_fn: Callable,
    *,
    generations: int,
    total_generations: int,
    ctx: Any = None,
    sbx_prob: float = SBX_PROB,
    sbx_eta: float = SBX_ETA,
    mut_eta: float = MUT_ETA,
) -> Tuple[GAState, Tuple[torch.Tensor, torch.Tensor]]:
    """Advance ``generations`` (k) generations from ``state``: returns
    ``(new_state, (children (B, k, P, n), child_scores (B, k, P)))``.
    Generation g reads ``state.u[g]``, so chained segments covering the
    budget repeat ``run_ga_batched`` of ``total_generations`` bit for bit.
    ``state`` is not modified; a failed segment can run again from it.
    Where ``captures(eval_fn, ...)``, the plain generations replay CUDA
    graphs of their shape from the second sighting of it on (the same
    bits); a segment that finds its shape's graphs in use by another
    thread runs eagerly."""
    k, G, g0 = int(generations), int(total_generations), int(state.gen)
    if state.u.shape[0] != G:
        raise ValueError(f"state carries {state.u.shape[0]} generations' blocks, "
                         f"total_generations={G}")
    if k < 1 or g0 + k > G:
        raise ValueError(f"segment of {k} from generation {g0} exceeds {G}")
    kw = dict(sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta)
    pop, scores = state.genomes, state.scores
    graphs = None
    if captures(eval_fn, pop):
        graphs = GRAPHS.sight(graph_key(eval_fn, pop, ctx, **kw),
                              lambda: _Graphs(eval_fn, pop, scores, state.u[g0], ctx, kw))
        if graphs is not None and not graphs.lock.acquire(blocking=False):
            graphs = None
    if graphs is not None:
        (pop, scores), hist_g, hist_s = _captured_segment(
            graphs, state, ctx, range(g0, g0 + k))
    else:
        gen = make_gen_step(eval_fn, ctx, **kw)
        hist_g, hist_s = [], []
        for g in range(g0, g0 + k):
            with spans.span("ga.generation"):
                pop, scores, children, child_scores = gen(pop, scores, state.u[g])
            hist_g.append(children)
            hist_s.append(child_scores)
    new = GAState(genomes=pop, scores=scores, u=state.u, gen=g0 + k)
    return new, (torch.stack(hist_g, dim=1), torch.stack(hist_s, dim=1))


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
    entry per search.  Lower score = better.  One segment of the whole
    budget from a fresh ``GAState``."""
    B, P, n = init_genomes.shape
    if P != int(pop_size):
        raise ValueError(f"init_genomes holds {P} genomes, pop_size={pop_size}")
    G = int(generations)
    u = _stream(u_blocks, generators, G, B, block_layout(P, n).tot,
                init_genomes.device)
    state = init_ga_state_batched(eval_fn, init_genomes, u, ctx)
    hg = [state.genomes[:, None]]
    hs = [state.scores[:, None]]
    if G:
        _, (g, s) = run_ga_batched_segment(
            state, eval_fn, generations=G, total_generations=G, ctx=ctx,
            sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta)
        hg.append(g)
        hs.append(s)
    genomes = torch.cat(hg, dim=1)  # (B, G+1, P, n)
    scores_h = torch.cat(hs, dim=1)  # (B, G+1, P)
    flat_s = scores_h.reshape(B, -1)
    best = torch.argmin(flat_s, dim=1)
    bidx = torch.arange(B, device=genomes.device)
    return GAResult(
        genomes=genomes,
        scores=scores_h,
        best_genome=genomes.reshape(B, -1, n)[bidx, best],
        best_score=flat_s[bidx, best],
    )


# ------------------------------------------------------- thin epilogue
def _cell_codes(genomes: torch.Tensor) -> torch.Tensor:
    """(..., n) genomes -> one int64 mixed-radix code of the decoded grid
    cell per design (injective; the host ``engine._top_unique`` code)."""
    idx = space.decode_indices(genomes)
    sizes = space.GRID_SIZES.astype(np.int64)
    strides = np.concatenate([np.cumprod(sizes[::-1])[::-1][1:], np.ones(1, np.int64)])
    code = idx[..., 0] * int(strides[0])
    for j in range(1, idx.shape[-1]):
        code = code + idx[..., j] * int(strides[j])
    return code


_SENTINEL = torch.iinfo(torch.int64).max


def _unique_best(flat_g: torch.Tensor, key: torch.Tensor, top_k: int):
    """Per search, the ``top_k`` smallest ``key``s (B, N), one per decoded
    grid cell (its smallest key), best first; keys at the sentinel are
    dropped.  ``key`` must be unique below the sentinel.  Sorting by key
    and then, stably, by cell code puts each cell's best first in its run;
    those firsts, sorted by key again, are the selection.  Returns the
    selected flat indices (B, K) and which of them are kept (B, K)."""
    codes = _cell_codes(flat_g)
    by_key = torch.argsort(key, dim=1)
    by_cell = torch.gather(by_key, 1, torch.argsort(
        torch.gather(codes, 1, by_key), dim=1, stable=True))
    c = torch.gather(codes, 1, by_cell)
    first = torch.ones_like(c, dtype=torch.bool)
    first[:, 1:] = c[:, 1:] != c[:, :-1]
    cand = torch.where(first, torch.gather(key, 1, by_cell), _SENTINEL)
    K = min(int(top_k), key.shape[1])
    sel_key, sel = torch.sort(cand, dim=1, stable=True)
    return torch.gather(by_cell, 1, sel[:, :K]), sel_key[:, :K] < _SENTINEL


def ga_epilogue_batched(genomes_hist: torch.Tensor, scores_hist: torch.Tensor,
                        *, top_k: int) -> GAThin:
    """The thin epilogue over (B, G+1, P, n) / (B, G+1, P) histories, on
    their device: per search, the host's ``_top_unique`` over its whole
    history (stable score order, each decoded grid cell's first (best)
    occurrence, non-finite scores dropped, the best ``top_k`` of those)
    and the best-so-far curve.

    Every design gets the unique key ``order_keys(score) * 2^32 + flat
    index``, whose ascending order is numpy's stable argsort of the scores
    (both zero signs fold to 0), or the sentinel when its score is not
    finite (a cell's non-finite occurrences sort after its finite ones on
    the host, so dropping them first keeps the same occurrence); then
    ``_unique_best`` picks in the host's order."""
    B, G1, P, n = genomes_hist.shape
    N = G1 * P
    flat_g = genomes_hist.reshape(B, N, n)
    flat_s = scores_hist.reshape(B, N)
    iota = torch.arange(N, device=flat_s.device, dtype=torch.int64)
    key = order_keys(flat_s).to(torch.int64) * (1 << 32) + iota
    key = torch.where(torch.isfinite(flat_s), key, _SENTINEL)
    j, keep = _unique_best(flat_g, key, top_k)
    top_g = torch.where(keep[..., None], _rows(flat_g, j), 0.0)
    top_s = torch.where(keep, torch.gather(flat_s, 1, j), math.inf)
    conv = torch.cummin(scores_hist.amin(dim=2), dim=1).values
    return GAThin(top_genomes=top_g, top_scores=top_s,
                  n_kept=keep.sum(dim=1), convergence=conv)


def run_ga_batched_thin(eval_fn: Callable, *, top_k: int, **kw) -> GAThin:
    """``run_ga_batched`` followed by the thin epilogue on the same device:
    the selection and convergence equal the host finalize of the history,
    which itself never leaves the device."""
    res = run_ga_batched(eval_fn, **kw)
    return ga_epilogue_batched(res.genomes, res.scores, top_k=top_k)


# ---------------------------------------------------- Pareto runs
def _pareto_core(eval_fn: Callable, init_genomes: torch.Tensor, u: torch.Tensor,
                 ctx: Any, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pareto twin of ``run_ga_batched``'s loop: same stream, same
    variation, NSGA-II survival.  Returns the evaluated history
    ``(genomes (B, G+1, P, n), objs (B, G+1, P, M))``."""
    pop = init_genomes.to(torch.float32).clone()
    objs = eval_fn(pop, ctx)
    sel = _crowded_positions(objs)
    hg, ho = [pop], [objs]
    for g in range(u.shape[0]):
        with spans.span("ga.generation"):
            pop, objs, sel, children, child_objs = pareto_gen_step(
                pop, objs, sel, u[g], eval_fn, ctx, **kw)
        hg.append(children)
        ho.append(child_objs)
    return torch.stack(hg, dim=1), torch.stack(ho, dim=1)


def pareto_epilogue_batched(genomes_hist: torch.Tensor, objs_hist: torch.Tensor,
                            *, top_k: int) -> ParetoThin:
    """Per search, the ``top_k`` best front members over the whole
    (B, G+1, P, n) / (B, G+1, P, M) history, on its device: crowded order
    (non-domination rank over all evaluated designs, crowding within a
    rank, flat index) with non-finite rows dropped, one per decoded grid
    cell (the cell's best-placed design), and the running best E*L*A.
    With ``top_k`` large enough the picks cover the whole first front,
    then spill into rank 1, 2, ..."""
    B, G1, P, n = genomes_hist.shape
    M = objs_hist.shape[-1]
    N = G1 * P
    flat_g = genomes_hist.reshape(B, N, n)
    flat_o = objs_hist.reshape(B, N, M)
    flat_s = pareto_scalar(flat_o)
    pos = _inverse(_crowded_order(*_crowded_order_keys(flat_o)))
    key = torch.where(torch.isfinite(flat_o).all(dim=-1), pos, _SENTINEL)
    j, keep = _unique_best(flat_g, key, top_k)
    top_g = torch.where(keep[..., None], _rows(flat_g, j), 0.0)
    top_v = torch.where(keep[..., None], _rows(flat_o, j), math.inf)
    top_s = torch.where(keep, torch.gather(flat_s, 1, j), math.inf)
    conv = torch.cummin(flat_s.reshape(B, G1, P).amin(dim=2), dim=1).values
    return ParetoThin(top_genomes=top_g, top_vectors=top_v, top_scores=top_s,
                      n_kept=keep.sum(dim=1), convergence=conv)


def run_pareto_batched(
    eval_fn: Callable,
    *,
    pop_size: int,
    generations: int,
    init_genomes: torch.Tensor,
    top_k: int,
    ctx: Any = None,
    u_blocks: Optional[torch.Tensor] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
    history: bool = False,
    sbx_prob: float = SBX_PROB,
    sbx_eta: float = SBX_ETA,
    mut_eta: float = MUT_ETA,
):
    """B independent NSGA-II searches, front extraction on the device.
    ``eval_fn(genomes, ctx)`` returns (B, P, M) minimization vectors
    (``objectives.make_pareto_objective``); randomness as in
    ``run_ga_batched``.  Returns the batched ``ParetoThin``, or with
    ``history=True`` ``(genomes_hist, objs_hist, thin)``: the same front
    either way."""
    B, P, n = init_genomes.shape
    if P != int(pop_size):
        raise ValueError(f"init_genomes holds {P} genomes, pop_size={pop_size}")
    G = int(generations)
    u = _stream(u_blocks, generators, G, B, block_layout(P, n).tot,
                init_genomes.device)
    gh, oh = _pareto_core(eval_fn, init_genomes, u, ctx, sbx_prob=sbx_prob,
                          sbx_eta=sbx_eta, mut_eta=mut_eta)
    thin = pareto_epilogue_batched(gh, oh, top_k=top_k)
    return (gh, oh, thin) if history else thin


def _map(fn: Callable, tree):
    """``fn`` over the tensors of a ctx tree (tensors and tuples, named
    tuples kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"ctx leaves must be tensors or tuples, got {type(tree)}")


def _add_batch(tree):
    return _map(lambda t: t.unsqueeze(0), tree)


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


def init_ga_state(eval_fn: Callable, init_genomes: torch.Tensor,
                  u_blocks: torch.Tensor, ctx: Any = ()) -> GAState:
    """``init_ga_state_batched`` for one search: ``init_genomes`` (P, n),
    ``u_blocks`` (G, tot), ``ctx`` unbatched.  The state keeps its batch
    axis of 1; pass it on to ``run_ga_segment``."""
    return init_ga_state_batched(eval_fn, init_genomes[None], u_blocks[:, None],
                                 _add_batch(ctx))


def run_ga_segment(state: GAState, eval_fn: Callable, *, generations: int,
                   total_generations: int, ctx: Any = (), **kw
                   ) -> Tuple[GAState, Tuple[torch.Tensor, torch.Tensor]]:
    """``run_ga_batched_segment`` for a state from ``init_ga_state``:
    histories come back as (k, P, n) / (k, P)."""
    new, (g, s) = run_ga_batched_segment(
        state, eval_fn, generations=generations,
        total_generations=total_generations, ctx=_add_batch(ctx), **kw)
    return new, (g[0], s[0])

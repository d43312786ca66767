#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Phases, in order; the
first fault exits non-zero and prints no result:

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the four kernels from ``src/repro_torch/kernels/csrc``, each a
     kernel library and its ``repro_torch::`` operator's (one nvcc each,
     all in parallel), and print the build's seconds and ptxas summary;
     each operator must have its CUDA implementation once loaded; count
     the wgmma (HGMMA) and mma.sync (HMMA) instructions in each ssd_scan
     kernel's SASS (``cuobjdump --dump-sass``): every kernel
     that computes a product must have some, and the CUDA-core kernels
     it replaced must be gone; in flash_attention's, every head-dim tier
     of ``flash_attention_wgmma_kernel`` must issue wgmma and TMA loads
     (UTMALDG), the mma.sync kernel it replaced must be gone, and no B3
     kernel may issue mma.sync;
  3. imc_eval against its plain version on the card, rtol 1e-5 on the
     energy and latency sums, exact demand and equal fits / valid, at the
     search path's two shapes (joint: B=8, P=40, W=4, L=64; separate: B=4,
     P=40, W=1, L=64, one CNN per search), at the service's largest
     ``--backend kernel`` group (B=28, P=40, W=2), at padding edges (P=129, L=65,
     W=3, ragged masks, integer layer features), around the kernel's tiles
     (W=1, L in {1, 31, 32, 33, 64, 65} x P in {1, 7, 8, 9}) and at a
     large population (B=16, P=4096), where the kernel gives each design
     fewer lanes: 40 of its designs must keep their bits at B=1; and at an
     LM workload's depth (qwen3-moe-235b decode, L=36,567, P=40) within
     ``B1_DEEP_RTOL``;
  4. ga_gen_step against the plain generation step on the card, fed the
     same uniform blocks and tables: P in ``B2_POPS`` (1 to 1024, both
     sides of the rank-by-counting / bitonic survival threshold; the path
     each P takes is logged), B=4 searches over different workload subsets
     (W=4 tables) and over one CNN each (W=1 tables, the separate search's
     shape), and at P=40 the service's plan (B=64 searches over W=1, 2 and
     4 sets, tables padded to W=4), 4 chained generations, every output
     bit-exact; timed at the
     joint (B=8, W=4) and separate (B=4, W=1) shapes, at the service's
     (B=64 searches over the 9 subsets of its request mix, W=4 tables) and
     at P=1024; then
     the host's share of one B1 and one B2 wrapper call at both shapes:
     the whole call, the ``repro_torch::`` operator call alone, the same
     launch through ``ctypes`` (the binding before the operators), the
     wrapper's own steps, and B1 bound as a Python CUDA kernel
     (``Library.impl``) and as a ``custom_op`` (logged; ``host_split_us``
     in the timings line);
  5. flash_attention against ``attention_reference`` on the card: llama's
     prefill (B=1, H=32, KV=8, D=64, bf16, S = 128, 1024, 2048), the other
     models' prefill shapes in bf16 (mixtral H=32, KV=8, D=128, S=1024,
     window 4096; qwen3-moe H=64, KV=4, D=128, S=1024; qwen2-vl H=12,
     KV=2, D=128, S=2048; whisper's non-causal encoder and cross-attention,
     H=KV=16, D=64, Sq=Skv=1024, and Sq=512 against Skv=1024; and over
     frame counts that are no multiple of the 128-row KV block, whisper's
     own 1500 and 200, Sq=Skv and Sq=200 against Skv=1500, as the models
     call it with ``ragged_kv=True``) and edges
     (ragged Sq and Skv, window 96, q_offset, D=80, 128 and 16,
     non-causal, rows with no valid key), gemma-7b's prefill (H=KV=16,
     D=256, S=1024) and D=256 with a window, a ragged Sq and keyless rows,
     a D of 36 that the wrapper pads for TMA, and causal calls whose query
     tiles the kernel pairs (an odd count with a q_offset; a real window)
     within 3e-2 in bf16 (the wgmma kernel; as ``tests/test_kernels.py``),
     the JAX kernel sweep, the same edges and D=256 in float32 (the
     CUDA-core kernel) within 2e-5; timed at the three llama shapes,
     mixtral's and gemma's beside the plain version and
     ``scaled_dot_product_attention`` (timed only, never on the path), with
     the host's cost of encoding a call's four TMA descriptors;
  6. ssd_scan against ``ref.ssd_chunked`` on the card: mamba2's prefill
     (B=1, H=48, P=64, N=128, S = 96, 128, 1024, 2048) and the JAX kernel
     sweep in float32, y and h within 1e-4 of the output's scale (max(1,
     max|ref|): 1e-4 absolute for outputs of order one, as
     ``tests/test_kernels.py``; y reaches ~200 at N=128), and in bf16 (the
     model's dtype; the same shapes, an initial state and B=2; y, rounded
     to bf16 by both, within 1e-2 of its scale, h within 1e-4); timed
     beside the plain version (device time summed over the three kernels
     of a call, and each kernel's share logged); and jamba's Mamba layers
     (B=1, H=128, P=64, N=16, S=1024, bf16, timed); then, at mamba2's
     shape in bf16, each row of a B=4 call and heads 0..7 of an H=48 call
     equal bit for bit to the same row or heads run alone;
  7. the search path through ``repro_torch.launch.search.main`` (8 seeds,
     pop 40, 10 generations, with separate baselines), once with
     ``--backend kernel`` and once with ``--backend table``: every launch
     count is set to 0 just before a run; the run's kernel must launch and
     no other; the joint search's best (over its 8 seeds) must beat or tie
     every separate winner re-scored on all four CNNs (5% slack; per seed
     the claim can miss, on the JAX package too, and the count is only
     logged), and each seed's joint best on all four CNNs and each separate
     winner's own best on its CNN must re-score to themselves on the plain
     dense path (rtol 1e-5);
  8. the search path once more per backend under torch.profiler: device
     busy time, idle share and the top device activities (not counted);
  9. the DSE service (``serve/dse.py``): ``launch.search.main(["--serve",
     "256", "--backend", "table", ...])`` (pop 40, 10 generations; 4 plans
     of 64 searches) and ``--serve 64 --backend kernel`` (3 plans grouped by
     W), each with every launch count set to 0 just before: every rid
     answered, the backend's kernel launched plans x generations times
     (B1: plans x (generations + 1)) and no other, every feasible best
     re-scores to itself on the plain dense path (rtol 1e-5), and 8
     sampled requests run alone give the same bits; then sequential and
     pipelined drains of the 256 table requests (equal bits, fewer bytes
     to the host when pipelined; requests/s, wait and latency p50/p99 and
     launches logged; per pipelined dispatch, the host seconds it spent in
     the seeder and whether the plan before's staged outputs were complete
     when it returned), ``SearchEngine.run`` over the same requests in
     both modes (equal bits; timed), the seeder alone on the engine's
     seeding stream and on the current stream (the same pools; timed),
     segmented drains, a drain
     killed after its first checkpoint and resumed (the same bits, 8
     generations after the resume), a second ``--result-cache`` drain (0
     launches, equal results), the async front end under the priority
     policy, and one traced drain per engine mode (device idle share);
 9b. the rest of the search path at the paper's configuration (4 CNNs,
     pop 40, 10 generations, 8 seeds), every launch count set to 0 before
     each run: the weighted objective over ``OBJECTIVE_WEIGHTS``' four rows
     on ``kernel`` (B1) and ``table`` (no kernel: B2 takes the indexed
     objective only), each best re-scoring to itself on the dense path and
     weights (1, 1, 1) giving the ``ela`` bits; ``--objective pareto
     --pareto-k 10`` through the CLI on both backends, and Pareto engine
     runs whose members are feasible, re-score to their vectors (rtol
     1e-5), are dominated by no later member, and are the same bits
     sequential and pipelined; direct-seeded table searches (every seed
     fits and is V/f-valid; two runs equal); the service's 64-request mix
     turned Pareto, drained sequential and pipelined (equal bits);
     NSGA-II survival (2P = 80) and the front epilogue (440) timed; and LM
     layers as workloads: ``llama3.2-1b,mixtral-8x7b`` decode must stop in
     the seeder (mixtral fits no design, as in the JAX package), and
     ``llama3.2-1b,mamba2-780m`` decode at 12,000 mm^2 runs on ``table``
     through ``SearchEngine(direct_seed=True)`` (B2), and the mix of
     ``repro_torch.examples.lm_hw_cosearch`` through that example on
     ``kernel`` (B1), each best re-scoring to itself;
 9c. the JAX package's threefry streams (``core/prng.py``): ``PRNGKey``
     over ``THREEFRY_SEEDS``, ``split`` (n = 2, 8, 64), ``uniform`` at the
     service plan's stream (64 x 10 x 1180) and one seeder round (64 x
     2560 x 9) on the card equal to the CPU's bit for bit and to jax's
     words (``THREEFRY_*``), ``gumbel`` within 1e-6 of the CPU's (relative
     to max(|g|, 1)); the stream draw's ms, device ms, launches and host
     ms; the search CLI with ``--prng threefry`` per kernel backend, with
     phase 7's checks and its host clock beside phase 7's; the 8 seeds'
     generation-0 populations on the card equal to the CPU port's from the
     same keys, with the rejection seeder (its rounds logged) and the
     direct seeder; ``--serve 64 --backend table --prng threefry`` (every
     rid answered, B2 launched plans x generations times and no other
     kernel, re-scores, 8 requests alone on the threefry streams: the same
     bits); and ``repro_torch.examples.quickstart`` at the paper's
     configuration;
 9d. the search stack on a mesh of ranks (``--search-mesh``,
     ``DSEService(mesh=)``): phase 7's search command on ``kernel`` and
     ``table`` and ``--serve 64 --backend table``, first meshless, then
     (a) in a world of one under NCCL at ``--search-mesh 1x1`` and (b) on
     two ranks sharing the card under gloo (this script's
     ``--mesh-worker`` mode, two subprocesses with torchrun's variables and
     a deadline) at ``2x1`` and ``1x2``, every launch count and the
     collective counts set to 0 just before each run: each run writes the
     meshless run's results and launches its backend's kernel on every
     rank as often as the meshless run, and no other; host clock, launches
     and collective calls and bytes per rank logged; gloo must all-gather
     the card's tensors;
 9e. the JAX package's public names the port took over last, every launch
     count set to 0 just before each path: ``make_eval_fn`` at the
     paper's shape (4 CNNs, P=40: 24 seeded designs and 16 uniform ones)
     on ``kernel`` (one B1 launch) and ``table`` (none) within rtol 1e-5
     of ``dense``, +inf at the same designs, each call timed (CUDA events;
     its device time from the profiler);
     ``evaluate_designs_kernel(d, ws)`` bit for bit the ``_arrays`` call
     and within rtol 1e-5 of the plain path; ``run_search(...,
     pipelined=True)`` (pop 40, 10 generations) on ``kernel`` (B1, 11
     launches a run) and ``table`` (B2, 10), timed in turns unpinned,
     pipelined, pipelined, unpinned on the shared engines: top genomes,
     scores and convergence equal to the unpinned run's bit for bit,
     ``ga is None``;
     ``table_bytes`` / ``grid_table_shape`` of tables built on the card
     against the CPU's at grid densities 1 and 2 (density 1 restored);
     ``repro_torch.examples.serve_demo`` (reduced mixtral, 10 requests):
     every request its ``max_new`` tokens, flash_attention launched once
     per layer and prefill (20) and no other kernel, each of those calls'
     inputs kept and its output held against ``attention_reference``
     (max abs err 3e-2, as B3's bf16 cases); the phase's host clock;
 10. the LM serving path at full width, once per model, each freed before
     the next loads, random weights from seed 0, peak device memory under
     ``MEM_LIMIT`` (70 GB) and logged.  ``llama3.2-1b`` (16 layers),
     ``mamba2-780m`` (48), ``mixtral-8x7b`` (8 of 32 layers),
     ``qwen3-moe-235b-a22b`` (4 of 94), ``jamba-v0.1-52b`` (one period,
     8 of 32) and ``gemma-7b`` (28, head dim 256): 8 requests from seed 0
     (prompts of 128-1024 tokens, 16-32 new tokens) through ``Engine``
     with 4 slots and max_len 2048.  Every launch count is set to 0 just
     before the burst; every request must get its max_new tokens, and each
     prefill must launch flash_attention 16 (llama), 8 (mixtral), 4
     (qwen3-moe), 1 (jamba) or 28 (gemma) times and
     ssd_scan 48 (mamba) or 7 (jamba) times, no other kernel at all.  Then
     the kernel path's prefill logits against the plain path's (same
     weights, plain attention / SSD called directly) within 0.05, except
     for mamba and jamba (logged there: below); for the
     MoE models under the plain path's routing (replayed layer by layer:
     a bf16 ulp between the paths moves tokens across router near-ties
     and the capacity boundary), with each path's own routing, the
     entries it moves and the dropped (token, k) entries logged, and every
     token that changes experts between the paths free-running required
     to be within twice its router probabilities' shift of a tie; for
     mamba and jamba,
     every ssd_scan call of a kernel-path prefill held on its own inputs
     against the scan in float64 (its y at most ``SSD_Y_MARGIN`` of the
     call's largest |y| further than the plain scan's), a check shown to
     reject a scan whose last chunk lost its inter-chunk term and one that
     drops each position's own term; the same prompts with float32
     activations (``transformer.ACT_DTYPE`` patched for the check, the
     same bf16 weights), the kernel path's logits at every position
     (``transformer.forward``) within 0.05 of the plain path's, jamba under
     the plain path's routing, a check the same two faulty scans must
     fail; the bf16 logits' gap between the paths and each path's gap to
     the plain path with its SSD in float64 (logged); the greedy tokens of a plain-path
     burst (logged), TTFT and decode tokens/s, and one burst under the
     profiler for llama, mamba and mixtral (float GEMVs and direct copies,
     GEMMs, index_put).  ``whisper-medium`` (24 + 24 layers) and
     ``qwen2-vl-2b`` (28), which ``Engine`` does not serve: prompts of 128,
     256, 512 and 1024 tokens with frames of their own length (whisper),
     or two of 2048 with 1024 vision embeddings and their mrope streams
     (qwen2-vl), from ``launch.cells.make_inputs``, each prefilled alone
     through ``serve.steps.make_prefill_step`` and decoded 16 greedy steps
     through ``make_decode_step``, launch counts set to 0 just before:
     flash_attention 72 (24 encoder, 24 causal, 24 cross-attention) or 28
     times per prefill and no other kernel; kernel vs plain prefill logits
     within 0.05;
 10b. the training path: ``llama3.2-1b`` (16 layers, 10 steps, a checkpoint
     every 5) and ``mamba2-780m`` (48 layers, 4 steps, every 2) at full
     width through ``repro_torch.launch.train.main`` (``--seq 1024 --batch
     4``, remat, random weights from seed 0, the synthetic data pipeline),
     every launch count set to 0 just before: no kernel launches (the step
     runs the plain attention and SSD: no kernel has a backward pass), every
     loss and grad norm finite, the last loss below the first, peak device
     memory under ``MEM_LIMIT``; the final checkpoint removed, the same
     command again must resume from the first and repeat the first run's
     losses within ``RESUME_LOSS_TOL``; one step with remat and, for llama,
     one without (ms, tokens/s, peak memory) and one traced step (device busy, idle
     share, top device work); then one step of reduced ``llama3.2-1b``,
     ``mamba2-780m`` and ``mixtral-8x7b`` (MoE aux loss, zeroed routers) on
     the card against the same step on the CPU from the same weights,
     moments and batch: loss, grad norm, each leaf's gradient and update
     within ``TRAIN_*`` tolerances;
 10c. training on a mesh: (a) ``llama3.2-1b`` at full width and depth,
     phase 10b's steps and seed, through ``launch.train.main`` meshless
     and at ``--data 1 --model 1`` in a world of one under NCCL, every
     launch count set to 0 just before each: losses and grad norms within
     ``MESH_LOSS_TOL`` of phase 10b's and of the meshless run, the final
     parameters and moments compared bit for bit (logged), step ms and
     peak memory beside phase 10b's, no kernel launched; then one 1x1 step
     timed and one traced (device busy, idle share) beside phase 10b's
     traced meshless step; (b) whether gloo
     runs DTensor's collectives on the card's tensors for two ranks
     sharing it (this script's ``--gloo-probe`` mode); if it does, or
     with two cards (NCCL, a card per rank), llama and mamba2 at full
     width, 2 layers, ``--seq 256 --batch 4``, 4 steps, at ``2x1`` and
     ``1x2`` on two ranks (``--train-mesh-worker``) against the meshless
     runs: losses within ``MESH_LOSS_TOL`` and step 0's grad norm within
     ``MESH_GNORM_RTOL`` (relative), each rank's local state bytes
     what ``params_sharding`` implies and at most ``MESH_BYTES_RATIO`` of
     the meshless run's for llama, collective calls and bytes per rank
     of the last step logged (``--count-comm``), a 2x1 checkpoint resumed at 1x2 repeating the
     unbroken run's losses; with one card that gloo cannot share it logs
     so and ``python3 chip_smoke.py --train-mesh`` runs (b) alone on two
     cards or more, and then serves llama and mamba2 (full width, 2
     layers, B=4, S=256, 4 decode steps, ``impl="kernel"``) at 2x1 and 1x2
     through ``cells.build_step``: every rank's logits within
     ``LM_LOGIT_TOL`` of the meshless run's, each rank's measured peak and
     a decode step's collectives logged beside the dry-run's prediction;
 10d. serving on a mesh and the dry-run: (a) ``llama3.2-1b`` and
     ``mamba2-780m`` at full width and depth, a prefill of 8 prompts of
     1024 tokens and 8 decode steps through ``launch.cells.build_step(...,
     impl="kernel")``, meshless and then on a 1x1 mesh in a world of one
     under NCCL, every launch count set to 0 just before the mesh run: its
     logits within ``LM_LOGIT_TOL`` of the meshless kernel path's (the
     largest gap logged), its prefill launching flash_attention 16 or
     ssd_scan 48 times and no other kernel (``launches_by_path.serve_mesh``);
     (b) the dry-run of phase 10b's llama step (B=4, S=1024, remat) on a 1x1
     fake mesh of fake tensors claiming the card (``--dryrun-step``, a
     process of its own): its per-device peak beside phase 10b's measured
     ``max_memory_allocated``, its counted FLOPs beside ``model_flops``, and
     the step's ``mfu`` (``model_flops`` over phase 10b's step time at 989
     TFLOP/s) and counted-FLOPs share; (c) ``launch.dryrun`` of
     llama3.2-1b's ``train_4k``, ``prefill_32k``, ``decode_32k`` and
     mamba2-780m's ``long_500k`` on the fake 16x16 mesh, every cell OK,
     ``trace_s`` logged; (d) ``launch.dryrun --search-mesh 1x1 --backend
     kernel`` (the fleet DSE evaluation through B1's ``repro_torch::``
     operator on fake CUDA tensors) exits 0 with its OK line; (b), (c) and
     (d) run on the host in the background from phase 10b on, within
     ``DRYRUN_DEADLINE_S``;
 11. one JSON line ``{"kernels": [...]}``: launches on the main paths
     (``launches_by_path``: the search CLI, the service, phase 9b's
     paths and phase 9c's, ``search_threefry`` and ``serve_threefry``,
     and phase 9d's, ``search_mesh`` and ``serve_mesh``: the 1x1 runs and
     every rank of the two-rank runs; phase 9e's ``surface/eval_fn``,
     ``surface/pipelined/kernel``, ``surface/pipelined/table`` and
     ``serve_demo``;
     for flash_attention and ssd_scan each model of phase 10, and
     phase 10d's 1x1 mesh, ``serve_mesh``; the training path, ``train``,
     and training on a mesh, ``train_mesh``, 0 for each),
     max error, kernel and plain times per call (CUDA events, after a
     warm-up, in turns plain/kernel/kernel/plain; at small sizes they
     include the host's launch overhead), the same work's device time
     from the profiler (``device_ms``, ``plain_device_ms``), the bound
     for this run's inputs and, for flash_attention, the SDPA time; B1 and
     B2 also at the separate search's and the service's shapes
     (``separate_ms``, ``service_ms``, ...), B3 at mixtral's and gemma's
     prefill shapes (``mixtral_shape``, ``gemma_shape``) with its
     descriptors' host cost (``encode_us``) and B4 at jamba's
     (``jamba_shape``), B4's device time by kernel at both shapes
     (``device_ms_by_kernel``), and both kernels' SASS census
     (``tensor_core_instructions``);
 12. the last line: ``{"ok": true, "device": {...}}``.

Timings at every shape and the traces are printed as one
``[smoke] timings {...}`` JSON line before the kernels line.

"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM, dense peaks at 700 W (data sheet): HBM3 bytes/s,
# float32 operations/s outside the tensor cores, bf16 tensor-core
# operations/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
# wrapper -> the prefix of its kernels' device-activity names, which sums
# all of a wrapper's kernels (the profiler shows e.g. "void (anonymous
# namespace)::ssd_scan_chunk_out_kernel<__nv_bfloat16>(...)"; one ssd_scan
# call runs three kernels)
KERNEL_PREFIX = {"imc_eval": "imc_eval_kernel", "ga_gen_step": "ga_gen_step_kernel",
                 "flash_attention": "flash_attention_", "ssd_scan": "ssd_scan_"}


# jax 0.9.0's threefry2x32 (partitionable) from PRNGKey(0): split(key, 2),
# split(key, 64)[63], and the float32 bits (as uint32) of the first and last
# words of uniform(key, shape); the threefry phase holds the card's draws
# to them, tests/test_torch_prng.py holds them to jax
THREEFRY_SPLIT0 = [[1797259609, 2579123966], [928981903, 3453687069]]
THREEFRY_SPLIT0_64_LAST = [3315697203, 95651515]
THREEFRY_UNIFORM0 = {
    (40, 11): ([1064475214, 1064993846, 1051337244, 1055913296],
               [1062062034, 1046583704, 1064207798, 1049831736]),
    (10, 64, 1180): ([1064475214, 1064993846, 1051337244, 1055913296],
                     [1047018048, 1057477850, 1064730794, 1039857984]),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def bound(bytes_moved: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profiled(torch, fn):
    """Run ``fn`` under torch.profiler with CUDA activity; returns (the
    profile, host seconds), or (None, seconds) when the profiler could not
    trace the card."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:  # the tracer, never fn: times read "not measured"
        log(f"profiler could not start: {e}")
        prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    return prof, wall


def device_kernels(prof, iters: int = 1) -> dict:
    """{device activity name: [ms per iteration, count]} from a profile."""
    from torch.autograd import DeviceType

    out: dict = {}
    if prof is None:
        return out
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            rec = out.setdefault(evt.name, [0.0, 0])
            rec[0] += evt.time_range.elapsed_us() / 1e3 / iters
            rec[1] += 1
    return out


def device_parts(torch, fn, iters: int, name: str = "") -> dict:
    """Per-call device time (ms) of each device activity ``fn`` enqueues
    whose name contains ``name``, keyed by its kernel's name where it has
    one (``ssd_scan_chunk_out_kernel``); empty if not traced.  A trace
    that holds none of them is taken again, up to three in all (the
    profiler has returned an empty trace between two that were not)."""
    fn()

    def many():
        for _ in range(iters):
            fn()

    out: dict = {}
    for _ in range(3):
        prof, _ = _profiled(torch, many)
        for n, (ms, _) in device_kernels(prof, iters).items():
            if name in n:
                short = re.search(r"(\w+_kernel)\b", n)
                key = short.group(1) if short else n[:80]
                out[key] = out.get(key, 0.0) + ms
        if out:
            break
    return out


def device_ms(torch, fn, iters: int, name: str = ""):
    """Per-call device time (ms) of the device work ``fn`` enqueues (only
    activities whose name contains ``name``), or None if not traced."""
    parts = device_parts(torch, fn, iters, name)
    return sum(parts.values()) if parts else None


def timed_pair(plain, kernel, iters: int):
    """(kernel ms, plain ms), warmed up, timed in turns plain, kernel,
    kernel, plain; each the mean of its two turns."""
    import torch

    for _ in range(3):
        plain()
        kernel()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ------------------------------------------------------------------ phases
def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}, cuBLASLt "
        f"{_cublaslt_version(torch)}) on {name}; {torch.cuda.device_count()} device(s)")
    return card, name


def _cublaslt_version(torch) -> str:
    """The version of the cuBLASLt that torch loaded (its GEMMs set the
    plain paths' summation order), or "unknown"."""
    import ctypes

    a = torch.ones((8, 8), device="cuda")
    (a @ a).sum().item()  # loads cuBLAS / cuBLASLt
    try:
        lib = ctypes.CDLL(f"libcublasLt.so.{torch.version.cuda.split('.')[0]}")
        lib.cublasLtGetVersion.restype = ctypes.c_size_t
        return str(lib.cublasLtGetVersion())
    except (OSError, AttributeError):
        return "unknown"


# B4's kernels that compute a product (each must issue tensor-core
# instructions) and the CUDA-core kernels they replaced (gone from the build)
B4_PRODUCT_KERNELS = ("ssd_scan_chunk_state_kernel", "ssd_scan_chunk_out_kernel")
B4_REMOVED_KERNELS = ("ssd_scan_state_kernel", "ssd_scan_intra_kernel", "ssd_scan_out_kernel")
# B3's bf16 kernel, one instantiation per padded head-dim tier, and the
# mma.sync kernel it replaced (gone from the build)
B3_KERNEL = "flash_attention_wgmma_kernel"
B3_TIERS = (64, 128, 256)
B3_REMOVED_KERNELS = ("flash_attention_mma_kernel",)
# WARPGROUP.DEPBAR in each tier when no wgmma chain is serialized
B3_MAX_DEPBAR = 4


def sass_census(lib: Path) -> dict:
    """{kernel instantiation: {"HGMMA": n, "HMMA": m, "UTMALDG": t, "DEPBAR": w}}
    from ``cuobjdump --dump-sass`` of a built library: wgmma, mma.sync, TMA
    load and wgmma wait instructions."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "--dump-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr.strip()[:400]}")
    ops = {"HGMMA": r"\bHGMMA\.", "HMMA": r"\bHMMA\.", "UTMALDG": r"\bUTMALDG\.",
           "DEPBAR": r"\bWARPGROUP\.DEPBAR\."}
    counts: dict = {}
    cur = None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the kernel's name follows its length in the mangled symbol
            name = re.search(r"\d((?:ssd_scan|flash_attention)_[a-z0-9_]+?_kernel)(I\w+?E)?",
                             m.group(1))
            cur = (name.group(1) + (name.group(2) or "")) if name else m.group(1)
            counts[cur] = {op: 0 for op in ops}
        elif cur is not None:
            for op, pat in ops.items():
                if re.search(pat, line):
                    counts[cur][op] += 1
    return counts


def phase_build(timings):
    import importlib

    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"built {sorted(secs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f}s ({secs}: one library a kernel, its kernel and its operator)")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line and "Used" in line) or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
        # its schema defined and its library loaded, each kernel is an
        # operator with a CUDA implementation
        importlib.import_module(f"repro_torch.kernels.{name}.ops")
        _build.load(name)
        check(torch._C._dispatch_has_kernel_for_dispatch_key(f"repro_torch::{name}", "CUDA"),
              f"repro_torch::{name} has no CUDA implementation after its library loaded")
    # B4 on the tensor cores: every product kernel's SASS holds wgmma
    # (HGMMA) or mma.sync (HMMA) instructions; the CUDA-core kernels are gone
    sass = sass_census(_build.lib_path("ssd_scan"))
    for k, c in sorted(sass.items()):
        log(f"B4 SASS {k}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
    for kernel in B4_PRODUCT_KERNELS:
        found = {k: c for k, c in sass.items() if k.startswith(kernel)}
        check(bool(found), f"B4: no {kernel} in the built library")
        for k, c in found.items():
            check(c["HGMMA"] + c["HMMA"] > 0, f"B4: {k} issues no tensor-core instruction")
    gone = [k for k in sass if k.startswith(B4_REMOVED_KERNELS)]
    check(not gone, f"B4: CUDA-core kernels still built: {gone}")
    timings["ssd_scan/sass"] = sass
    # B3's bf16 kernel on wgmma fed by TMA, in each head-dim tier; the
    # mma.sync kernel it replaced is gone, and no B3 kernel issues mma.sync
    sass = sass_census(_build.lib_path("flash_attention"))
    for k, c in sorted(sass.items()):
        log(f"B3 SASS {k}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}, UTMALDG {c['UTMALDG']}, "
            f"WARPGROUP.DEPBAR {c['DEPBAR']}")
    tiers = {k: c for k, c in sass.items() if k.startswith(B3_KERNEL)}
    check(len(tiers) == len(B3_TIERS), f"B3: {sorted(tiers)} built, want {B3_KERNEL} "
          f"for D tiers {B3_TIERS}")
    for k, c in tiers.items():
        check(c["HGMMA"] > 0, f"B3: {k} issues no wgmma")
        check(c["UTMALDG"] > 0, f"B3: {k} issues no TMA load")
        # ptxas puts a wait behind every wgmma of a chain it serializes
        # (C7512): the library still builds and runs, only slower
        check(c["DEPBAR"] <= B3_MAX_DEPBAR,
              f"B3: {k} has {c['DEPBAR']} WARPGROUP.DEPBAR (at most {B3_MAX_DEPBAR}): "
              f"its wgmma chains were serialized")
    check(not any(k.startswith(B3_REMOVED_KERNELS) for k in sass),
          f"B3: {B3_REMOVED_KERNELS} still built")
    mma = [k for k, c in sass.items() if c["HMMA"]]
    check(not mma, f"B3: mma.sync (HMMA) in {mma}")
    timings["flash_attention/sass"] = sass


def _paper_ws():
    from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
    from repro_torch.workloads.pack import pack_workloads

    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


def _designs(torch, B, P, gen, dev):
    from repro_torch.core import space

    g = torch.rand((B, P, space.N_GENES), generator=gen, device=dev)
    return torch.stack(list(space.decode(g)), dim=-1)


def b1_inputs(torch, B, P, W, L, gen, dev, paper, kind):
    """Designs (B, P, 9), feats (B, W, L, 6), mask (B, W, L).  ``kind``
    "joint": every search over the 4 paper CNNs; "separate": search b over
    CNN b alone (W=1), as ``core/search.py:separate_search`` packs them;
    "pairs": search b over CNNs (b, b+1) mod 4 (W=2), the service's largest
    ``--backend kernel`` group; "random": integer-valued random layers with
    ragged masks."""
    designs = _designs(torch, B, P, gen, dev)
    if kind == "joint":
        feats = paper.feats[None].expand(B, -1, -1, -1).to(dev).contiguous()
        mask = paper.mask[None].expand(B, -1, -1).to(dev).contiguous()
        return designs, feats, mask
    if kind == "separate":
        return designs, paper.feats[:, None].to(dev), paper.mask[:, None].to(dev)
    if kind == "pairs":
        pairs = torch.tensor([[b % 4, (b + 1) % 4] for b in range(B)])
        return designs, paper.feats[pairs].to(dev), paper.mask[pairs].to(dev)
    feats = torch.round(torch.randn((B, W, L, 6), generator=gen, device=dev).abs()
                        * 100 + 1)
    n_layers = torch.randint(1, L + 1, (B, W), generator=gen, device=dev)
    n_layers[..., 0] = L  # one full-length workload per search
    mask = torch.arange(L, device=dev) < n_layers[..., None]
    return designs, feats, mask


def phase_b1(torch, dev, paper, timings):
    from repro_torch.imc.cost import DesignArrays, evaluate_designs_arrays
    from repro_torch.kernels.imc_eval import ref
    from repro_torch.kernels.imc_eval.ops import (
        evaluate_designs_kernel_arrays,
        imc_eval_multi,
        lanes_per_design,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [("main", 8, 40, 4, 64, "joint"), ("separate", 4, 40, 1, 64, "separate"),
             ("service", 28, 40, 2, 64, "pairs"),
             ("edges", 2, 129, 3, 65, "random"), ("large", 16, 4096, 4, 64, "joint")]
    # around the kernel's tiles (32 lanes, 8 designs a block), W=1
    cases += [(f"tile_L{L}_P{P}", 2, P, 1, L, "random")
              for L in (1, 31, 32, 33, 64, 65) for P in (1, 7, 8, 9)]
    errs = {}
    for label, B, P, W, L, kind in cases:
        designs, feats, mask = b1_inputs(torch, B, P, W, L, gen, dev, paper, kind)
        k = imc_eval_multi(designs, feats, mask)
        p = ref.eval_workloads(designs, feats, mask)
        torch.cuda.synchronize()
        abs_err, rel_err = 0.0, 0.0
        for what, a, b in zip(("energy", "latency", "demand"), k, p):
            check(tuple(a.shape) == (B, W, P), f"B1 {label} {what} shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"B1 {label} {what} not finite")
            try:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
            except AssertionError as e:
                raise SmokeFailure(f"B1 {label} {what} vs plain: {e}") from None
            abs_err = max(abs_err, float((a - b).abs().max()))
            rel_err = max(rel_err, float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()))
        # integer layer features: demand sums integers below 2^24
        check(torch.equal(k[2], p[2]), f"B1 {label}: demand not exact")
        d = DesignArrays(*designs.unbind(-1))
        rk = evaluate_designs_kernel_arrays(d, feats, mask)
        rp = evaluate_designs_arrays(d, feats, mask)
        torch.cuda.synchronize()
        check(torch.equal(rk.fits, rp.fits), f"B1 {label}: fits differ")
        check(torch.equal(rk.valid, rp.valid), f"B1 {label}: valid differ")
        for what in ("energy_pj", "latency_ns"):
            try:
                torch.testing.assert_close(getattr(rk, what), getattr(rp, what),
                                           rtol=1e-5, atol=0.0)
            except AssertionError as e:
                raise SmokeFailure(f"B1 {label} {what} vs dense: {e}") from None
        errs[label] = (abs_err, rel_err)
        log(f"B1 {label} (B={B}, P={P}, W={W}, L={L}, {lanes_per_design(B, P, W)} "
            f"lanes a design): ok, max abs err {abs_err:.6g}, max rel err {rel_err:.3g}")
        if label.startswith("tile_"):
            continue

        def plain_fn(designs=designs, feats=feats, mask=mask):
            ref.eval_workloads(designs, feats, mask)

        def kernel_fn(designs=designs, feats=feats, mask=mask):
            imc_eval_multi(designs, feats, mask)

        k_ms, p_ms = timed_pair(plain_fn, kernel_fn, 50 if P < 1000 else 20)
        n_bytes = (designs.numel() * 4 + feats.numel() * 4 + mask.numel()
                   + 3 * B * W * P * 4)
        ops = 40.0 * P * float(mask.sum())
        b_ms, b_by = bound(n_bytes, ops)
        k_dev = device_ms(torch, kernel_fn, 20, KERNEL_PREFIX["imc_eval"])
        p_dev = device_ms(torch, plain_fn, 20)
        timings[f"imc_eval/{label}"] = dict(
            B=B, P=P, W=W, L=L, lanes=lanes_per_design(B, P, W), ms=k_ms,
            plain_ms=p_ms, device_ms=k_dev, plain_device_ms=p_dev, bound_ms=b_ms,
            bound_by=b_by, bytes=n_bytes, ops=ops)
        log(f"B1 {label}: kernel {k_ms:.4f} ms per call ({_ms(k_dev)} on the "
            f"device), plain {p_ms:.4f} ms ({_ms(p_dev)} on the device), "
            f"bound {b_ms:.6f} ms ({b_by})")
    # a design's sums keep their bits in a batch that gets fewer lanes
    designs, feats, mask = b1_inputs(torch, 16, 4096, 4, 64, gen, dev, paper, "joint")
    big = imc_eval_multi(designs, feats, mask)
    small = imc_eval_multi(designs[:1, :40].contiguous(), feats[:1], mask[:1])
    lanes = (lanes_per_design(16, 4096, 4), lanes_per_design(1, 40, 4))
    check(lanes[0] != lanes[1], f"B1: one lane count {lanes} for both batches")
    for what, a, b in zip(("energy", "latency", "demand"), big, small):
        check(torch.equal(a[:1, :, :40], b), f"B1: {what} of a design depends on its batch")
    log(f"B1 batch invariance: 40 designs at {lanes[1]} lanes (B=1) and at {lanes[0]} "
        f"lanes (B=16, P=4096): bit for bit")
    # an LM workload's depth: qwen3-moe-235b decode exports 36,567 layers,
    # which B1 stages 256 at a time
    from repro_torch.configs.base import get_config
    from repro_torch.workloads.lm import lm_workload
    from repro_torch.workloads.pack import pack_workloads

    deep = pack_workloads([("qwen3-moe-235b-a22b",
                            lm_workload(get_config("qwen3-moe-235b-a22b"), mode="decode"))])
    designs = _designs(torch, 1, 40, gen, dev)
    feats, mask = deep.feats[None].to(dev), deep.mask[None].to(dev)
    k = imc_eval_multi(designs, feats, mask)
    p = ref.eval_workloads(designs, feats, mask)
    torch.cuda.synchronize()
    rel = {}
    for what, a, b in zip(("energy", "latency", "demand"), k, p):
        check(bool(torch.isfinite(a).all()), f"B1 deep LM {what} not finite")
        rel[what] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
        check(rel[what] <= B1_DEEP_RTOL, f"B1 deep LM {what}: rel err {rel[what]:.3g} > "
              f"{B1_DEEP_RTOL}")
    timings["imc_eval/deep_lm"] = dict(B=1, P=40, W=1, L=int(feats.shape[2]), rel_err=rel)
    log(f"B1 at LM depth (qwen3-moe-235b-a22b decode, L={feats.shape[2]}, P=40): max rel "
        f"err against the plain version {rel} (tolerance {B1_DEEP_RTOL}: two orders of "
        f"a float32 sum of {feats.shape[2]} positive terms)")
    return errs["main"]


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def b2_case(torch, dev, P, subsets, gen):
    """One B2 case: tables (B, W, ...) over per-search workload subsets,
    kinds and areas per search, a population, its scores, and 4 blocks."""
    from repro_torch.core import space
    from repro_torch.core.ga import block_layout
    from repro_torch.imc.tables import WorkloadTables, build_tables_arrays
    from repro_torch.kernels.ga_gen_step.ref import table_scores

    ws = _paper_ws()
    W = max(len(s) for s in subsets)
    per = []
    for s in subsets:
        sub = ws.subset(s)
        t = build_tables_arrays(sub.feats.to(dev), sub.mask.to(dev))
        extra = W - len(s)
        per.append(WorkloadTables(*(
            torch.cat([x, x.new_zeros((extra, *x.shape[1:]))]) for x in t)))
    tables = WorkloadTables(*(torch.stack(x) for x in zip(*per)))
    B = len(subsets)
    kind = torch.arange(B, device=dev) % 4
    area = torch.tensor([(150.0, 1e9, 100.0, 150.0)[i % 4] for i in range(B)],
                        device=dev)
    pop = torch.rand((B, P, space.N_GENES), generator=gen, device=dev)
    scores = table_scores(pop, tables, kind, area)
    tot = block_layout(P, space.N_GENES).tot
    u = torch.rand((4, B, tot), generator=gen, device=dev)
    return tables, kind, area, pop, scores, u


def b2_bound(B, P, W, tot, R, C, Bc, Gn):
    """Bytes each input read once and each output written once, and
    operations counted from the kernel source per generation; survival as
    the function needs it, a comparison sort of the 2P candidates
    (2P log2(2P) comparisons of 3 operations), whatever method the kernel
    uses."""
    n = 9
    n_pairs = (P + 1) // 2
    sort_ops = 2 * P * max(1, math.ceil(math.log2(2 * P))) * 3
    tab = W * (R * C * Bc + C * Bc + Gn + 4)
    n_bytes = 4 * B * (P * n + P + tot + tab + 2) + 4 * B * (2 * P * n + 2 * P)
    ops = B * (n_pairs * n * 16 + P * n * 20 + P * (n + 30 + 30 * W) + sort_ops)
    return n_bytes, ops


# the workload subsets of serve.dse.paper_request_mix over the 4 CNNs: a
# table-backend plan of the service packs 64 searches over these (W=4 tables)
SERVE_SUBSETS = [[0, 1, 2, 3], [0], [1], [2], [3], [0, 1], [1, 2], [2, 3], [3, 0]]

# B2 populations checked bit for bit: the main path's 40, odd and even P,
# both sides of the rank-by-counting / bitonic threshold, and 1024
B2_POPS = (1, 2, 3, 15, 16, 40, 63, 64, 65, 127, 128, 129, 1024)


def phase_b2(torch, dev, timings):
    from repro_torch.core import space
    from repro_torch.kernels.ga_gen_step.ops import ga_gen_step, survival_path
    from repro_torch.kernels.ga_gen_step.ref import ga_gen_step_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # mixed subsets padded to W=4; one CNN per search (W=1), as the
    # separate search runs; the service's plans (64 searches over W=1, 2
    # and 4 sets padded to W=4) at its population
    for subsets, pops in (([[0], [1, 2], [0, 1, 2, 3], [3]], B2_POPS),
                          ([[0], [1], [2], [3]], B2_POPS),
                          ([SERVE_SUBSETS[i % 9] for i in range(64)], (SERVE_POP,))):
        W = max(len(s) for s in subsets)
        for P in pops:
            tables, kind, area, pop, scores, u = b2_case(torch, dev, P, subsets, gen)
            check(tables.demand.shape[1] == W, f"B2 tables W {tables.demand.shape}")
            ck = cp = (pop, scores)
            for g in range(4):
                k = ga_gen_step(ck[0], ck[1], u[g], (tables, kind, area))
                p = ga_gen_step_ref(cp[0], cp[1], u[g], tables, kind, area)
                torch.cuda.synchronize()
                for what, a, b in zip(("new_pop", "new_scores", "children",
                                       "child_scores"), k, p):
                    check(tuple(a.shape) == tuple(b.shape), f"B2 P={P} W={W} {what} shape")
                    check(torch.equal(a, b),
                          f"B2 P={P} W={W} gen {g}: {what} not bit-exact "
                          f"(max |diff| {float((a - b).abs().nan_to_num().max())})")
                ck, cp = (k[0], k[1]), (p[0], p[1])
            log(f"B2 P={P} (B={len(subsets)}, W={W}, 4 generations, "
                f"{survival_path(P)} survival): bit-exact")

    # timings at the main path's two shapes (the joint search: 8 searches
    # over the 4 CNNs; the separate search: 4 searches over one CNN each)
    # and at P=1024
    for label, P, subsets in (("main", 40, [[0, 1, 2, 3]] * 8),
                              ("separate", 40, [[0], [1], [2], [3]]),
                              ("service", 40, [SERVE_SUBSETS[i % 9] for i in range(64)]),
                              ("p1024", 1024, [[0, 1, 2, 3]] * 8)):
        B, W = len(subsets), max(len(s) for s in subsets)
        tables, kind, area, pop, scores, u = b2_case(torch, dev, P, subsets, gen)
        ctx = (tables, kind, area)

        def plain_fn(pop=pop, scores=scores, u=u, tables=tables, kind=kind, area=area):
            ga_gen_step_ref(pop, scores, u[0], tables, kind, area)

        def kernel_fn(pop=pop, scores=scores, u=u, ctx=ctx):
            ga_gen_step(pop, scores, u[0], ctx)

        k_ms, p_ms = timed_pair(plain_fn, kernel_fn, 50)
        gs = space.GRID_SIZES
        n_bytes, ops = b2_bound(B, P, W, u.shape[-1], int(gs[0]), int(gs[1]),
                                int(gs[6]), int(gs[8]))
        b_ms, b_by = bound(n_bytes, ops)
        k_dev = device_ms(torch, kernel_fn, 20, KERNEL_PREFIX["ga_gen_step"])
        p_dev = device_ms(torch, plain_fn, 20)
        timings[f"ga_gen_step/{label}"] = dict(
            B=B, P=P, W=W, ms=k_ms, plain_ms=p_ms, device_ms=k_dev,
            plain_device_ms=p_dev, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            ops=ops, survival=survival_path(P))
        log(f"B2 {label} (B={B}, P={P}, W={W}): kernel {k_ms:.4f} ms per call "
            f"({_ms(k_dev)} on the device), plain {p_ms:.4f} ms ({_ms(p_dev)} "
            f"on the device), bound {b_ms:.6f} ms ({b_by})")


def per_call_us(torch, fn, n: int = 2000, sync_every: int = 200) -> float:
    """Host microseconds per call of ``fn`` (time.perf_counter over ``n``
    calls, the queue drained every ``sync_every``)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // sync_every):
        t0 = time.perf_counter()
        for _ in range(sync_every):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / n * 1e6


def phase_host_split(torch, dev, paper, timings):
    """Where the host's share of one B1 / B2 wrapper call goes, at the
    search path's two shapes: the whole call, the operator call alone
    (``repro_torch::imc_eval`` / ``ga_gen_step``, C++ CUDA implementation:
    checks, outputs, stream, launch), the same launch through ``ctypes``
    with its output buffer made from Python (the binding the wrappers had
    before the kernels were operators), and the wrapper's own steps around
    the operator.  Host clock only (the device work of a step is not
    waited for)."""
    import ctypes

    from repro_torch.imc.tech import TECH
    from repro_torch.kernels import _build
    from repro_torch.kernels.ga_gen_step import ops as gops
    from repro_torch.kernels.imc_eval import ops as iops

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    idx = dev.index
    p, i = ctypes.c_void_p, ctypes.c_int
    b1_launch = ctypes.CDLL(str(_build.lib_path("imc_eval"))).imc_eval_launch
    b1_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.POINTER(ctypes.c_float), i, i, p]
    b1_launch.restype = i
    b2_launch = ctypes.CDLL(str(_build.lib_path("ga_gen_step"))).ga_gen_step_launch
    b2_launch.argtypes = [p] * 19 + [i] * 10 + [ctypes.POINTER(ctypes.c_float), i, i, p]
    b2_launch.restype = i
    split = {}
    for label, B, W, subsets in (("joint", 8, 4, [[0, 1, 2, 3]] * 8),
                                 ("separate", 4, 1, [[0], [1], [2], [3]])):
        P, L = 40, 64
        designs, feats, mask = b1_inputs(torch, B, P, W, L, gen, dev, paper, label)
        res = torch.empty((3, B, W, P), device=dev)
        c1 = iops.consts(TECH)
        c1_array = (ctypes.c_float * len(c1))(*c1)
        o = res.data_ptr()
        args1 = (designs.data_ptr(), feats.data_ptr(), mask.data_ptr(), o,
                 o + 4 * B * W * P, o + 8 * B * W * P, B, P, W, L, c1_array, len(c1), idx,
                 torch._C._cuda_getCurrentRawStream(idx))
        b1 = {
            "whole wrapper call": lambda: iops.imc_eval_multi(designs, feats, mask),
            "operator call (C++ CUDA implementation)":
                lambda: iops.IMC_EVAL(designs, feats, mask, c1),
            "ctypes launch alone (kernel enqueue)": lambda: b1_launch(*args1),
            "output buffer from Python": lambda: torch.empty((3, B, W, P), device=dev),
            "constants cached": lambda: iops.consts(TECH),
            "unbind into 3 sums": lambda: res.unbind(0),
        }

        tables, kind, area, pop, scores, u = b2_case(torch, dev, P, subsets, gen)
        ctx = (tables, kind, area)
        grids, sizes, vt = gops._grid_args(TECH, dev)
        dims = (grids.shape[1], *tables.demand.shape[2:], tables.spill.shape[-1],
                *vt.shape)
        n_pop, n_sc = B * P * 9, B * P
        buf = torch.empty(2 * (n_pop + n_sc), device=dev)
        o = buf.data_ptr()
        c2 = gops.consts(TECH, gops.SBX_PROB, 9)
        c2_array = (ctypes.c_float * len(c2))(*c2)
        kind64 = kind.to(torch.int64)
        ins = (pop, scores, u[0], *tables, grids, sizes, vt, kind64, area)
        args2 = (*[t.data_ptr() for t in ins], o, o + 8 * n_pop, o + 4 * n_pop,
                 o + 4 * (2 * n_pop + n_sc), B, P, W, *dims, c2_array, len(c2), idx,
                 torch._C._cuda_getCurrentRawStream(idx))
        b2 = {
            "whole wrapper call": lambda: gops.ga_gen_step(pop, scores, u[0], ctx),
            "operator call (C++ CUDA implementation)": lambda: gops.GA_GEN_STEP(
                pop, scores, u[0], *tables, kind, area, grids, sizes, vt, c2),
            "ctypes launch alone, 33 arguments (kernel enqueue)": lambda: b2_launch(*args2),
            "grid lookups cached": lambda: gops._grid_args(TECH, dev),
            "constants cached": lambda: gops.consts(TECH, gops.SBX_PROB, 9),
            "active-grid check": lambda: gops._active_grid(tables),
        }
        for name, steps in (("imc_eval", b1), ("ga_gen_step", b2)):
            rec = {k: per_call_us(torch, f) for k, f in steps.items()}
            split[f"{name}/{label}"] = rec
            log(f"host split {name} {label} (us a call): " + ", ".join(
                f"{k} {v:.2f}" for k, v in rec.items()))
    timings["host_split_us"] = split


def phase_main_path(torch, dev, backend, counter, prng="torch", timings=None):
    """Drive the CLI once on the ``prng`` streams; return the launch count
    of ``counter`` (the host clock goes to ``timings``)."""
    from repro_torch.core.objectives import make_objective
    from repro_torch.imc.cost import DesignArrays, evaluate_designs
    from repro_torch.launch.search import main

    ws = _paper_ws()
    idx = {n: i for i, n in enumerate(ws.names)}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = Path(tmp) / f"search_{backend}.json"
        argv = ["--seeds", "8", "--pop", "40", "--gens", "10", "--separate",
                "--backend", backend, "--device", str(dev), "--out", str(out),
                "--prng", prng]
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counter.launches
        others = {k: c.launches for k, c in counters.items()
                  if c is not counter and c.launches}
        check(rc == 0, f"main path ({backend}) returned {rc}")
        entries = json.loads(out.read_text())
    if timings is not None:
        timings[f"main_path/{backend}/{prng}"] = {"wall_s": dt, "launches": launches}
    backend = backend if prng == "torch" else f"{backend}, --prng {prng}"
    check(launches > 0, f"main path ({backend}) launched its kernel 0 times")
    check(not others, f"main path ({backend}): other kernels launched: {others}")
    check(len(entries) == 8, f"main path ({backend}): {len(entries)} seed entries")
    obj = make_objective("ela", 150.0)

    def rescore(design, on):
        d = DesignArrays(*(torch.tensor([design[f]], device=dev)
                           for f in DesignArrays._fields))
        return float(obj(evaluate_designs(d, on))[0])

    n_own = 0
    for e in entries:
        jb = e["joint_best"]
        check(jb is not None and math.isfinite(jb),
              f"{backend} seed {e['seed']}: joint search found no feasible design")
        check(len(e["convergence"]) == 11, f"{backend}: convergence length")
        # the joint best re-scores to itself on the plain dense path
        s = rescore(e["best_design"], ws)
        check(math.isclose(s, jb, rel_tol=1e-5),
              f"{backend} seed {e['seed']}: best re-scores to {s}, reported {jb}")
        # so does each separate winner, on its own CNN
        check(set(e["separate"]) == set(ws.names), f"{backend}: separate names")
        for name, sr in e["separate"].items():
            own = sr["own_best"]
            check(own is not None and math.isfinite(own),
                  f"{backend} seed {e['seed']}: separate {name} found no feasible design")
            s = rescore(sr["best_design"], ws.subset([idx[name]]))
            check(math.isclose(s, own, rel_tol=1e-5),
                  f"{backend} seed {e['seed']}: separate {name} best re-scores "
                  f"to {s}, reported {own}")
            n_own += 1
    # the paper's claim: the joint search's best (over its 8 seeds) beats or
    # ties every separate winner re-scored on all four CNNs
    joint = min(e["joint_best"] for e in entries)
    sep_all = [(e["seed"], name, s["best_on_all"]) for e in entries
               for name, s in e["separate"].items() if s["best_on_all"] is not None]
    for seed, name, s_all in sep_all:
        check(joint <= s_all * 1.05,
              f"{backend}: joint best {joint} worse than separate {name} "
              f"(seed {seed}) re-scored on all CNNs ({s_all})")
    per_seed = sum(e["joint_best"] <= s_all * 1.05 for e in entries
                   for seed, _, s_all in sep_all if seed == e["seed"])
    n_failed = sum(s["failed_frac_on_all"] for e in entries for s in e["separate"].values())
    log(f"main path --backend {backend}: {launches} kernel launches, "
        f"{dt:.3f}s host clock; {len(entries)} joint and {n_own} separate bests "
        f"re-score to themselves; joint best {joint:.6g} beats or ties all "
        f"{len(sep_all)} separate winners that fit all CNNs ({per_seed} of "
        f"them beaten by their own seed's joint best); mean failed fraction "
        f"of separate winners on all CNNs {n_failed / (8 * 4):.3f}")
    return launches


def phase_trace(torch, dev, backend, timings):
    """The main path once more under torch.profiler (after the counted
    run, which it does not touch): device busy time, idle share of the
    host clock, and the device activities that take the most time."""
    import contextlib
    import io

    from repro_torch.launch.search import main

    argv = ["--seeds", "8", "--pop", "40", "--gens", "10", "--separate",
            "--backend", backend, "--device", str(dev)]
    with contextlib.redirect_stdout(io.StringIO()):
        prof, wall = _profiled(torch, lambda: main(argv))
    per = device_kernels(prof)
    if not per:
        timings[f"trace/{backend}"] = {"wall_s": wall, "device": "not measured"}
        log(f"trace --backend {backend}: device time not measured")
        return
    busy = sum(ms for ms, _ in per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    timings[f"trace/{backend}"] = {
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
        "device_activities": sum(c for _, c in per.values()),
        "top": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top]}
    log(f"trace --backend {backend} (profiled): {wall:.3f}s host clock, "
        f"device busy {busy * 1e3:.2f} ms (idle share {1.0 - busy / wall:.4f}), "
        f"{sum(c for _, c in per.values())} device activities; top: "
        + "; ".join(f"{n[:60]} {ms:.2f} ms x{c}" for n, (ms, c) in top[:3]))


# ------------------------------------------------------------ DSE service
SERVE_POP, SERVE_GENS = 40, 10


def _serve_main(argv):
    """``launch.search.main(argv)`` with its per-request lines captured;
    returns (exit code, stdout)."""
    from repro_torch.launch.search import main

    return _captured(main, argv)


def _captured(fn, argv):
    """``fn(argv)`` with its stdout captured; returns (exit code, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _summary_lines(out: str) -> list:
    return [ln for ln in out.splitlines()
            if ln.startswith("[serve]") and not ln.startswith("[serve] rid ")]


def _same_bits(a, b) -> bool:
    """Two SearchResults agree on every result field, bit for bit."""
    import numpy as np

    return (np.array_equal(a.top_scores, b.top_scores)
            and np.array_equal(a.top_genomes, b.top_genomes)
            and np.array_equal(a.convergence, b.convergence, equal_nan=True)
            and a.top_designs == b.top_designs and a.valid == b.valid
            and a.generations == b.generations
            and a.workload_names == b.workload_names and a.objective == b.objective)


def _drain(svc, reqs) -> list:
    rids = svc.submit_all(reqs)
    res = svc.drain()
    return [res[r] for r in rids]


def _check_serve_entries(torch, dev, ws, backend, n, entries, label, prng="torch"):
    """Every rid answered; each best re-scores to itself on the plain dense
    path (rtol 1e-5); 8 sampled requests run alone (on the ``prng``
    streams) give the same bits."""
    import numpy as np

    from repro_torch.core.engine import SearchEngine
    from repro_torch.core.objectives import make_objective
    from repro_torch.imc.cost import DesignArrays, evaluate_designs
    from repro_torch.serve.dse import paper_request_mix

    check(sorted(e["rid"] for e in entries) == list(range(n)),
          f"{label}: {len(entries)} of {n} requests answered")
    idx = {name: i for i, name in enumerate(ws.names)}
    n_feasible = 0
    for e in entries:
        if e["best"] is None:
            continue
        n_feasible += 1
        d = DesignArrays(*(torch.tensor([e["best_design"][f]], device=dev)
                           for f in DesignArrays._fields))
        on = ws.subset([idx[w] for w in e["workloads"]])
        s = float(make_objective(e["objective"], 150.0)(evaluate_designs(d, on))[0])
        check(math.isclose(s, e["best"], rel_tol=1e-5),
              f"{label} rid {e['rid']}: best re-scores to {s}, reported {e['best']}")
    check(n_feasible >= n // 2, f"{label}: only {n_feasible} of {n} requests feasible")
    reqs = paper_request_mix(ws, n, backend=backend, pop_size=SERVE_POP,
                             generations=SERVE_GENS)
    sample = sorted(int(r) for r in np.random.default_rng(0).choice(n, 8, replace=False))
    for rid in sample:
        alone = SearchEngine(device=dev, prng=prng).run([reqs[rid]])[0]
        e = entries[rid]
        check([float(v) for v in alone.top_scores] == e["top_scores"]
              and (alone.top_designs[0] if alone.top_designs else None) == e["best_design"],
              f"{label} rid {rid}: alone {list(alone.top_scores[:3])}, in the "
              f"service {e['top_scores'][:3]}")
    return n_feasible, sample


class _DispatchProbe:
    """Wraps an engine's ``dispatch`` and the seeder for one drain: per
    dispatch, the host seconds spent in ``_seed_pools`` and whether the
    previous plan's staged outputs (recorded after its GA) were complete
    when the dispatch started and when it returned (``None`` for the
    first)."""

    def __init__(self, eng, engine_mod):
        self.rows, self._spent, self._prev = [], [0.0], None
        self._mod, self._real_seed = engine_mod, engine_mod._seed_pools
        real_dispatch = eng.dispatch

        def seed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self._real_seed(*a, **kw)
            finally:
                self._spent[0] += time.perf_counter() - t0

        def fired():
            staged = None if self._prev is None else self._prev.thin
            return None if staged is None or staged.event is None else staged.event.query()

        def dispatch(plan, **kw):
            before, at_start = self._spent[0], fired()
            pend = real_dispatch(plan, **kw)
            self.rows.append({"seed_s": self._spent[0] - before, "prev_fired_at_start":
                              at_start, "prev_fired": fired()})
            self._prev = pend
            return pend

        engine_mod._seed_pools = seed
        eng.dispatch = dispatch

    def close(self):
        self._mod._seed_pools = self._real_seed


def phase_service(torch, dev, card, timings):
    """The DSE service on the card: the CLI's ``--serve`` drains on both
    kernel backends (launch counts, re-scores, requests alone), sequential
    against pipelined, segments, kill and resume, the result cache, the
    async front end, one traced drain of each engine mode, the engine's
    own run in both modes, and the seeder's time.  Returns {kernel:
    launches}."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.engine import SearchEngine, plan_batch, plan_key
    from repro_torch.serve.dse import AsyncDSEService, DSEService, paper_request_mix

    ws = _paper_ws()
    counters = _counters()
    launches = {}
    common = ["--pop", str(SERVE_POP), "--gens", str(SERVE_GENS), "--device", str(dev)]
    rec = timings["service"] = {"card": card}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        # the CLI's drains, one per kernel backend
        for backend, n, kname in (("table", 256, "ga_gen_step"), ("kernel", 64, "imc_eval")):
            out = tmp / f"serve_{backend}.json"
            reqs = paper_request_mix(ws, n, backend=backend, pop_size=SERVE_POP,
                                     generations=SERVE_GENS)
            plans = plan_batch(reqs)
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc, text = _serve_main(["--serve", str(n), "--backend", backend,
                                    "--out", str(out)] + common)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: c.launches for k, c in counters.items()}
            check(rc == 0, f"--serve {n} --backend {backend} returned {rc}")
            want = len(plans) * (SERVE_GENS if kname == "ga_gen_step" else SERVE_GENS + 1)
            check(got[kname] == want, f"--serve --backend {backend}: {kname} launched "
                  f"{got[kname]} times, want {len(plans)} plans x generations = {want}")
            others = {k: v for k, v in got.items() if k != kname and v}
            check(not others, f"--serve --backend {backend}: other kernels: {others}")
            launches[kname] = got[kname]
            entries = json.loads(out.read_text())
            n_ok, sample = _check_serve_entries(torch, dev, ws, backend, n, entries,
                                                f"--serve {backend}")
            for ln in _summary_lines(text):
                log(ln)
            rec[f"cli_{backend}"] = dict(
                requests=n, plans=len(plans), slots=[len(p.requests) for p in plans],
                widths=[p.pad_w for p in plans], launches=got[kname], wall_s=wall,
                feasible=n_ok, alone_sample=sample)
            log(f"service --backend {backend}: {n} requests in {len(plans)} plans "
                f"(searches a launch {[len(p.requests) for p in plans]}, W "
                f"{[p.pad_w for p in plans]}), {got[kname]} {kname} launches, "
                f"{wall:.3f}s host clock; {n_ok} feasible bests re-score to "
                f"themselves; rids {sample} alone: bit for bit")

        # sequential against pipelined (table, 256 requests), in turns
        # sequential, pipelined, pipelined, sequential
        reqs = paper_request_mix(ws, 256, backend="table", pop_size=SERVE_POP,
                                 generations=SERVE_GENS)
        drains = {}
        for mode in ("sequential", "pipelined", "pipelined", "sequential"):
            eng = SearchEngine(device=dev, pipelined=mode == "pipelined")
            svc = DSEService(engine=eng)
            probe = _DispatchProbe(eng, engine_mod) if mode == "pipelined" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = _drain(svc, reqs)
            finally:
                if probe is not None:
                    probe.close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = svc.stats
            drains.setdefault(mode, []).append(dict(
                results=res, wall_s=wall, launches=eng.launches,
                transfer_bytes=eng.transfer_bytes, stats=st.summary(),
                requests_per_s_wall=len(res) / wall,
                dispatches=None if probe is None else probe.rows))
            if probe is not None:
                log("service pipelined drain, per dispatch: host seconds in the seeder "
                    "and whether the plan before's last GA event had fired when it "
                    "started / returned: " + "; ".join(
                        f"plan {i}: {r['seed_s']:.5f}s, {r['prev_fired_at_start']} / "
                        f"{r['prev_fired']}" for i, r in enumerate(probe.rows)))
        seq, pip = drains["sequential"], drains["pipelined"]
        for i, (a, b) in enumerate(zip(seq[0]["results"], pip[0]["results"])):
            check(_same_bits(a, b), f"service: pipelined rid {i} differs from sequential")
            check(b.ga is None and a.ga is not None, "service: thin results carry ga=None")
        for d in seq[1:] + pip[1:]:
            check(all(_same_bits(a, b) for a, b in zip(seq[0]["results"], d["results"])),
                  "service: a repeated drain differs")
        check(pip[0]["transfer_bytes"] < seq[0]["transfer_bytes"],
              f"service: pipelined read {pip[0]['transfer_bytes']} bytes, sequential "
              f"{seq[0]['transfer_bytes']}")
        base = seq[0]["results"]
        for mode, ds in drains.items():
            rec[mode] = [{k: v for k, v in d.items() if k != "results"} for d in ds]
            for d in ds:
                s = d["stats"]
                log(f"service {mode} drain (256 table requests): {d['wall_s']:.4f}s host "
                    f"clock ({d['requests_per_s_wall']:.1f} requests/s), "
                    f"{d['launches']} launches, {d['transfer_bytes']} bytes to the host; "
                    f"ServiceStats: {s['requests_per_s']:.1f} requests/s busy, wait "
                    f"p50/p99 {s['wait_p50_s']:.4f}/{s['wait_p99_s']:.4f}s, latency "
                    f"p50/p99 {s['latency_p50_s']:.4f}/{s['latency_p99_s']:.4f}s, "
                    f"dispatch gap p50 {s['dispatch_gap_p50_s']:.5f}s, device idle "
                    f"estimate {s['device_idle_s']:.4f}s")

        # the engine's own whole drain, SearchEngine.run over the same 256
        # requests, in turns sequential, pipelined, pipelined, sequential:
        # the pipelined run seeds all 4 plans, then launches them
        runs = {}
        for mode in ("sequential", "pipelined", "pipelined", "sequential"):
            eng = SearchEngine(device=dev, pipelined=mode == "pipelined")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(reqs)
            torch.cuda.synchronize()
            runs.setdefault(mode, []).append(time.perf_counter() - t0)
            check(all(_same_bits(a, b) for a, b in zip(base, res)),
                  f"engine: a {mode} run differs from the service's drain")
        rec["engine_run_s"] = runs
        log(f"engine run (256 table requests): sequential "
            f"{', '.join(f'{v:.4f}' for v in runs['sequential'])} s, pipelined "
            f"{', '.join(f'{v:.4f}' for v in runs['pipelined'])} s host clock, "
            f"bit for bit the service's drain")

        # the seeder alone (a read a round) at the first plan's shape, on the
        # engine's seeding stream and on the current stream, in turns; the
        # generators are made before the timed region
        plan = plan_batch(reqs)[0]
        eng = SearchEngine(device=dev)
        feats, mask = eng._packed(plan.requests, plan.pad_w, plan.pad_l)
        seed_ms = {"seeding stream": [], "current stream": []}
        pools = {}
        for i in range(8):
            where = ("seeding stream", "current stream")[i % 2]
            gens = [engine_mod._slot_generators(r.seed, dev)[0] for r in plan.requests]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine_mod._seed_pools(
                gens, feats, mask, SERVE_POP, tech=plan.requests[0].tech,
                stream=eng._seed_stream if where == "seeding stream" else None)
            torch.cuda.synchronize()
            seed_ms[where].append((time.perf_counter() - t0) * 1e3)
            pools.setdefault(where, out)
        check(all(torch.equal(a, b) for a, b in zip(*pools.values())),
              "seeder: the seeding stream's pools differ from the current stream's")
        rec["seeding"] = dict(B=len(plan.requests), ms={k: v[1:] for k, v in seed_ms.items()})

        # a dispatch behind work still queued on the engine's stream: ~0.5 s
        # of device sleep, then a pipelined dispatch of the first plan, with
        # the seeder on its stream and, for the reading, on the current one
        queued = {}
        for where in ("seeding stream", "current stream"):
            eng = SearchEngine(device=dev, pipelined=True)
            if where == "current stream":
                eng._seed_stream = None
            eng.harvest(eng.dispatch(plan))  # warm: tables, uploads
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000_000)
            slept = torch.cuda.Event()
            slept.record()
            t0 = time.perf_counter()
            pend = eng.dispatch(plan)
            queued[where] = (time.perf_counter() - t0, not slept.query())
            eng.harvest(pend)
        check(queued["seeding stream"][1], "seeder: the dispatch behind queued work "
              "returned only after that work: the seeding stream waited for it")
        rec["dispatch_behind_queued_work"] = queued
        log("a pipelined dispatch behind ~0.5 s of work queued on the engine's stream "
            "(host seconds, returned before that work ended): " + "; ".join(
                f"seeder on the {k} {v[0]:.4f}s, {v[1]}" for k, v in queued.items()))
        log(f"seeder at B={len(plan.requests)}, P={SERVE_POP} (after one warm-up each, "
            f"the same pools): " + "; ".join(
                f"{k} {', '.join(f'{x:.2f}' for x in v[1:])} ms" for k, v in seed_ms.items()))

        # segments (2 generations each), sequential and pipelined
        for pipelined in (False, True):
            eng = SearchEngine(device=dev, segment_gens=2, pipelined=pipelined)
            res = _drain(DSEService(engine=eng), reqs)
            check(all(_same_bits(a, b) for a, b in zip(base, res)),
                  f"service: segmented drain (pipelined={pipelined}) differs")
        log("service segmented drains (2-generation segments, sequential and "
            "pipelined): bit for bit the single launch")

        # kill after the first committed checkpoint, then resume
        class Killed(BaseException):
            pass

        ck = tmp / "ckpt"
        one = reqs[:64]
        real_save = store.save

        def save_then_kill(*a, **kw):
            real_save(*a, **kw)
            raise Killed()

        store.save = save_then_kill
        svc = DSEService(engine=SearchEngine(device=dev, segment_gens=2,
                                             checkpoint_dir=str(ck)))
        svc.submit_all(one)
        try:
            svc.drain()
            killed = False
        except Killed:
            killed = True
        finally:
            store.save = real_save
        check(killed, "kill/resume: the drain was not killed")
        check(svc.pending() == len(one), "kill/resume: the killed drain lost requests")
        key = plan_key(plan_batch(one)[0], dev)
        check(store.scan(ck) == [key] and store.latest_step(ck / key) == 2,
              f"kill/resume: checkpoints {store.scan(ck)}")
        for c in counters.values():
            c.launches = 0
        res = _drain(DSEService(engine=SearchEngine(device=dev, segment_gens=2,
                                                    checkpoint_dir=str(ck))), one)
        resumed = counters["ga_gen_step"].launches
        check(all(_same_bits(a, b) for a, b in zip(base[:64], res)),
              "kill/resume: the resumed drain differs")
        check(resumed == SERVE_GENS - 2, f"kill/resume: {resumed} generations after "
              f"the resume, want {SERVE_GENS - 2}")
        check(store.scan(ck) == [], "kill/resume: the finished plan left its checkpoint")
        log(f"service kill after the first checkpoint (generation 2) and resume: "
            f"{resumed} generations run after it, 64 results bit for bit")

        # the result cache: a second drain over the same directory
        cache_dir = tmp / "cache"
        outs, texts, runs = [], [], []
        for i in range(2):
            out = tmp / f"cached_{i}.json"
            for c in counters.values():
                c.launches = 0
            rc, text = _serve_main(["--serve", "64", "--backend", "table",
                                    "--result-cache", str(cache_dir), "--out", str(out)]
                                   + common)
            check(rc == 0, f"--result-cache drain {i} returned {rc}")
            runs.append({k: c.launches for k, c in counters.items()})
            outs.append(json.loads(out.read_text()))
            texts.append(text)
        m = re.search(r"over (\d+) engine launches", texts[1])
        check(m is not None and int(m.group(1)) == 0,
              f"--result-cache: second drain: {_summary_lines(texts[1])}")
        check(not any(runs[1].values()), f"--result-cache: second drain launched {runs[1]}")
        check(runs[0]["ga_gen_step"] > 0, "--result-cache: first drain launched nothing")
        check(outs[0] == outs[1], "--result-cache: the cached drain's results differ")
        log(f"service --result-cache: second drain 0 engine launches, 0 kernel "
            f"launches, 64 equal results; {[ln for ln in _summary_lines(texts[1]) if 'cache:' in ln]}")

        # the async front end under the priority policy
        areqs = paper_request_mix(ws, 64, backend="table", pop_size=SERVE_POP,
                                  generations=SERVE_GENS, priorities=[3, 0, 1, 2])
        with AsyncDSEService(engine=SearchEngine(device=dev), policy="priority") as asvc:
            futs = [asvc.submit(r) for r in areqs]
            ares = [f.result(timeout=600) for f in futs]
            n_launch = asvc.stats.launches
        check(all(_same_bits(a, b) for a, b in zip(base[:64], ares)),
              "async service: results differ from the sequential drain")
        log(f"async service (priority policy): 64 of 64 futures answered in {n_launch} "
            "launches, bit for bit the sequential drain")

        # one traced drain of each engine mode: the device's idle share
        for mode in ("pipelined", "sequential"):
            eng = SearchEngine(device=dev, pipelined=mode == "pipelined")
            prof, wall = _profiled(torch, lambda: _drain(DSEService(engine=eng), reqs))
            per = device_kernels(prof)
            if not per:
                rec[f"trace/{mode}"] = {"wall_s": wall, "device": "not measured"}
                log(f"service trace {mode}: device time not measured")
                continue
            busy = sum(ms for ms, _ in per.values()) / 1e3
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
            rec[f"trace/{mode}"] = {
                "wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
                "device_activities": sum(c for _, c in per.values()),
                "top": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top]}
            log(f"service trace {mode} (256 table requests, profiled): {wall:.3f}s host "
                f"clock, device busy {busy * 1e3:.2f} ms (idle share "
                f"{1.0 - busy / wall:.4f}), {sum(c for _, c in per.values())} device "
                "activities; top: " + "; ".join(f"{n[:60]} {ms:.2f} ms x{c}"
                                                for n, (ms, c) in top[:3]))
    return launches


# ------------------------------------- objectives, NSGA-II, LM workloads
PAPER_SEEDS = 8
# a sum of 36,567 positive float32 terms taken in two orders (B1 stages
# 256 layers at a time): the stated tolerance of the LM-depth B1 case
B1_DEEP_RTOL = 1e-4


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    return {k: c.launches for k, c in counters.items()}


def _design_arrays(torch, dev, designs):
    from repro_torch.imc.cost import DesignArrays

    return DesignArrays(*(torch.tensor([d[f] for d in designs], device=dev)
                          for f in DesignArrays._fields))


def _dense_eval(torch, dev, designs, ws):
    """The plain dense cost model of design dicts on ``ws``."""
    from repro_torch.imc.cost import evaluate_designs

    return evaluate_designs(_design_arrays(torch, dev, designs), ws)


def _check_rescored(torch, dev, results, ws, label, area=150.0):
    """Each result's best re-scores to itself on the plain dense path
    under its own objective (rtol 1e-5); returns how many were feasible."""
    from repro_torch.core.objectives import make_objective

    n = 0
    for i, res in enumerate(results):
        if not res.valid:
            continue
        r = _dense_eval(torch, dev, res.top_designs[:1], ws)
        s = float(make_objective(res.objective, area)(r)[0])
        check(math.isclose(s, float(res.top_scores[0]), rel_tol=1e-5),
              f"{label} {i}: best re-scores to {s}, reported {res.top_scores[0]}")
        n += 1
    return n


def _check_front(torch, dev, res, ws, label, area=150.0):
    """A Pareto result: every member feasible and re-scoring to its (E, L,
    A) vector on the plain dense path (rtol 1e-5); no member dominated by
    a later one (members come in ascending non-domination rank).  Returns
    whether the members are mutually non-dominated."""
    import numpy as np

    v = res.objective_vectors
    check(v.shape == (len(res.top_scores), 3), f"{label}: front {v.shape}")
    check(bool(np.isfinite(v).all()) and bool((v[:, 2] <= area).all()),
          f"{label}: an infeasible member")
    r = _dense_eval(torch, dev, res.top_designs, ws)
    check(bool(r.fits.all()) and bool(r.valid.all()), f"{label}: a member does not fit")
    dense = torch.stack([r.energy_pj.amax(-1), r.latency_ns.amax(-1), r.area_mm2], -1)
    try:
        torch.testing.assert_close(torch.from_numpy(v), dense.cpu(), rtol=1e-5, atol=0.0)
    except AssertionError as e:
        raise SmokeFailure(f"{label}: vectors vs the dense path: {e}") from None
    dom = (v[:, None] <= v[None]).all(-1) & (v[:, None] < v[None]).any(-1)
    check(not np.triu(dom.T, 1).any(), f"{label}: a member dominated by a later one")
    return not dom.any()


def phase_families(torch, dev, card, timings):
    """The rest of the search path at the paper's configuration (4 CNNs,
    L_max = 64, pop 40, 10 generations, 8 seeds): the weighted objective,
    NSGA-II, direct seeding, a Pareto service drain and LM workloads, each
    run with every launch count set to 0 just before it.  Returns
    {path: {kernel: launches}}."""
    import dataclasses

    import numpy as np

    from repro_torch.core import ga
    from repro_torch.core.engine import SearchEngine, SearchRequest
    from repro_torch.core.objectives import OBJECTIVE_WEIGHTS, OBJECTIVES
    from repro_torch.core.search import batched_search, joint_search_batched
    from repro_torch.imc.cost import evaluate_designs_arrays
    from repro_torch.serve.dse import DSEService, paper_request_mix

    ws = _paper_ws()
    counters = _counters()
    rec = timings["families"] = {"card": card}
    paths = {}
    seeds = list(range(PAPER_SEEDS))
    common = dict(pop_size=SERVE_POP, generations=SERVE_GENS, device=dev)
    B = len(OBJECTIVES) * PAPER_SEEDS
    feats = ws.feats[None].expand(B, -1, -1, -1)
    mask = ws.mask[None].expand(B, -1, -1)
    weights = [OBJECTIVE_WEIGHTS[k] for k in OBJECTIVES for _ in seeds]

    # weighted joint searches: the four rows x 8 seeds as one batch
    for backend, kname in (("kernel", "imc_eval"), ("table", "ga_gen_step")):
        _reset(counters)
        t0 = time.perf_counter()
        res = batched_search(seeds * len(OBJECTIVES), feats, mask, names=ws.names,
                             obj_weights=weights, backend=backend,
                             engine=SearchEngine(device=dev), **common)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read(counters)
        want = {"kernel": {"imc_eval": SERVE_GENS + 1}, "table": {}}[backend]
        check({k: v for k, v in got.items() if v} == want,
              f"weighted {backend}: launches {got}, want {want} (B2 serves the indexed "
              f"objective only)")
        paths[f"weighted/{backend}"] = got
        n_ok = _check_rescored(torch, dev, res, ws, f"weighted {backend}")
        check(n_ok >= B // 2, f"weighted {backend}: {n_ok} of {B} feasible")
        check([r.objective for r in res] == [k for k in OBJECTIVES for _ in seeds],
              f"weighted {backend}: labels {[r.objective for r in res][:5]}")
        if backend == "table":
            ela = joint_search_batched(seeds, ws, objective="ela", backend="table",
                                       engine=SearchEngine(device=dev), **common)
            for a, b in zip(ela, res[:PAPER_SEEDS]):
                check(_same_bits(a, b) and np.array_equal(a.ga.genomes, b.ga.genomes),
                      "weighted (1, 1, 1) on table: not the ela bits")
        log(f"weighted joint search --backend {backend} (4 rows x {PAPER_SEEDS} seeds, "
            f"one batch): {got[kname]} {kname} launches, {wall:.3f}s host clock; {n_ok} "
            f"feasible bests re-score to themselves"
            + ("; weights (1, 1, 1) give the ela bits" if backend == "table" else ""))
        rec[f"weighted/{backend}"] = dict(wall_s=wall, launches=got, feasible=n_ok)

    # Pareto through the CLI, then sequential against pipelined engines
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for backend, kname in (("kernel", "imc_eval"), ("table", "ga_gen_step")):
            out = Path(tmp) / f"pareto_{backend}.json"
            _reset(counters)
            t0 = time.perf_counter()
            rc, _ = _serve_main(["--objective", "pareto", "--pareto-k", "10", "--seeds",
                                 str(PAPER_SEEDS), "--pop", str(SERVE_POP), "--gens",
                                 str(SERVE_GENS), "--backend", backend, "--device",
                                 str(dev), "--out", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read(counters)
            check(rc == 0, f"--objective pareto --backend {backend} returned {rc}")
            want = {"kernel": {"imc_eval": SERVE_GENS + 1}, "table": {}}[backend]
            check({k: v for k, v in got.items() if v} == want,
                  f"pareto {backend}: launches {got}, want {want}")
            paths[f"pareto/{backend}"] = got
            entries = json.loads(out.read_text())
            fronts = [e.get("pareto_front") or [] for e in entries]
            check(len(entries) == PAPER_SEEDS and sum(map(bool, fronts)) >= PAPER_SEEDS // 2,
                  f"pareto {backend}: fronts of sizes {[len(f) for f in fronts]}")
            log(f"pareto CLI --backend {backend}: {got[kname]} {kname} launches, "
                f"{wall:.3f}s host clock, front sizes {[len(f) for f in fronts]}")
            rec[f"pareto_cli/{backend}"] = dict(wall_s=wall, launches=got,
                                                front_sizes=[len(f) for f in fronts])
    reqs = [SearchRequest(ws=ws, objective="pareto", pareto_k=10, seed=s, backend=b,
                          pop_size=SERVE_POP, generations=SERVE_GENS)
            for b in ("kernel", "table") for s in seeds]
    seq = SearchEngine(device=dev).run(reqs)
    pip = SearchEngine(device=dev, pipelined=True).run(reqs)
    n_mutual = n_front = 0
    for i, (a, b) in enumerate(zip(seq, pip)):
        check(_same_bits(a, b) and np.array_equal(a.objective_vectors, b.objective_vectors),
              f"pareto request {i}: pipelined front differs from sequential")
        if a.valid:
            n_front += 1
            n_mutual += _check_front(torch, dev, a, ws, f"pareto request {i}")
    check(n_front >= len(reqs) // 2, f"pareto engine runs: {n_front} of {len(reqs)} fronts")
    log(f"pareto engine runs ({len(reqs)} requests, kernel and table): sequential and "
        f"pipelined fronts bit for bit; {n_front} non-empty, every member feasible, "
        f"re-scoring to its vector, none dominated by a later one; {n_mutual} fronts "
        f"mutually non-dominated")
    rec["pareto_mutual"] = n_mutual

    # direct-seeded table searches: every seed fits and is valid; repeatable
    dreqs = [SearchRequest(ws=ws, seed=s, backend="table", pop_size=SERVE_POP,
                           generations=SERVE_GENS) for s in seeds]
    _reset(counters)
    runs = [SearchEngine(device=dev, direct_seed=True).run(dreqs) for _ in range(2)]
    got = _read(counters)
    paths["direct/table"] = got
    from repro_torch.core.engine import largest_workload_index

    wi = largest_workload_index(ws)
    for a, b in zip(*runs):
        check(_same_bits(a, b) and np.array_equal(a.ga.genomes, b.ga.genomes),
              "direct seed: two runs differ")
        g0 = torch.from_numpy(a.ga.genomes[0]).to(dev)
        from repro_torch.core import space

        r = evaluate_designs_arrays(space.decode(g0), ws.feats[wi][None].to(dev),
                                    ws.mask[wi][None].to(dev))
        check(bool(r.fits.all()) and bool(r.valid.all()),
              "direct seed: a seed does not fit its largest workload")
    n_ok = _check_rescored(torch, dev, runs[0], ws, "direct seed")
    log(f"direct-seeded table search ({PAPER_SEEDS} seeds, twice): every seed fits "
        f"{ws.names[wi]} and is V/f-valid, the runs are bit for bit, {n_ok} bests "
        f"re-score to themselves; launches {got}")

    # the service's 64-request mix turned Pareto, sequential and pipelined
    preqs = [dataclasses.replace(r, objective="pareto")
             for r in paper_request_mix(ws, 64, backend="table", pop_size=SERVE_POP,
                                        generations=SERVE_GENS)]
    drains = {}
    for mode in ("sequential", "pipelined", "pipelined", "sequential"):
        eng = SearchEngine(device=dev, pipelined=mode == "pipelined")
        svc = DSEService(engine=eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _drain(svc, preqs)
        torch.cuda.synchronize()
        drains.setdefault(mode, []).append((res, time.perf_counter() - t0, eng.launches))
    base = drains["sequential"][0][0]
    for mode, ds in drains.items():
        for res, _, _ in ds:
            check(all(_same_bits(a, b) and np.array_equal(a.objective_vectors,
                                                          b.objective_vectors)
                      for a, b in zip(base, res)), f"pareto service {mode}: bits differ")
    n_valid = sum(r.valid for r in base)
    check(n_valid >= 32, f"pareto service: {n_valid} of 64 fronts")
    rec["pareto_service"] = {m: [dict(wall_s=w, launches=n) for _, w, n in ds]
                             for m, ds in drains.items()}
    log("pareto service drain (64 table requests, sequential / pipelined / pipelined / "
        "sequential): " + ", ".join(f"{m} {w:.4f}s ({n} launches)"
                                    for m in drains for _, w, n in drains[m])
        + f"; bit for bit; {n_valid} of 64 fronts non-empty")

    # NSGA-II survival (2P = 80) and the front epilogue ((G+1) P = 440),
    # plain torch, at the CLI's batch of 8
    gen = _gen(torch, dev, 7)
    allo = torch.rand((PAPER_SEEDS, 2 * SERVE_POP, 3), generator=gen, device=dev) * 1e3
    allo[:, ::5] = math.inf  # infeasible candidates tie

    def survival():
        ga._crowded_order(*ga._crowded_order_keys(allo))

    gh = torch.rand((PAPER_SEEDS, SERVE_GENS + 1, SERVE_POP, 9), generator=gen, device=dev)
    oh = torch.rand((PAPER_SEEDS, SERVE_GENS + 1, SERVE_POP, 3), generator=gen, device=dev)

    def epilogue():
        ga.pareto_epilogue_batched(gh, oh, top_k=10)

    for name, fn in (("survival_2p80", survival), ("epilogue_440", epilogue)):
        fn()
        ms = cuda_ms(fn, 20)
        dev_ms = device_ms(torch, fn, 10)
        rec[f"nsga2/{name}"] = dict(B=PAPER_SEEDS, ms=ms, device_ms=dev_ms)
        log(f"NSGA-II {name} (B={PAPER_SEEDS}): {ms:.4f} ms per call, {_ms(dev_ms)} "
            f"on the device (plain torch; the front peel reads the device every "
            f"{ga.PEEL_BLOCK} fronts)")

    # LM layers as workloads: the CLI stops in the rejection seeder (mixtral
    # fits no design, as in the JAX package's CLI); a mix that fits runs on
    # table through SearchEngine(direct_seed=True) (B2) and, through the
    # example's deep-oversampled seeds, on kernel (B1)
    try:
        _serve_main(["--lm-workloads", "llama3.2-1b,mixtral-8x7b", "--mode", "decode",
                     "--backend", "table", "--seeds", "1", "--pop", str(SERVE_POP),
                     "--gens", "1", "--device", str(dev)])
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("could not seed" in raised and "0 found" in raised,
          f"llama3.2-1b + mixtral-8x7b decode: {raised or 'seeded'}")
    log("--lm-workloads llama3.2-1b,mixtral-8x7b --mode decode: 'could not seed ... 0 "
        "found' (mixtral's decode weights fit none of the grid's 12,000 capacity "
        "cells), as the JAX package's CLI")
    from repro_torch.configs.base import get_config
    from repro_torch.examples import lm_hw_cosearch
    from repro_torch.workloads.lm import lm_workload
    from repro_torch.workloads.pack import pack_workloads

    lm_area = lm_hw_cosearch.AREA
    lm_names = ("llama3.2-1b", "mamba2-780m")
    lm_ws = pack_workloads([(n, lm_workload(get_config(n), mode="decode"))
                            for n in lm_names])
    lreqs = [SearchRequest(ws=lm_ws, seed=s, backend="table", area_constr=lm_area,
                           pop_size=SERVE_POP, generations=SERVE_GENS) for s in seeds]
    _reset(counters)
    lres = SearchEngine(device=dev, direct_seed=True).run(lreqs)
    got = _read(counters)
    check(got["ga_gen_step"] == SERVE_GENS
          and not any(v for k, v in got.items() if k != "ga_gen_step"),
          f"LM table search: launches {got}")
    paths["lm/table"] = got
    n_lm = _check_rescored(torch, dev, lres, lm_ws, "LM table", area=lm_area)
    check(n_lm == PAPER_SEEDS, f"LM table: {n_lm} of {PAPER_SEEDS} seeds feasible")
    from repro_torch.core.objectives import make_objective

    lm_arch = lm_hw_cosearch.ARCHS
    lm_ws = pack_workloads([(n, lm_workload(get_config(n), mode="decode"))
                            for n in lm_arch])
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = Path(tmp) / "lm_kernel.json"
        _reset(counters)
        t0 = time.perf_counter()
        rc, _ = _captured(lm_hw_cosearch.main, [
            "--backend", "kernel", "--device", str(dev), "--pop", str(SERVE_POP),
            "--gens", str(SERVE_GENS), "--out", str(out)])
        wall = time.perf_counter() - t0
        got = _read(counters)
        check(rc == 0 and got["imc_eval"] > 0
              and not any(v for k, v in got.items() if k != "imc_eval"),
              f"LM kernel search (example): rc {rc}, launches {got}")
        paths["lm/kernel"] = got
        best = json.loads(out.read_text())
    n_k = 0
    for name, e in [("joint", best["joint"])] + list(best["separate"].items()):
        if e["best"] is None:
            continue
        on = lm_ws if name == "joint" else lm_ws.subset([lm_arch.index(name)])
        s = float(make_objective("ela", lm_area)(_dense_eval(torch, dev, [e["design"]],
                                                            on))[0])
        check(math.isclose(s, e["best"], rel_tol=1e-5),
              f"LM kernel {name}: best re-scores to {s}, reported {e['best']}")
        n_k += 1
    check(best["joint"]["best"] is not None, "LM kernel: the joint search found nothing")
    log(f"LM workloads {lm_names} decode, area {lm_area:g}: table search with "
        f"direct seeds {paths['lm/table']['ga_gen_step']} ga_gen_step launches, {n_lm} of "
        f"{PAPER_SEEDS} bests re-score to themselves; the example {lm_arch} (L_max "
        f"{lm_ws.feats.shape[1]}) on kernel {got['imc_eval']} imc_eval launches, "
        f"{wall:.2f}s, joint best {best['joint']['best']:.6g}, {n_k} bests (joint and "
        f"per model) re-score to themselves")
    rec["lm"] = dict(table=paths["lm/table"], kernel=got, kernel_wall_s=wall)
    rec["launches"] = paths
    return paths


# ---------------------------------------------------- threefry streams
THREEFRY_SEEDS = (0, 1, 2**31 - 1, 2**32 + 3, -1)
# the service's plan (64 slots, 10 generations, P=40: 1180 uniforms a
# block) and one rejection-seeder round (64 slots x 2560 candidates x 9)
THREEFRY_SLOTS, THREEFRY_TOT, THREEFRY_CAND = 64, 1180, 40 * 64


def _bits_equal(torch, a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _threefry_draws(torch, dev, timings):
    """The threefry primitives on the card against the CPU, bit for bit,
    and against jax's constants; the stream draw timed at the service's
    plan."""
    from repro_torch.core import prng as tf

    for seed in THREEFRY_SEEDS:
        k = tf.PRNGKey(seed, device=dev)
        check(k.tolist() == [0, seed % 2**32] and _bits_equal(torch, k, tf.PRNGKey(seed)),
              f"threefry: PRNGKey({seed}) on the card {k.tolist()}")
    k0 = tf.PRNGKey(0, device=dev)
    check(tf.split(k0).tolist() == THREEFRY_SPLIT0,
          f"threefry: split(PRNGKey(0)) on the card {tf.split(k0).tolist()}, jax "
          f"{THREEFRY_SPLIT0}")
    check(tf.split(k0, 64)[-1].tolist() == THREEFRY_SPLIT0_64_LAST,
          "threefry: split(PRNGKey(0), 64)[63] differs from jax's")
    for shape, (head, tail) in THREEFRY_UNIFORM0.items():
        words = tf.uniform(k0, shape).reshape(-1).view(torch.int32).cpu().tolist()
        check(words[:len(head)] == head and words[-len(tail):] == tail,
              f"threefry: uniform(PRNGKey(0), {shape}) differs from jax's words")
    keys = tf.split(tf.PRNGKey(7), THREEFRY_SLOTS)  # (64, 2) on the host
    for n in (2, 8, 64):
        check(_bits_equal(torch, tf.split(keys.to(dev), n), tf.split(keys, n)),
              f"threefry: split(keys, {n}) on the card differs from the CPU's")
    k_gen = tf.split(tf.split(keys)[:, 1], SERVE_GENS)  # (64, 10, 2)
    cases = {"stream (64, 10, 1180)": (k_gen, (THREEFRY_TOT,)),
             "seeder round (64, 2560, 9)": (keys, (THREEFRY_CAND, 9))}
    for label, (k, shape) in cases.items():
        check(_bits_equal(torch, tf.uniform(k.to(dev), shape), tf.uniform(k, shape)),
              f"threefry: uniform {label} on the card differs from the CPU's")
    g_card = tf.gumbel(keys[:16].to(dev), (32000,)).cpu()
    g_cpu = tf.gumbel(keys[:16], (32000,))
    gap = float(((g_card - g_cpu).abs() / g_cpu.abs().clamp_min(1.0)).max())
    check(bool(torch.isfinite(g_card).all()) and gap <= 1e-6,
          f"threefry: gumbel on the card lies {gap} from the CPU's (limit 1e-6)")

    # the plan's stream draw: device ms and launches, host ms to enqueue
    k_dev = k_gen.to(dev)

    def draw():
        return tf.uniform(k_dev, (THREEFRY_TOT,))

    draw()
    ms = cuda_ms(draw, 20)
    prof, _ = _profiled(torch, lambda: [draw() for _ in range(10)])
    per = device_kernels(prof, 10)
    dev_ms = sum(m for m, _ in per.values()) if per else None
    n_launch = sum(c for _, c in per.values()) / 10 if per else None
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks = tf.split(tf.split(keys)[:, 1], SERVE_GENS)
        tf.uniform(ks.to(dev, non_blocking=True), (THREEFRY_TOT,))
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    timings["threefry/stream"] = {"ms": ms, "device_ms": dev_ms,
                                  "launches_per_draw": n_launch,
                                  "host_ms": sorted(host)[len(host) // 2]}
    log(f"threefry draws: PRNGKey, split (2, 8, 64), the service's stream and a "
        f"seeder round equal the CPU's bit for bit, jax's constants held, gumbel "
        f"within {gap:.3g} of the CPU's; the plan's stream (64 x 10 x 1180): "
        f"{ms:.4f} ms per draw (events), device {_ms(dev_ms)} in "
        f"{n_launch} launches, host {sorted(host)[len(host) // 2]:.3f} ms (median) "
        f"to split the keys and enqueue it")


def _count_rounds(engine_mod, rounds):
    """Wrap ``engine._candidate_draws`` so each seeding call appends its
    number of rounds to ``rounds``; returns the undo."""
    real = engine_mod._candidate_draws

    def counting(source, n_cand, dev):
        draw = real(source, n_cand, dev)
        rounds.append(0)

        def wrapped(open_):
            rounds[-1] += 1
            return draw(open_)
        return wrapped

    engine_mod._candidate_draws = counting
    return lambda: setattr(engine_mod, "_candidate_draws", real)


def phase_threefry(torch, dev, card, timings):
    """The JAX package's threefry streams on the card: the draws against
    the CPU, the search CLI with ``--prng threefry`` on both kernel
    backends (phase 7's checks), each seed's generation-0 population
    against the CPU port's from the same key (both seeders), a 64-request
    ``--serve --backend table --prng threefry`` drain, and the quickstart
    example.  Returns {path: {kernel: launches}}."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.engine import SearchEngine, SearchRequest, plan_batch
    from repro_torch.examples import quickstart
    from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi
    from repro_torch.serve.dse import paper_request_mix

    rec = timings["threefry"] = {"card": card}
    _threefry_draws(torch, dev, timings)
    counters = _counters()
    paths = {"search_threefry": {}, "serve_threefry": {}}
    for backend, kname, counter in (("kernel", "imc_eval", imc_eval_multi),
                                    ("table", "ga_gen_step", ga_gen_step)):
        n = phase_main_path(torch, dev, backend, counter, prng="threefry", timings=timings)
        paths["search_threefry"][kname] = n
    for backend in ("kernel", "table"):
        t, f = timings[f"main_path/{backend}/torch"], timings[f"main_path/{backend}/threefry"]
        log(f"host clock of the search CLI --backend {backend}: torch streams "
            f"{t['wall_s']:.3f}s, threefry {f['wall_s']:.3f}s "
            f"({f['wall_s'] - t['wall_s']:+.3f}s)")

    # each CLI seed's generation-0 population on the card against the CPU
    # port's, from the same key, with the rejection and the direct seeder
    ws = _paper_ws()
    reqs = [SearchRequest(ws=ws, seed=s, backend="table", pop_size=SERVE_POP,
                          generations=1) for s in range(PAPER_SEEDS)]
    rounds = []
    undo = _count_rounds(engine_mod, rounds)
    try:
        for direct in (False, True):
            pops = [[r.ga.genomes[0] for r in SearchEngine(
                device=where, prng="threefry", direct_seed=direct).run(reqs)]
                for where in (dev, torch.device("cpu"))]
            for s, (a, b) in enumerate(zip(*pops)):
                check(a.shape == b.shape and (a.view("int32") == b.view("int32")).all(),
                      f"threefry seed {s}: generation 0 on the card differs from the "
                      f"CPU's ({'direct' if direct else 'rejection'} seeder)")
    finally:
        undo()
    rec["seeder_rounds"] = rounds
    log(f"threefry: the {PAPER_SEEDS} CLI seeds' generation-0 populations equal the "
        f"CPU port's bit for bit, with the rejection and the direct seeder; "
        f"rejection rounds per seeding call (card, CPU): {rounds}")

    # a 64-request table drain on the threefry streams
    n = 64
    plans = plan_batch(paper_request_mix(ws, n, backend="table", pop_size=SERVE_POP,
                                         generations=SERVE_GENS))
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = Path(tmp) / "serve_threefry.json"
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, text = _serve_main(["--serve", str(n), "--backend", "table", "--prng", "threefry",
                                "--pop", str(SERVE_POP), "--gens", str(SERVE_GENS),
                                "--device", str(dev), "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read(counters)
        check(rc == 0, f"--serve {n} --prng threefry returned {rc}")
        want = len(plans) * SERVE_GENS
        check(got["ga_gen_step"] == want and not any(v for k, v in got.items()
                                                     if k != "ga_gen_step"),
              f"--serve --prng threefry: launches {got}, want ga_gen_step {want}")
        entries = json.loads(out.read_text())
    n_ok, sample = _check_serve_entries(torch, dev, ws, "table", n, entries,
                                        "--serve --prng threefry", prng="threefry")
    paths["serve_threefry"] = {"imc_eval": got["imc_eval"], "ga_gen_step": got["ga_gen_step"]}
    rec["serve"] = dict(requests=n, plans=len(plans), launches=got["ga_gen_step"],
                        wall_s=wall, feasible=n_ok, alone_sample=sample)
    for ln in _summary_lines(text):
        log(ln)
    log(f"service --prng threefry: {n} requests in {len(plans)} plan(s), "
        f"{got['ga_gen_step']} ga_gen_step launches, {wall:.3f}s host clock; {n_ok} "
        f"feasible bests re-score to themselves; rids {sample} alone: bit for bit")

    # the quickstart example at the paper's configuration
    _reset(counters)
    t0 = time.perf_counter()
    rc, text = _captured(quickstart.main, ["--device", str(dev)])
    wall = time.perf_counter() - t0
    check(rc == 0 and "best generalized design" in text,
          f"quickstart returned {rc}: {text[-400:]}")
    rec["quickstart"] = {"wall_s": wall, "launches": _read(counters)}
    for ln in text.splitlines():
        if ln.strip():
            log(f"quickstart: {ln}")
    return paths


# phase 9e: the JAX package's public names that the port took over last
SURFACE_SEED = 0
SURFACE_DEMO_REQUESTS = 10


def _scores_agree(torch, a, b, rtol: float) -> bool:
    """Two score vectors: +inf at the same entries, the rest within rtol."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    return bool(torch.equal(fa, fb)) and bool(torch.allclose(a[fa], b[fb], rtol=rtol, atol=0.0))


def phase_surface(torch, dev, card, timings):
    """What the port took over last from the JAX package's public surface,
    on the card: ``make_eval_fn`` at the paper's shape (4 CNNs, P=40) on
    ``kernel`` (B1) and ``table`` against ``dense``; ``evaluate_designs_kernel``
    against the ``_arrays`` call and the plain path; ``run_search(...,
    pipelined=True)`` on ``kernel`` (B1) and ``table`` (B2) against the
    unpinned run; ``table_bytes`` / ``grid_table_shape`` of CUDA tables
    against CPU tables at densities 1 and 2; and ``examples/serve_demo``
    (reduced mixtral, B3).  Every launch count is set to 0 just before each
    path.  Returns {path: {kernel: launches}}."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core import space
    from repro_torch.core.engine import make_eval_fn, seed_population
    from repro_torch.core.search import run_search
    from repro_torch.examples import serve_demo
    from repro_torch.imc import cost
    from repro_torch.imc.tables import build_tables_arrays, grid_table_shape, table_bytes
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.imc_eval.ops import (evaluate_designs_kernel,
                                                  evaluate_designs_kernel_arrays)
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    ws = _paper_ws()
    counters = _counters()
    rec = timings["surface"] = {"card": card}
    paths = {}

    # make_eval_fn: 24 seeded designs (they fit the largest CNN) and 16
    # uniform ones (mostly infeasible) under a generous area
    gen = torch.Generator(device=dev)
    gen.manual_seed(SURFACE_SEED)
    genomes = torch.cat([seed_population(SURFACE_SEED, ws, 24, device=dev),
                         torch.rand((16, space.N_GENES), generator=gen, device=dev)])
    fns = {b: make_eval_fn(ws, "ela", 1e4, backend=b, device=dev)
           for b in ("dense", "kernel", "table")}
    dense = fns["dense"](genomes)
    _reset(counters)
    kern = fns["kernel"](genomes)
    torch.cuda.synchronize()
    paths["surface/eval_fn"] = got = _read(counters)
    check({k: v for k, v in got.items() if v} == {"imc_eval": 1},
          f"make_eval_fn('kernel'): launches {got}, want imc_eval 1")
    check(_scores_agree(torch, kern, dense, 1e-5),
          "make_eval_fn('kernel') differs from 'dense' beyond rtol 1e-5")
    _reset(counters)
    table = fns["table"](genomes)
    got = _read(counters)
    check(not any(got.values()), f"make_eval_fn('table'): launches {got}, want none")
    check(_scores_agree(torch, table, dense, 1e-5),
          "make_eval_fn('table') differs from 'dense' beyond rtol 1e-5")
    n_finite = int(torch.isfinite(dense).sum())
    check(n_finite >= 10, f"make_eval_fn: {n_finite} of 40 designs feasible")
    ms = {b: cuda_ms(lambda f=f: f(genomes), 20) for b, f in fns.items()}
    dms = {b: device_ms(torch, lambda f=f: f(genomes), 20) for b, f in fns.items()}
    rec["eval_fn_ms"], rec["eval_fn_device_ms"] = ms, dms
    log(f"make_eval_fn at P=40 over the 4 CNNs ({n_finite} feasible): 'kernel' (one B1 "
        f"launch) and 'table' within rtol 1e-5 of 'dense'; a call "
        + ", ".join(f"{b} {t:.4f} ms" for b, t in ms.items()) + " (CUDA events), device "
        "time " + ", ".join(f"{b} {_ms(t)}" for b, t in dms.items()) + " (profiler)")

    # evaluate_designs_kernel: the _arrays call's bits, the plain path's values
    d = space.decode(genomes)
    r = evaluate_designs_kernel(d, ws)
    ra = evaluate_designs_kernel_arrays(d, ws.feats.to(dev), ws.mask.to(dev))
    rp = cost.evaluate_designs(d, ws)
    for f in r._fields:
        check(torch.equal(getattr(r, f), getattr(ra, f)),
              f"evaluate_designs_kernel: {f} differs from the _arrays call")
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        check(bool(torch.allclose(getattr(r, f), getattr(rp, f), rtol=1e-5, atol=0.0)),
              f"evaluate_designs_kernel: {f} beyond rtol 1e-5 of the plain path")
    for f in ("fits", "valid"):
        check(torch.equal(getattr(r, f), getattr(rp, f)),
              f"evaluate_designs_kernel: {f} differs from the plain path")
    log("evaluate_designs_kernel(d, ws): the _arrays call's bits; energy, latency, area "
        "and util within rtol 1e-5 of the plain path, fits and valid equal")

    # run_search(pipelined=True) against the unpinned run, in turns
    # unpinned, pipelined, pipelined, unpinned (each on its shared engine)
    kw = dict(pop_size=SERVE_POP, generations=SERVE_GENS, device=dev)
    for backend, kname, want in (("kernel", "imc_eval", SERVE_GENS + 1),
                                 ("table", "ga_gen_step", SERVE_GENS)):
        walls = {"unpinned": [], "pipelined": []}
        runs = {}
        for mode in ("unpinned", "pipelined", "pipelined", "unpinned"):
            pin = dict(pipelined=True) if mode == "pipelined" else {}
            _reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_search(SURFACE_SEED, ws, backend=backend, **pin, **kw)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            got = _read(counters)
            check({k: v for k, v in got.items() if v} == {kname: want},
                  f"run_search({mode}, backend={backend!r}): launches {got}, "
                  f"want {kname} {want}")
            if mode == "pipelined":
                paths[f"surface/pipelined/{backend}"] = got
            runs.setdefault(mode, res)
        res, plain = runs["pipelined"], runs["unpinned"]
        check(res.ga is None and plain.ga is not None,
              f"run_search(pipelined=True, backend={backend!r}): ga {type(res.ga)}")
        check(np.array_equal(res.top_genomes, plain.top_genomes)
              and np.array_equal(res.top_scores, plain.top_scores)
              and np.array_equal(res.convergence, plain.convergence)
              and res.top_designs == plain.top_designs,
              f"run_search(pipelined=True, backend={backend!r}) differs from the unpinned run")
        check(res.valid, f"run_search(pipelined=True, backend={backend!r}): no feasible design")
        rec[f"pipelined/{backend}"] = dict(wall_s=walls["pipelined"],
                                           unpinned_wall_s=walls["unpinned"],
                                           launches=paths[f"surface/pipelined/{backend}"])
        log(f"run_search(pipelined=True) --backend {backend}: {want} {kname} launches a "
            f"run; host clock in turns unpinned {walls['unpinned'][0]:.4f}s, pipelined "
            f"{walls['pipelined'][0]:.4f}s, pipelined {walls['pipelined'][1]:.4f}s, "
            f"unpinned {walls['unpinned'][1]:.4f}s; top genomes, scores and convergence "
            f"equal the unpinned run's bit for bit, ga is None")

    # table_bytes / grid_table_shape: CUDA tables against CPU tables
    shapes = {}
    try:
        for density in (1, 2):
            space.configure_grid(density)
            cpu = build_tables_arrays(ws.feats, ws.mask)
            card_t = build_tables_arrays(ws.feats.to(dev), ws.mask.to(dev))
            shape = grid_table_shape()
            check(tuple(card_t.demand.shape[-3:]) == (shape["rows"], shape["cols"],
                                                      shape["bits_cell"])
                  and card_t.spill.shape[-1] == shape["glb_mb"],
                  f"density {density}: tables {tuple(card_t.demand.shape)} against the "
                  f"grid {shape}")
            check(table_bytes(card_t) == table_bytes(cpu),
                  f"density {density}: table_bytes {table_bytes(card_t)} on the card, "
                  f"{table_bytes(cpu)} on the CPU")
            for f in cpu._fields:
                a, b = getattr(card_t, f).cpu(), getattr(cpu, f)
                check(bool(torch.allclose(a, b, rtol=1e-5, atol=0.0)),
                      f"density {density}: table {f} on the card beyond rtol 1e-5 of the CPU's")
            shapes[density] = dict(shape, bytes=table_bytes(card_t))
    finally:
        space.configure_grid(1)
    check(shapes[2]["bytes"] > shapes[1]["bytes"], f"table bytes by density: {shapes}")
    rec["tables"] = shapes
    log(f"table_bytes / grid_table_shape, CUDA tables against CPU tables (rtol 1e-5): "
        f"{shapes}; density 1 restored")

    # the serve demo: reduced mixtral, B3 once per layer and prefill; each
    # B3 call's inputs and output are kept and held against the plain
    # version after the run
    cfg = get_config("mixtral-8x7b").reduced()
    reqs = serve_demo.burst(cfg, SURFACE_DEMO_REQUESTS)
    calls, real_attention = [], transformer._attention

    def kept_attention(q, k, v, **kw):
        o = real_attention(q, k, v, **kw)
        calls.append((q.clone(), k.clone(), v.clone(), kw, o.clone()))
        return o

    _reset(counters)
    transformer._attention = kept_attention
    try:
        t0 = time.perf_counter()
        rc, text = _captured(serve_demo.main, ["--device", str(dev), "--requests",
                                               str(SURFACE_DEMO_REQUESTS)])
        wall = time.perf_counter() - t0
    finally:
        transformer._attention = real_attention
    got = _read(counters)
    paths["serve_demo"] = got
    want = SURFACE_DEMO_REQUESTS * cfg.n_layers
    check(rc == 0, f"serve_demo returned {rc}")
    check({k: v for k, v in got.items() if v} == {"flash_attention": want},
          f"serve_demo: launches {got}, want flash_attention {want}")
    m = re.search(r"served (\d+) requests, (\d+) tokens in \S+s \((\S+) tok/s on (.+)\)$",
                  text.splitlines()[0] if text else "")
    check(m is not None and int(m.group(1)) == len(reqs)
          and int(m.group(2)) == sum(r.max_new for r in reqs)
          and m.group(4) == torch.cuda.get_device_name(dev),
          f"serve_demo: every request its max_new on the card: {text[:300]!r}")
    check(len(calls) == want, f"serve_demo: {len(calls)} B3 calls kept, want {want}")
    demo_err, demo_shapes = 0.0, set()
    for q, k, v, kw, o in calls:
        check(kw["impl"] != "plain", f"serve_demo: attention on the plain path ({kw})")
        kw = dict(causal=kw["causal"], window=kw["window"])
        err = float((o.float() - attention_reference(q, k, v, **kw).float()).abs().max())
        check(bool(torch.isfinite(o).all()) and err <= 3e-2,
              f"serve_demo: B3 at q {tuple(q.shape)}, kv {tuple(k.shape)}, {kw}: max abs "
              f"err {err} against the plain version (tol 3e-2)")
        demo_err = max(demo_err, err)
        demo_shapes.add((tuple(q.shape), tuple(k.shape), str(q.dtype)))
    rec["serve_demo"] = dict(wall_s=wall, tokens_per_s=float(m.group(3)), launches=got,
                             b3_max_abs_err=demo_err)
    for ln in text.splitlines():
        log(f"serve_demo: {ln}")
    log(f"serve_demo: {got['flash_attention']} flash_attention launches "
        f"({SURFACE_DEMO_REQUESTS} prefills x {cfg.n_layers} layers), {wall:.3f}s with "
        f"set-up; each B3 call within max abs err {demo_err:.3g} of the plain version "
        f"(tol 3e-2) over {len(demo_shapes)} shapes "
        f"{sorted(q[1] for q, _, _ in demo_shapes)} (Sq = Skv, bf16)")
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 9e: {rec['wall_s']:.3f}s host clock")
    return paths


# ------------------------------------------------------------ search mesh
# phase 9d: the CLI runs held to the meshless bits (phase 7's search
# commands and a 64-request table drain), the two-rank meshes that share
# the card under gloo, and the two ranks' deadline
MESH_RUNS = (("search", "kernel"), ("search", "table"), ("serve", "table"))
MESH_SHAPES = ("2x1", "1x2")
MESH_SERVE_N = 64
MESH_DEADLINE_S = 420
MESH_KERNELS = ("imc_eval", "ga_gen_step")


def _mesh_argv(kind, backend, dev, out, shape=None):
    """The CLI's argv of one phase-9d run: the search path with phase 7's
    flags, or the 64-request table drain, on ``--search-mesh shape``."""
    if kind == "search":
        argv = ["--seeds", str(PAPER_SEEDS), "--pop", "40", "--gens", "10", "--separate",
                "--backend", backend]
    else:
        argv = ["--serve", str(MESH_SERVE_N), "--backend", backend, "--pop", str(SERVE_POP),
                "--gens", str(SERVE_GENS)]
    argv += ["--device", str(dev), "--out", str(out)]
    if shape is not None:
        argv += ["--search-mesh", shape]
    return argv


def _mesh_run(torch, argv, counters) -> dict:
    """One CLI run, every launch count and the collective counts set to 0
    just before it: host clock, B1 / B2 launches, collective calls and
    bytes."""
    from repro_torch.core import distributed as mdist
    from repro_torch.launch.search import main

    _reset(counters)
    mdist.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, text = _captured(main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} returned {rc}: {text[-400:]}")
    got = _read(counters)
    return {"wall_s": wall, "launches": got, "collective_calls": mdist.STATS.calls,
            "collective_bytes": mdist.STATS.bytes}


def _mesh_entries(path: Path) -> list:
    """A run's ``--out`` entries without their host clocks."""
    entries = json.loads(path.read_text())
    for e in entries:
        e.pop("wall_s", None)
    return entries


def _gloo_takes_cuda(torch) -> str:
    """Gloo all-gathers CUDA tensors (the mesh's all-gathers hand it the
    card's tensors of ranks sharing the card); fails the phase if not."""
    import torch.distributed as dist

    x = torch.full((3,), float(dist.get_rank()), device="cuda")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    got = [float(p[0]) for p in parts]
    check(got == [float(r) for r in range(len(parts))], f"gloo all_gather of CUDA tensors: {got}")
    return "yes"


def mesh_worker(outdir: str) -> int:
    """One rank of phase 9d's two ranks sharing the card under gloo
    (``chip_smoke.py --mesh-worker DIR``; ``phase_mesh`` starts both with
    torchrun's variables): every run of ``MESH_RUNS`` on each of
    ``MESH_SHAPES``, rank 0 writing the ``--out`` files, each rank its
    counts to ``DIR/rank<r>.json``."""
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_world

    rank, world, dev = init_world("cuda", backend="gloo")
    out = Path(outdir)
    rec = {"rank": rank, "world": world, "device": str(dev),
           "gloo_cuda": _gloo_takes_cuda(torch), "runs": []}
    counters = _counters()
    for turn in range(2):  # the first turn also warms the rank up
        for shape in MESH_SHAPES:
            for kind, backend in MESH_RUNS:
                path = out / f"{kind}_{backend}_{shape}_{turn}.json"
                r = _mesh_run(torch, _mesh_argv(kind, backend, dev, path, shape), counters)
                rec["runs"].append({"turn": turn, "shape": shape, "kind": kind,
                                    "backend": backend, **r})
    torch.distributed.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(tmp: Path) -> list:
    """Start both ranks of the gloo world as subprocesses and wait for
    them within ``MESH_DEADLINE_S`` (killed past it); any rank's failure
    fails the phase.  Returns each rank's record."""
    import os

    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        logf = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        "--mesh-worker", str(tmp)], env=env, cwd=str(ROOT),
                                       stdout=logf, stderr=subprocess.STDOUT), logf))
    deadline = time.monotonic() + MESH_DEADLINE_S
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"two-rank mesh run passed its {MESH_DEADLINE_S} s deadline")
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    for r, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"mesh rank {r} exited {p.returncode}: "
              + (tmp / f"rank{r}.log").read_text()[-1500:])
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


def phase_mesh(torch, dev, card, timings):
    """The search CLI and the service on a mesh of ranks (``--search-mesh``,
    ``DSEService(mesh=)``): (a) a world of one under NCCL, ``1x1``; (b) two
    ranks sharing the card under gloo, ``2x1`` and ``1x2``, each run twice
    (the first turn warms the fresh processes up).  Each run on ``kernel``
    and ``table`` (phase 7's search) and the 64-request table drain must
    write the meshless run's results and launch its backend's kernel on
    every rank as often as the meshless run.  The meshless and the 1x1 runs
    go in turns meshless, 1x1, 1x1, meshless.  Returns {path: {kernel:
    launches}}."""
    import torch.distributed as dist

    counters = _counters()
    rec = timings["mesh"] = {"card": card, "runs": []}
    paths = {"search_mesh": dict.fromkeys(MESH_KERNELS, 0),
             "serve_mesh": dict.fromkeys(MESH_KERNELS, 0)}
    kname = {"kernel": "imc_eval", "table": "ga_gen_step"}

    def held(kind, backend, label, run, entries, ref, count=True):
        want = {k: (v if k == kname[backend] else 0) for k, v in ref[0]["launches"].items()}
        got = {k: run["launches"][k] for k in want}
        check(got == want and got[kname[backend]] > 0,
              f"{label} {kind} --backend {backend}: launches {got}, the meshless run's {want}")
        check(entries == ref[1], f"{label} {kind} --backend {backend}: results differ from "
              "the meshless run's")
        path = "search_mesh" if kind == "search" else "serve_mesh"
        for k in MESH_KERNELS:
            paths[path][k] += run["launches"][k] if count else 0

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        ref, walls = {}, {}
        # the meshless runs and (a) a world of one under NCCL, in turns
        for kind, backend in MESH_RUNS:
            clocks = {None: [], "1x1": []}
            for turn, shape in enumerate((None, "1x1", "1x1", None)):
                out = tmp / f"{kind}_{backend}_{shape}_{turn}.json"
                r = _mesh_run(torch, _mesh_argv(kind, backend, dev, out, shape), counters)
                entries = _mesh_entries(out)
                if (kind, backend) not in ref:
                    ref[(kind, backend)] = (r, entries)
                if shape is None:
                    held(kind, backend, "meshless", r, entries, ref[(kind, backend)],
                         count=False)
                else:
                    check(dist.get_backend() == "nccl", f"1x1 ran on {dist.get_backend()}")
                    held(kind, backend, "1x1 (NCCL)", r, entries, ref[(kind, backend)])
                clocks[shape].append(r["wall_s"])
                rec["runs"].append({"mesh": shape, "turn": turn, "kind": kind,
                                    "backend": backend, **r})
            walls[(kind, backend)] = clocks[None]
            log(f"mesh 1x1 (NCCL, world of one) {kind} --backend {backend}: host clock "
                f"{', '.join(f'{w:.3f}' for w in clocks['1x1'])}s against the meshless "
                f"{', '.join(f'{w:.3f}' for w in clocks[None])}s (turns meshless, 1x1, "
                f"1x1, meshless; the first 1x1 run of the phase makes the process "
                f"group), launches {r['launches']}, {r['collective_calls']} collectives "
                f"({r['collective_bytes']} bytes); the meshless run's results")
        dist.destroy_process_group()
        # (b) two ranks sharing the card under gloo
        t0 = time.perf_counter()
        ranks = _two_ranks(tmp)
        rec["two_ranks_wall_s"] = time.perf_counter() - t0
        rec["gloo_cuda"] = ranks[0]["gloo_cuda"]
        log(f"two ranks on {card} under gloo ({rec['two_ranks_wall_s']:.1f}s with their "
            f"start): gloo takes CUDA tensors: {ranks[0]['gloo_cuda']}")
        for i, run0 in enumerate(ranks[0]["runs"]):
            turn, shape = run0["turn"], run0["shape"]
            kind, backend = run0["kind"], run0["backend"]
            entries = _mesh_entries(tmp / f"{kind}_{backend}_{shape}_{turn}.json")
            for rk in ranks:
                run = rk["runs"][i]
                held(kind, backend, f"{shape} rank {rk['rank']} (gloo)", run, entries,
                     ref[(kind, backend)])
                rec["runs"].append({"mesh": shape, "rank": rk["rank"], **{
                    k: v for k, v in run.items() if k != "shape"}})
            if turn == 0:
                continue
            log(f"mesh {shape} (gloo, two ranks on one card) {kind} --backend {backend}: "
                + "; ".join(f"rank {rk['rank']} {rk['runs'][i]['wall_s']:.3f}s host clock, "
                            f"launches {rk['runs'][i]['launches']}, "
                            f"{rk['runs'][i]['collective_calls']} collectives "
                            f"({rk['runs'][i]['collective_bytes']} bytes)" for rk in ranks)
                + f"; the meshless {', '.join(f'{w:.3f}' for w in walls[(kind, backend)])}s;"
                " the meshless run's results (both turns)")
    log(f"mesh launches: {paths}")
    return paths


# ----------------------------------------------------------- LM kernels
def _gen(torch, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def attn_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the masks leave, counted for this shape."""
    import numpy as np

    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= qp >= kp
    if window > 0:
        m &= (qp - kp) < window
    return int(m.sum())


# label, B, Sq, Skv, H, KV, D, causal, window, q_offset, dtype, timed
B3_CASES = [
    ("s128", 1, 128, 128, 32, 8, 64, True, 0, 0, "bf16", True),
    ("s1024", 1, 1024, 1024, 32, 8, 64, True, 0, 0, "bf16", True),
    ("s2048", 1, 2048, 2048, 32, 8, 64, True, 0, 0, "bf16", True),
    # the other models' prefill shapes: mixtral (window 4096), qwen3-moe,
    # qwen2-vl (1024 vision + 1024 text), whisper's encoder and
    # cross-attention (non-causal MHA), and a cross-attention of fewer
    # queries than frames
    ("mixtral_s1024", 1, 1024, 1024, 32, 8, 128, True, 4096, 0, "bf16", True),
    ("qwen3moe_s1024", 1, 1024, 1024, 64, 4, 128, True, 0, 0, "bf16", False),
    ("qwen2vl_s2048", 1, 2048, 2048, 12, 2, 128, True, 0, 0, "bf16", False),
    ("whisper_enc_s1024", 1, 1024, 1024, 16, 16, 64, False, 0, 0, "bf16", False),
    ("whisper_xattn_s1024", 1, 1024, 1024, 16, 16, 64, False, 0, 0, "bf16", False),
    ("whisper_xattn_sq512", 1, 512, 1024, 16, 16, 64, False, 0, 0, "bf16", False),
    # whisper over frame counts that are no multiple of the 128-row KV
    # block (its own 1500, and 200): the models' ragged_kv=True calls
    ("whisper_enc_s1500", 1, 1500, 1500, 16, 16, 64, False, 0, 0, "bf16", False),
    ("whisper_enc_s200", 1, 200, 200, 16, 16, 64, False, 0, 0, "bf16", False),
    ("whisper_xattn_sq200_skv1500", 1, 200, 1500, 16, 16, 64, False, 0, 0, "bf16", False),
    ("ragged_sq100", 2, 100, 128, 4, 2, 64, True, 0, 0, "bf16", False),
    ("ragged_s1000", 1, 1000, 1000, 32, 8, 64, True, 0, 0, "bf16", False),
    ("window96", 1, 256, 256, 4, 2, 64, True, 96, 0, "bf16", False),
    ("q_offset128", 1, 64, 192, 4, 2, 64, True, 0, 128, "bf16", False),
    ("d80", 2, 128, 128, 4, 1, 80, True, 0, 0, "bf16", False),
    # the JAX kernel sweep (tests/test_kernels.py:11-17) in float32
    ("sweep0", 2, 128, 128, 4, 2, 64, True, 0, 0, "f32", False),
    ("sweep1", 1, 256, 256, 8, 8, 64, True, 0, 0, "f32", False),
    ("sweep2", 2, 128, 128, 4, 1, 80, True, 0, 0, "f32", False),
    ("sweep3", 1, 256, 256, 4, 2, 64, True, 96, 0, "f32", False),
    ("sweep4", 2, 100, 128, 4, 2, 64, True, 0, 0, "f32", False),
    ("sweep5", 1, 64, 64, 2, 2, 128, True, 0, 0, "f32", False),
    ("d16", 1, 128, 128, 4, 2, 16, True, 0, 0, "f32", False),
    ("noncausal", 1, 128, 256, 4, 2, 64, False, 0, 0, "f32", False),
    # rows with no valid key (window behind the keys): a uniform average
    ("keyless_rows", 1, 64, 128, 4, 2, 64, True, 32, 400, "f32", False),
    # the same edges through the tensor-core (bf16) kernel
    ("bf16_sweep4", 2, 100, 128, 4, 2, 64, True, 0, 0, "bf16", False),
    ("bf16_sweep5", 1, 64, 64, 2, 2, 128, True, 0, 0, "bf16", False),
    ("bf16_d16", 1, 128, 128, 4, 2, 16, True, 0, 0, "bf16", False),
    ("bf16_noncausal", 1, 128, 256, 4, 2, 64, False, 0, 0, "bf16", False),
    ("bf16_keyless_rows", 1, 64, 128, 4, 2, 64, True, 32, 400, "bf16", False),
    # gemma-7b's prefill shape (MHA, D=256) and D=256 at the edges: a
    # window, a ragged Sq, rows with no valid key; float32 at D=256; a D
    # that TMA cannot address as it is (the wrapper pads it to 40)
    ("gemma_s1024", 1, 1024, 1024, 16, 16, 256, True, 0, 0, "bf16", True),
    ("d256_window96", 1, 256, 256, 4, 2, 256, True, 96, 0, "bf16", False),
    ("d256_ragged_sq100", 2, 100, 128, 4, 2, 256, True, 0, 0, "bf16", False),
    ("bf16_d256_keyless_rows", 1, 64, 128, 4, 2, 256, True, 32, 400, "bf16", False),
    ("d256_f32", 1, 256, 256, 4, 2, 256, True, 96, 0, "f32", False),
    ("bf16_d36_padded", 1, 96, 96, 2, 1, 36, True, 0, 0, "bf16", False),
    # the serve demo's prefills (reduced mixtral, D=16, window 4096): KV
    # tiles of fewer than 16 rows; phase 9e holds every one of its calls
    ("demo_d16_s4", 1, 4, 4, 4, 2, 16, True, 4096, 0, "bf16", False),
    ("demo_d16_s21", 1, 21, 21, 4, 2, 16, True, 4096, 0, "bf16", False),
    # causal calls of more query tiles than SMs pair tiles in a block: an
    # odd tile count (the middle tile alone) with a q_offset, a real window
    ("paired_s990_q_offset128", 1, 990, 1118, 32, 8, 64, True, 0, 128, "bf16", False),
    ("paired_window256_d128", 1, 1024, 1024, 32, 8, 128, True, 256, 0, "bf16", False),
    ("paired_d256_g4", 1, 1024, 1024, 32, 8, 256, True, 0, 0, "bf16", False),
]


def phase_b3(torch, dev, timings):
    """flash_attention against ``attention_reference`` on the card."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_reference

    F = torch.nn.functional
    gen = _gen(torch, dev, 3)
    errs = {}
    for (label, B, Sq, Skv, H, KV, D, causal, window, q_offset, dt, timed) in B3_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        before = flash_attention.launches
        o = flash_attention(q, k, v, ragged_kv=True, **kw)
        r = attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        check(flash_attention.launches == before + 1, f"B3 {label}: launch not counted")
        check(o.dtype == dtype and tuple(o.shape) == (B, Sq, H, D), f"B3 {label}: output")
        check(bool(torch.isfinite(o).all()), f"B3 {label}: not finite")
        err = float((o.float() - r.float()).abs().max())
        tol = 3e-2 if dt == "bf16" else 2e-5
        check(err <= tol, f"B3 {label}: max abs err {err} > {tol}")
        errs[label] = err
        log(f"B3 {label} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, KV={KV}, D={D}, {dt}, "
            f"causal={causal}, window={window}, q_offset={q_offset}): ok, max abs "
            f"err {err:.3g} (tol {tol})")
        if not timed:
            continue

        def plain_fn(q=q, k=k, v=v, kw=kw):
            attention_reference(q, k, v, **kw)

        def kernel_fn(q=q, k=k, v=v, kw=kw):
            flash_attention(q, k, v, ragged_kv=True, **kw)

        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library_fn(qh=qh, kh=kh, vh=vh):
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)

        iters = 50 if Sq <= 1024 else 20
        k_ms, p_ms = timed_pair(plain_fn, kernel_fn, iters)
        l_ms, _ = timed_pair(plain_fn, library_fn, iters)
        elem = q.element_size()
        n_bytes = elem * (2 * q.numel() + k.numel() + v.numel())
        ops = 4.0 * D * attn_pairs(Sq, Skv, causal, window, q_offset) * H * B
        b_ms, b_by = bound(n_bytes, ops, PEAK_BF16_S if dt == "bf16" else PEAK_FP32_S)
        k_dev = device_ms(torch, kernel_fn, 10, KERNEL_PREFIX["flash_attention"])
        p_dev = device_ms(torch, plain_fn, 10)
        l_dev = device_ms(torch, library_fn, 10)
        timings[f"flash_attention/{label}"] = dict(
            B=B, S=Sq, H=H, KV=KV, D=D, dtype=dt, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
            device_ms=k_dev, plain_device_ms=p_dev, library_device_ms=l_dev,
            bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=ops, max_abs_err=err)
        log(f"B3 {label}: kernel {k_ms:.4f} ms per call ({_ms(k_dev)} on the device), "
            f"plain {p_ms:.4f} ms ({_ms(p_dev)}), SDPA {l_ms:.4f} ms ({_ms(l_dev)}), "
            f"bound {b_ms:.6f} ms ({b_by})")
        if dt == "bf16":
            # the host cost a call adds for its four TMA descriptors
            enc = _b3_encode_us(B, Sq, Skv, H, KV, D)
            timings[f"flash_attention/{label}"]["encode_us"] = enc
            log(f"B3 {label}: encoding the four tensor maps takes {enc:.3f} us on the host")
    return errs


def _b3_encode_us(B, Sq, Skv, H, KV, D, iters=2000) -> float:
    """Host microseconds to encode one call's four TMA descriptors (the
    library's own clock, no launch)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_attention_encode_us
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_double
    us = fn(B, Sq, Skv, H, KV, D, iters)
    check(us >= 0, f"B3: the tensor-map encoder refused B={B}, Sq={Sq}, H={H}, KV={KV}, D={D}")
    return us


def ssd_inputs(torch, B, S, H, P, N, gen, dev, dtype):
    """The JAX kernel tests' distributions: unit-normal x, B, C;
    dt = softplus(normal); A = -exp(normal / 2)."""
    F = torch.nn.functional
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.5)
    Bm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_ops(B, S, H, P, N, Q) -> float:
    """FLOPs of the chunked algorithm: causal scores and intra-chunk
    product, inter-chunk output and state update, per chunk and head."""
    per = 2 * Q * (Q + 1) / 2 * (N + P) + 4 * N * P * Q
    return float(per * B * H * (S // Q))


# label, B, S, H, P, N, chunk, dtype, h0, timed
B4_CASES = [
    ("s96", 1, 96, 48, 64, 128, 128, "f32", False, False),
    ("s128", 1, 128, 48, 64, 128, 128, "f32", False, False),
    ("s1024", 1, 1024, 48, 64, 128, 128, "f32", False, True),
    ("s2048", 1, 2048, 48, 64, 128, 128, "f32", False, False),
    # the JAX kernel sweep (tests/test_kernels.py:70-75)
    ("sweep0", 2, 256, 4, 64, 128, 128, "f32", False, False),
    ("sweep1", 1, 128, 8, 32, 64, 32, "f32", False, False),
    ("sweep2", 2, 64, 2, 16, 32, 64, "f32", False, False),
    ("sweep3", 1, 512, 4, 64, 128, 128, "f32", False, False),
    # the model's dtype
    ("bf16_s96", 1, 96, 48, 64, 128, 128, "bf16", False, False),
    ("bf16_s128", 1, 128, 48, 64, 128, 128, "bf16", False, True),
    ("bf16_s1024", 1, 1024, 48, 64, 128, 128, "bf16", False, True),
    ("bf16_s2048", 1, 2048, 48, 64, 128, 128, "bf16", False, True),
    ("bf16_sweep0", 2, 256, 4, 64, 128, 128, "bf16", False, False),
    ("bf16_sweep1", 1, 128, 8, 32, 64, 32, "bf16", False, False),
    ("bf16_sweep2", 2, 64, 2, 16, 32, 64, "bf16", False, False),
    ("bf16_sweep3", 1, 512, 4, 64, 128, 128, "bf16", False, False),
    ("bf16_h0", 1, 1024, 48, 64, 128, 128, "bf16", True, False),
    ("bf16_b2", 2, 1024, 48, 64, 128, 128, "bf16", False, False),
    # jamba's Mamba layers: H=128, P=64, N=16
    ("jamba_bf16_s1024", 1, 1024, 128, 64, 16, 128, "bf16", False, True),
]


def phase_b4(torch, dev, timings):
    """ssd_scan against ``ref.ssd_chunked`` on the card.  float32: y and h
    within 1e-4 of the output's scale (max(1, max|ref|)); bf16 inputs: y
    (rounded to bf16 by both) within 1e-2 of its scale, h within 1e-4.
    Timed cases log each of the call's three kernels' device time; then
    the batch-invariance case."""
    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked

    gen = _gen(torch, dev, 4)
    errs = {}
    for (label, B, S, H, P, N, chunk, dt, with_h0, timed) in B4_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, dtv, A, Bm, Cm = ssd_inputs(torch, B, S, H, P, N, gen, dev, dtype)
        h0 = torch.randn((B, H, N, P), generator=gen, device=dev) if with_h0 else None
        before = ssd_chunked.launches
        y, h = ssd_chunked(x, dtv, A, Bm, Cm, h0, chunk=chunk)
        yr, hr = ref.ssd_chunked(x, dtv, A, Bm, Cm, h0, chunk=chunk)
        torch.cuda.synchronize()
        check(ssd_chunked.launches == before + 1, f"B4 {label}: launch not counted")
        check(y.dtype == dtype and tuple(y.shape) == (B, S, H, P), f"B4 {label}: y")
        check(h.dtype == torch.float32 and tuple(h.shape) == (B, H, N, P), f"B4 {label}: h")
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()), f"B4 {label}: not finite")
        ey = float((y.float() - yr.float()).abs().max())
        eh = float((h - hr).abs().max())
        sy = max(1.0, float(yr.float().abs().max()))
        sh = max(1.0, float(hr.abs().max()))
        tol_y = (1e-2 if dt == "bf16" else 1e-4) * sy
        check(ey <= tol_y, f"B4 {label}: y max abs err {ey} > {tol_y}")
        check(eh <= 1e-4 * sh, f"B4 {label}: h max abs err {eh} > {1e-4 * sh}")
        errs[label] = (ey, eh)
        log(f"B4 {label} (B={B}, S={S}, H={H}, P={P}, N={N}, chunk={min(chunk, S)}, {dt}, "
            f"h0={with_h0}): "
            f"ok, max abs err y {ey:.3g} (max |y| {sy:.4g}), h {eh:.3g} (max |h| {sh:.4g})")
        if not timed:
            continue

        def plain_fn(a=(x, dtv, A, Bm, Cm), chunk=chunk):
            ref.ssd_chunked(*a, chunk=chunk)

        def kernel_fn(a=(x, dtv, A, Bm, Cm), chunk=chunk):
            ssd_chunked(*a, chunk=chunk)

        k_ms, p_ms = timed_pair(plain_fn, kernel_fn, 20)
        elem = x.element_size()
        n_bytes = (elem * (2 * x.numel() + Bm.numel() + Cm.numel())
                   + 4 * (dtv.numel() + A.numel() + B * H * N * P))
        ops = ssd_ops(B, S, H, P, N, min(chunk, S))
        b_ms, b_by = bound(n_bytes, ops, PEAK_BF16_S if dt == "bf16" else PEAK_FP32_S)
        parts = device_parts(torch, kernel_fn, 10, KERNEL_PREFIX["ssd_scan"])
        k_dev = sum(parts.values()) if parts else None
        p_dev = device_ms(torch, plain_fn, 10)
        timings[f"ssd_scan/{label}"] = dict(
            B=B, S=S, H=H, P=P, N=N, dtype=dt, ms=k_ms, plain_ms=p_ms, device_ms=k_dev,
            plain_device_ms=p_dev, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=ops,
            max_abs_err_y=ey, max_abs_err_h=eh, device_parts=parts)
        log(f"B4 {label}: kernel {k_ms:.4f} ms per call ({_ms(k_dev)} on the device: "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in parts.items())
            + f"), plain {p_ms:.4f} ms ({_ms(p_dev)}), bound {b_ms:.6f} ms ({b_by})")
    b4_batch_invariance(torch, dev, gen)
    return errs


def b4_batch_invariance(torch, dev, gen):
    """At mamba2's shape (S=1024, H=48, P=64, N=128, bf16, an initial
    state): each row of a B=4 call, and heads 0..7 of an H=48 call, equal
    bit for bit (y and the final state) to the same row or heads run alone.
    The mesh checks (phase 10d, ``--train-mesh``) rely on it."""
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked

    x, dt, A, Bm, Cm = ssd_inputs(torch, 4, 1024, 48, 64, 128, gen, dev, torch.bfloat16)
    h0 = torch.randn((4, 48, 128, 64), generator=gen, device=dev)
    y, h = ssd_chunked(x, dt, A, Bm, Cm, h0)
    for b in range(4):
        r = slice(b, b + 1)
        yb, hb = ssd_chunked(x[r], dt[r], A, Bm[r], Cm[r], h0[r])
        check(torch.equal(yb, y[r]) and torch.equal(hb, h[r]),
              f"B4: batch row {b} of a B=4 call differs from the row alone")
    hs = slice(0, 8)
    yh, hh = ssd_chunked(x[:1, :, hs].contiguous(), dt[:1, :, hs].contiguous(),
                         A[hs].contiguous(), Bm[:1], Cm[:1], h0[:1, hs].contiguous())
    check(torch.equal(yh, y[:1, :, hs]) and torch.equal(hh, h[:1, hs]),
          "B4: heads 0..7 of an H=48 call differ from the same heads alone")
    log("B4 batch invariance (S=1024, H=48, P=64, N=128, bf16, h0): rows of a B=4 call "
        "and heads 0..7 of an H=48 call equal bit for bit to each run alone")


# model -> (layers run on the card, {kernel: launches per prefill}), served
# as a burst through Engine; depth is cut only where one card forces it
# (bf16 weights: mixtral 8 of 32 layers 23.7 GB, qwen3-moe 4 of 94 22.4 GB,
# jamba one period, 8 of 32, 26.5 GB; gemma-7b runs all 28, 17.1 GB, its
# head dim of 256 through B3's largest tier)
LM_PATHS = {"llama3.2-1b": (16, {"flash_attention": 16}),
            "mamba2-780m": (48, {"ssd_scan": 48}),
            "mixtral-8x7b": (8, {"flash_attention": 8}),
            "qwen3-moe-235b-a22b": (4, {"flash_attention": 4}),
            "jamba-v0.1-52b": (8, {"flash_attention": 1, "ssd_scan": 7}),
            "gemma-7b": (28, {"flash_attention": 28})}
# model -> (prompt lengths, flash_attention launches per prefill), each
# prompt prefilled alone (B = 1) through serve.steps with its own frames
# or vision inputs, then DECODE_STEPS decode steps; at full depth
# (whisper: 24 encoder + 24 decoder layers, each with self- and
# cross-attention; qwen2-vl: 28 layers, 1024 vision + 1024 text tokens)
STEP_PATHS = {"whisper-medium": ((128, 256, 512, 1024), 72),
              "qwen2-vl-2b": ((2048, 2048), 28)}
DECODE_STEPS = 16
TRACED = ("llama3.2-1b", "mamba2-780m", "mixtral-8x7b")
MEM_LIMIT = 70e9
LM_LOGIT_TOL = 0.05
# mamba: each ssd_chunked call of a kernel-path prefill is held, on its own
# inputs, against the scan in float64, by max |y - y64| over the call's
# largest |y64|.  y is bf16: the plain float32 scan lies up to half a bf16
# ulp (2^-8 of a value) from float64, and a sound scan that sums in another
# order may round a y the other way, one ulp (2^-7) more.  The kernel's gap
# may exceed the plain scan's by at most that ulp.
SSD_Y_MARGIN = 2.0 ** -7

def _counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked

    return {"imc_eval": imc_eval_multi, "ga_gen_step": ga_gen_step,
            "flash_attention": flash_attention, "ssd_scan": ssd_chunked}


def _prefill_ssd_float64(torch, cfg, params, toks):
    """Last-token logits of the plain path with every SSD scan computed in
    float64 (y rounded to the model's dtype, as the plain scan rounds it):
    the reading that says how far the plain path's own float32 rounding
    moves the logits, against which the 0.05 check is read."""
    import functools
    import types

    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.models import mamba, transformer

    saved = mamba.ssd
    mamba.ssd = types.SimpleNamespace(ssd_chunked=functools.partial(
        ref.ssd_chunked, compute_dtype=torch.float64))
    try:
        return transformer.prefill(cfg, params, toks, impl="plain")[0]
    finally:
        mamba.ssd = saved


def _scan_gaps(real, gaps):
    """``real`` (an ``ssd_chunked``) that also holds each call, on the
    call's own inputs, against the plain scan and the scan in float64:
    appends (its gap, the plain scan's gap) to ``gaps``, each max |y - y64|
    over the call's largest |y64|."""
    import torch

    from repro_torch.kernels.ssd_scan import ref

    def f64(t):
        return None if t is None else t.double()

    def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
        y, h = real(x, dt, A, Bm, Cm, h0, chunk=chunk)
        yp, _ = ref.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
        y64, _ = ref.ssd_chunked(f64(x), f64(dt), f64(A), f64(Bm), f64(Cm), f64(h0),
                                 chunk=chunk, compute_dtype=torch.float64)
        scale = y64.abs().max()
        gaps.append((float((y.double() - y64).abs().max() / scale),
                     float((yp.double() - y64).abs().max() / scale)))
        return y, h
    return scan


def _drop_last_chunk_inter(real):
    """An ``ssd_chunked`` with one fault: the last chunk's y loses its
    inter-chunk term (it is scanned again from a zero state)."""
    import torch

    def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
        y, h = real(x, dt, A, Bm, Cm, h0, chunk=chunk)
        lo = x.shape[1] - min(chunk, x.shape[1])
        if lo > 0:
            y_last, _ = real(x[:, lo:], dt[:, lo:], A, Bm[:, lo:], Cm[:, lo:], None,
                             chunk=chunk)
            y = torch.cat([y[:, :lo], y_last], dim=1)
        return y, h
    return scan


def _drop_own_term(real):
    """An ``ssd_chunked`` with one fault: a strict causal mask, so each
    position loses its own term ``(C_t . B_t) dt_t x_t`` (the intra-chunk
    diagonal, M[t, t] = 1), as a scan off by one on the mask would."""
    def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
        y, h = real(x, dt, A, Bm, Cm, h0, chunk=chunk)
        cb = (Cm.float() * Bm.float()).sum(-1)[..., None]  # (B, S, 1, 1), G = 1
        own = cb * dt.float()[..., None] * x.float()
        return (y.float() - own).to(y.dtype), h
    return scan


def _model_cfg(name, depth=None):
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = get_config(name)
    if depth is not None and depth < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    return cfg


def _with_routes(fn, replay=None):
    """Run ``fn`` with ``moe_route`` wrapped: each MoE layer's routing is
    recorded, or, with ``replay`` (a recorded list), handed back in order
    in place of the layer's own.  Returns (fn's result, the routings)."""
    from repro_torch.models import moe

    real, routes = moe.moe_route, []

    def route(x, router, **kw):
        r = real(x, router, **kw) if replay is None else replay[len(routes)]
        routes.append(r)
        return r
    moe.moe_route = route
    try:
        out = fn()
    finally:
        moe.moe_route = real
    check(replay is None or len(routes) == len(replay), "MoE routings not all replayed")
    return out, routes


def _moved_past_margin(torch, routes_k, routes_p):
    """(token, k) choices of the kernel path's routing that a near-tie
    cannot explain.  Per MoE layer and token, with D the largest change of
    any router probability between the two paths, a token whose plain-path
    top-(k+1) probabilities are all more than 2 D apart must keep its
    ranked top-k experts: no probability moved far enough to reorder them.
    Returns (tokens that moved all the same, the largest D of each layer)."""
    bad, shifts = 0, []
    for a, b in zip(routes_k, routes_p):
        k = b.topi.shape[-1]
        top = torch.sort(b.probs, dim=-1, descending=True).values[..., :k + 1]
        margin = (top[..., :-1] - top[..., 1:]).amin(-1)
        shift = (a.probs - b.probs).abs().amax(-1)
        moved = (a.topi != b.topi).any(-1)
        bad += int((moved & (margin > 2 * shift)).sum())
        shifts.append(float(shift.max()))
    return bad, shifts


def _check_launches(name, launches, want):
    for k, n in want.items():
        check(launches[k] == n, f"{name}: {k} launched {launches[k]} times, want {n}")
    others = {k: n for k, n in launches.items() if k not in want and n}
    check(not others, f"{name}: other kernels launched on its path: {others}")


def _check_memory(torch, name):
    peak = torch.cuda.max_memory_allocated()
    check(peak < MEM_LIMIT, f"{name}: peak device memory {peak / 1e9:.2f} GB >= "
          f"{MEM_LIMIT / 1e9:.0f} GB")
    return peak


def _trace_summary(per, kernel_prefixes, wall):
    busy = sum(ms for ms, _ in per.values()) / 1e3
    mine = {k: sum(ms for n, (ms, _) in per.items() if KERNEL_PREFIX[k] in n) / 1e3
            for k in kernel_prefixes}
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]

    def total(*words):
        hit = [(ms, c) for n, (ms, c) in per.items() if any(w in n for w in words)]
        return [sum(ms for ms, _ in hit), sum(c for _, c in hit)]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "kernel_s": mine, "kernel_share_of_busy": {k: v / busy for k, v in mine.items()},
            "device_activities": sum(c for _, c in per.values()),
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top],
            # decode attention widened the cache here before: float GEMVs and
            # direct copies; the MoE layers' expert GEMMs and dispatch scatter
            "gemmSN": total("gemmSN"), "direct_copy": total("direct_copy"),
            # cuBLAS's GEMMs show as "nvjet_*" or "*gemm*"
            "gemm": total("gemm", "nvjet"), "index_put": total("index_put")}


def _float32_logits(torch, cfg, params, toks, impl, scan=None, replay=None):
    """All-position logits of ``transformer.forward`` with float32
    activations (``transformer.ACT_DTYPE`` patched for the call; the bf16
    weights are cast at use, as ever), through ``impl``, with ``scan`` in
    place of the B4 wrapper when given; MoE layers replay ``replay``'s
    routing when given.  Returns (logits, the routings)."""
    import types

    from repro_torch.models import mamba, transformer

    saved = transformer.ACT_DTYPE, mamba.ssd_ops
    transformer.ACT_DTYPE = torch.float32
    if scan is not None:
        mamba.ssd_ops = types.SimpleNamespace(ssd_chunked=scan)
    try:
        with torch.inference_mode():
            return _with_routes(lambda: transformer.forward(cfg, params, toks, impl=impl)[0],
                                replay=replay)
    finally:
        transformer.ACT_DTYPE, mamba.ssd_ops = saved


def _check_float32_model(torch, name, cfg, params, firsts, dev):
    """The whole model with float32 activations, one prompt of each length:
    the kernel path's logits at every position within LM_LOGIT_TOL of the
    plain path's (MoE layers under the plain path's routing).  In float32
    y is never rounded to bf16, so no flip is amplified: a sound scan reads
    far inside the bound.  The two faulty scans must fail it at the
    longest prompt.  Returns the gaps."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    gaps, faults = {}, {}
    for n, r in sorted(firsts.items()):
        toks = torch.as_tensor(r.prompt[None].astype("int64"), device=dev)
        lp, routes = _float32_logits(torch, cfg, params, toks, "plain")
        replay = routes if cfg.n_experts else None
        lk, _ = _float32_logits(torch, cfg, params, toks, "kernel", replay=replay)
        check(lk.dtype == torch.float32 and tuple(lk.shape) == tuple(lp.shape)
              and lk.shape[1] == n, f"{name}: float32 logits {lk.dtype} {tuple(lk.shape)}")
        check(bool(torch.isfinite(lk).all()), f"{name}: float32 logits not finite")
        gaps[n] = float((lk - lp).abs().max())
        check(gaps[n] <= LM_LOGIT_TOL, f"{name} S={n}: float32 kernel vs plain logits "
              f"(every position) differ by {gaps[n]} > {LM_LOGIT_TOL}")
    for what, make in (("last chunk's inter-chunk term dropped", _drop_last_chunk_inter),
                       ("own term dropped", _drop_own_term)):
        lk, _ = _float32_logits(torch, cfg, params, toks, "kernel",
                                scan=make(ssd_ops.ssd_chunked), replay=replay)
        faults[what] = float((lk - lp).abs().max())
        check(faults[what] > LM_LOGIT_TOL, f"{name} S={n}: a scan with its {what} passes "
              f"the float32 whole-model check ({faults[what]} <= {LM_LOGIT_TOL})")
    del lp, lk
    log(f"{name}: float32 activations, kernel vs plain logits at every position: "
        + ", ".join(f"S={m} {g:.4g}" for m, g in gaps.items())
        + f" (bound {LM_LOGIT_TOL}); faulty scans at S={n} rejected: "
        + ", ".join(f"{w} {g:.4g}" for w, g in faults.items()))
    return {"sound": gaps, "faults": faults}


def phase_lm(torch, dev, name, card, timings):
    """One model's serving path at full width: a burst of 8 requests through
    ``Engine`` (4 slots, max_len 2048), random weights from seed 0, the
    depth of ``LM_PATHS``.  Every request gets its max_new tokens; each
    kernel of the model launches its count per prefill, the other kernels
    never.  Then the kernel path's prefill logits against the plain path's
    (same weights, plain attention / SSD called directly) within
    LM_LOGIT_TOL, for MoE models under the plain path's routing (each
    path's own routing, the entries it moves and the dropped entries
    logged; a token that moves although its router margin exceeds twice
    its probabilities' shift fails, ``_moved_past_margin``).  For the
    models with SSD layers that bf16 gap is only logged, beside both
    paths' gaps to the plain path with its SSD in float64; B4 is held by
    each scan call's y against the scan in float64 (within SSD_Y_MARGIN of
    the plain scan's gap) and by the whole model in float32 (logits at
    every position within LM_LOGIT_TOL), each shown to reject two faulty
    scans; the greedy tokens of a plain-path burst (logged), peak device
    memory under MEM_LIMIT, and one traced burst (``TRACED``)."""
    from repro_torch.launch.serve import build_params, make_burst, serve_burst
    from repro_torch.models import transformer

    depth, per = LM_PATHS[name]
    cfg = _model_cfg(name, depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_params(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    done, st = serve_burst(cfg, params, make_burst(cfg, 8, 0), slots=4, max_len=2048)
    launches = {k: c.launches for k, c in counters.items()}
    check(len(done) == 8, f"{name}: {len(done)} of 8 requests answered")
    for r in done:
        check(len(r.out) == r.max_new, f"{name} request {r.rid}: {len(r.out)} of "
              f"{r.max_new} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out), f"{name}: token out of range")
    check(st["prefills"] == 8, f"{name}: {st['prefills']} prefills")
    _check_launches(name, launches, {k: n * st["prefills"] for k, n in per.items()})

    # the kernel path against the plain path, prefill logits, one prompt of
    # each length
    firsts = {}
    for r in done:
        firsts.setdefault(len(r.prompt), r)
    errs, top1, f64_gap, drops = {}, 0, {}, {}
    with torch.inference_mode():
        for n, r in sorted(firsts.items()):
            toks = torch.as_tensor(r.prompt[None].astype("int64"), device=dev)

            def kernel(toks=toks):
                return transformer.prefill(cfg, params, toks, impl="kernel")[0]

            lp, routes_p = _with_routes(
                lambda: transformer.prefill(cfg, params, toks, impl="plain")[0])
            lk, routes_k = _with_routes(kernel)
            if cfg.n_experts:
                # a bf16 ulp between the two paths moves tokens across router
                # near-ties and, where queues overflow, across the capacity
                # boundary: logged; the check runs the kernel path under the
                # plain path's routing
                free = float((lk.float() - lp.float()).abs().max())
                lk, _ = _with_routes(kernel, replay=routes_p)
                drops[n] = {
                    "dropped": sum(int((~r.keep).sum()) for r in routes_k),
                    "entries": sum(r.keep.numel() for r in routes_k),
                    "capacity": routes_k[0].capacity,
                    "per_layer": [int((~r.keep).sum()) for r in routes_k],
                    "experts_moved": sum(int((a.topi != b.topi).sum())
                                         for a, b in zip(routes_k, routes_p)),
                    "kept_changed": sum(int((a.keep != b.keep).sum())
                                        for a, b in zip(routes_k, routes_p)),
                    "own_routing_logit_diff": free}
                bad, shifts = _moved_past_margin(torch, routes_k, routes_p)
                drops[n]["prob_shift_by_layer"] = shifts
                check(bad == 0, f"{name} prefill S={n}: {bad} tokens changed experts "
                      f"between the kernel and plain paths with a router margin above "
                      f"twice the shift of their probabilities")
            check(bool(torch.isfinite(lk).all()), f"{name}: prefill logits not finite")
            errs[n] = float((lk.float() - lp.float()).abs().max())
            top1 += int(torch.equal(lk.argmax(-1), lp.argmax(-1)))
            scale = float(lp.float().abs().max())
            msg = ""
            if n in drops:
                d = drops[n]
                msg = (f" under the plain path's routing; with its own routing "
                       f"{d['own_routing_logit_diff']:.4g} ({d['experts_moved']} (token, k) "
                       f"entries on another expert, {d['kept_changed']} kept / dropped "
                       f"otherwise; every moved token within twice its router "
                       f"probabilities' shift of a tie, largest shift by layer "
                       f"{[float(f'{x:.3g}') for x in d['prob_shift_by_layer']]}); "
                       f"MoE entries dropped at capacity C={d['capacity']}: "
                       f"{d['dropped']} of {d['entries']} (per layer {d['per_layer']})")
            log(f"{name} prefill S={n}: kernel vs plain logits max abs diff "
                f"{errs[n]:.4g} (max |logit| {scale:.4g}){msg}")
            if "ssd_scan" in per:
                l64 = _prefill_ssd_float64(torch, cfg, params, toks).float()
                f64_gap[n] = {"plain": float((lp.float() - l64).abs().max()),
                              "kernel": float((lk.float() - l64).abs().max())}
                log(f"{name} prefill S={n}: against the plain path with its SSD in "
                    f"float64, logits max abs diff: plain path {f64_gap[n]['plain']:.4g}, "
                    f"kernel path {f64_gap[n]['kernel']:.4g}")
    err = max(errs.values())
    if "ssd_scan" in per:
        # B4's sums are not the plain path's: a one-ulp flip of a bf16 y grows
        # past LM_LOGIT_TOL over these layers, for a correct scan too (the
        # plain path lies as far from itself with its SSD in float64, logged
        # above); the per-call float64 check and the float32 whole-model
        # check below hold B4 instead
        log(f"{name}: bf16 kernel vs plain prefill logits {err:.4g} (logged, not held: "
            f"the float64 per-call and float32 whole-model checks hold B4)")
    else:
        check(err <= LM_LOGIT_TOL, f"{name}: kernel vs plain prefill logits differ by "
              f"{err} > {LM_LOGIT_TOL}")
    scan_gap = f32_gap = None
    if "ssd_scan" in per:
        # every scan call against float64 on its own inputs (the kernel
        # wrapper monkeypatched), then the same with faulty scans, which the
        # check must reject: one that drops the last chunk's inter-chunk
        # term, one that drops each position's own term
        import types

        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        from repro_torch.models import mamba

        def held(make, toks):
            gaps = []
            saved = mamba.ssd_ops
            mamba.ssd_ops = types.SimpleNamespace(
                ssd_chunked=_scan_gaps(make(ssd_ops.ssd_chunked), gaps))
            try:
                with torch.inference_mode():
                    transformer.prefill(cfg, params, toks, impl="kernel")
            finally:
                mamba.ssd_ops = saved
            check(len(gaps) == per["ssd_scan"], f"{name}: {len(gaps)} scan calls held")
            return {"extra": max(k - p for k, p in gaps), "plain": max(p for _, p in gaps),
                    "kernel": max(k for k, _ in gaps)}

        scan_gap = {"sound": {}, "faults": {}}
        for n, r in sorted(firsts.items()):
            toks = torch.as_tensor(r.prompt[None].astype("int64"), device=dev)
            g = scan_gap["sound"][n] = held(lambda real: real, toks)
            check(g["extra"] <= SSD_Y_MARGIN,
                  f"{name} S={n}: a scan call's y lies {g['kernel']} from float64, the "
                  f"plain scan's {g['plain']} + margin {SSD_Y_MARGIN}")
        n = max(firsts)
        toks = torch.as_tensor(firsts[n].prompt[None].astype("int64"), device=dev)
        for what, make in (("last chunk's inter-chunk term dropped", _drop_last_chunk_inter),
                           ("own term dropped", _drop_own_term)):
            g = scan_gap["faults"][what] = held(make, toks)
            check(g["extra"] > SSD_Y_MARGIN,
                  f"{name} S={n}: a scan with its {what} passes the float64 check "
                  f"(extra gap {g['extra']} <= {SSD_Y_MARGIN})")
        log(f"{name}: every scan call's y within the plain scan's float64 gap + "
            f"{SSD_Y_MARGIN:.6g} of its largest |y| (extra gap, worst call: " + ", ".join(
                f"S={m} {g['extra']:.4g}" for m, g in scan_gap["sound"].items())
            + f"; plain scan's gap up to {max(g['plain'] for g in scan_gap['sound'].values()):.4g}"
            f"); faulty scans at S={n} rejected: " + ", ".join(
                f"{w} {g['extra']:.4g}" for w, g in scan_gap["faults"].items()))
    if "ssd_scan" in per:
        f32_gap = _check_float32_model(torch, name, cfg, params, firsts, dev)
    done_p, st_p = serve_burst(cfg, params, make_burst(cfg, 8, 0), slots=4,
                               max_len=2048, impl="plain")
    same = sum(a == b for r, rp in zip(done, done_p) for a, b in zip(r.out, rp.out))
    prefix = 0
    for r, rp in zip(done, done_p):
        for a, b in zip(r.out, rp.out):
            if a != b:
                break
            prefix += 1
    total = sum(len(r.out) for r in done)

    trace = {"device": "not measured"}
    if name in TRACED:  # one burst more, traced
        prof, wall = _profiled(torch, lambda: serve_burst(
            cfg, params, make_burst(cfg, 8, 0), slots=4, max_len=2048))
        per_act = device_kernels(prof)
        trace = {"wall_s": wall, "device": "not measured"}
        if per_act:
            trace = _trace_summary(per_act, per, wall)
    peak = _check_memory(torch, name)
    timings[f"serve/{name}"] = dict(
        card=card, layers=cfg.n_layers, params=cfg.param_count(), init_s=init_s,
        launches={k: launches[k] for k in per}, peak_memory_bytes=peak,
        stats=st, plain_stats=st_p, logit_err=errs, logit_gap_ssd_float64=f64_gap,
        moe_drops=drops, top1_agree=f"{top1}/{len(errs)}",
        greedy_same=same, greedy_prefix=prefix, tokens=total, trace=trace,
        ssd_y_gap_float64=scan_gap, logit_gap_float32=f32_gap)
    log(f"{name} ({cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f} B params, init "
        f"{init_s:.2f}s, peak device memory {peak / 1e9:.2f} GB) on {card}: "
        f"{st['requests']} requests, {st['tokens']} tokens, {st['prefills']} prefills "
        f"({', '.join(f'{launches[k]} {k}' for k in per)} launches), {st['decode_steps']} "
        f"decode steps; "
        f"TTFT mean {st['ttft_mean_s'] * 1e3:.1f} ms (max {st['ttft_max_s'] * 1e3:.1f}), "
        f"prefill {st['prefill_s'] / st['prefills'] * 1e3:.2f} ms each, decode "
        f"{st['decode_tokens_per_s']:.1f} tokens/s, {st['wall_s']:.3f}s in all; plain "
        f"path: TTFT mean {st_p['ttft_mean_s'] * 1e3:.1f} ms, prefill "
        f"{st_p['prefill_s'] / st_p['prefills'] * 1e3:.2f} ms each; greedy tokens equal "
        f"{same}/{total} ({prefix} before the first difference in each request); "
        f"prefill top-1 equal {top1}/{len(errs)}")
    if "device_busy_s" in trace:
        log(f"{name} trace (profiled): {trace['wall_s']:.3f}s host clock, device busy "
            f"{trace['device_busy_s'] * 1e3:.2f} ms (idle share {trace['idle_share']:.4f}), "
            + ", ".join(f"{k} {v * 1e3:.2f} ms ({trace['kernel_share_of_busy'][k]:.3f} of "
                        f"busy)" for k, v in trace["kernel_s"].items())
            + f"; float GEMV gemmSN {trace['gemmSN'][0]:.2f} ms x{trace['gemmSN'][1]}, "
            f"direct copies {trace['direct_copy'][0]:.2f} ms x{trace['direct_copy'][1]}, "
            f"GEMMs {trace['gemm'][0]:.2f} ms x{trace['gemm'][1]}, index_put "
            f"{trace['index_put'][0]:.2f} ms x{trace['index_put'][1]}; top: "
            + "; ".join(f"{t['name'][:60]} {t['ms']:.2f} ms x{t['count']}"
                        for t in trace["top"][:5]))
    elif name in TRACED:
        log(f"{name} trace: device time not measured")
    del params
    torch.cuda.empty_cache()
    return {k: launches[k] for k in per}


def phase_lm_steps(torch, dev, name, card, timings):
    """whisper / qwen2-vl, which ``Engine`` does not serve (their requests
    need frames or vision inputs): each prompt of ``STEP_PATHS`` prefilled
    alone through ``serve.steps.make_prefill_step`` with inputs from
    ``launch.cells.make_inputs`` (frames of the prompt's length; 1024
    vision embeddings and their mrope streams), then DECODE_STEPS greedy
    steps of ``make_decode_step``, full depth, random weights from seed 0.
    flash_attention launches its count per prefill and no other kernel
    launches; every token in range; the kernel path's prefill logits
    within LM_LOGIT_TOL of the plain path's; peak memory logged."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import make_inputs
    from repro_torch.launch.serve import build_params
    from repro_torch.models import transformer
    from repro_torch.serve.steps import greedy_sample, make_decode_step, make_prefill_step

    lengths, per = STEP_PATHS[name]
    cfg = _model_cfg(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_params(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = _gen(torch, dev, 5)
    batches = [make_inputs(cfg, ShapeSpec("prompt", n, 1, "prefill"), gen) for n in lengths]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    outs, prefill_s, decode_s = [], [], []
    with torch.inference_mode():
        for n, batch in zip(lengths, batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            check(bool(torch.isfinite(logits).all()), f"{name}: prefill logits not finite")
            cache = transformer.pad_cache(cfg, cache, n + DECODE_STEPS)
            tok = greedy_sample(logits)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = [int(tok[0, 0])]
            for i in range(DECODE_STEPS):
                logits, cache = decode(params, cache, {
                    "token": tok.long(), "pos": torch.full((1,), n + i, device=dev)})
                tok = greedy_sample(logits)
                out.append(int(tok[0, 0]))
            t2 = time.perf_counter()
            check(all(0 <= t < cfg.vocab_size for t in out), f"{name}: token out of range")
            outs.append(out)
            prefill_s.append(t1 - t0)
            decode_s.append((t2 - t1) / DECODE_STEPS)
    launches = {k: c.launches for k, c in counters.items()}
    _check_launches(name, launches, {"flash_attention": per * len(lengths)})

    errs, top1 = {}, 0
    with torch.inference_mode():
        for i, (n, batch) in enumerate(zip(lengths, batches)):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            lk, _ = transformer.prefill(cfg, params, batch["tokens"], impl="kernel", **extra)
            lp, _ = transformer.prefill(cfg, params, batch["tokens"], impl="plain", **extra)
            errs[f"{i}:S={n}"] = float((lk.float() - lp.float()).abs().max())
            top1 += int(torch.equal(lk.argmax(-1), lp.argmax(-1)))
            log(f"{name} prefill S={n} ({', '.join(extra)}): kernel vs plain logits max abs "
                f"diff {errs[f'{i}:S={n}']:.4g} (max |logit| {float(lp.float().abs().max()):.4g})")
    err = max(errs.values())
    check(err <= LM_LOGIT_TOL, f"{name}: kernel vs plain prefill logits differ by "
          f"{err} > {LM_LOGIT_TOL}")
    peak = _check_memory(torch, name)
    timings[f"serve/{name}"] = dict(
        card=card, layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
        params=cfg.param_count(), init_s=init_s, launches={"flash_attention": per * len(lengths)},
        peak_memory_bytes=peak, prompts=list(lengths), prefill_s=prefill_s,
        decode_step_s=decode_s, logit_err=errs, top1_agree=f"{top1}/{len(errs)}",
        tokens=outs)
    log(f"{name} ({cfg.n_layers} layers{f' + {cfg.encoder_layers} encoder' if cfg.is_encdec else ''}"
        f", {cfg.param_count() / 1e9:.2f} B params, init {init_s:.2f}s, peak device memory "
        f"{peak / 1e9:.2f} GB) on {card}: {len(lengths)} prompts of {list(lengths)} tokens, "
        f"{launches['flash_attention']} flash_attention launches; prefill "
        + ", ".join(f"{t * 1e3:.2f}" for t in prefill_s) + " ms; decode "
        + ", ".join(f"{t * 1e3:.2f}" for t in decode_s) + f" ms per step; prefill top-1 "
        f"equal {top1}/{len(errs)}; greedy tokens {[o[:6] for o in outs]}")
    del params
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"]}


# ------------------------------------------------------------ training path
# model -> (steps, --ckpt-every, a step without remat too) of phase 10b's
# full-width runs through launch.train.main (full depth: llama 16 layers,
# mamba 48), each restarted from its first checkpoint.  mamba's step without
# remat needs more than the card's 80 GB at B=4, S=1024 (it stopped out of
# memory in a chip run): the plain SSD keeps its (B, chunks, Q, Q, H)
# float32 intermediates for 48 layers
TRAIN_PATHS = {"llama3.2-1b": (10, 5, True), "mamba2-780m": (4, 2, False)}
TRAIN_SEQ, TRAIN_BATCH = 1024, 4
# the reduced configurations of the card-vs-CPU step
TRAIN_REDUCED = ("llama3.2-1b", "mamba2-780m", "mixtral-8x7b")
# a resumed run against the uninterrupted one, per step's loss (~11 at the
# start): both replay the same batches from the same restored state; only a
# reordered float32 sum (an atomic on the card) could move a loss, by ulps
RESUME_LOSS_TOL = 1e-3
# card against CPU, one step from the same state (tests/test_torch_train.py
# states the same bounds for the port against the JAX package on the CPU):
# bf16 activations round on the card's GEMMs as in another framework, which
# moves the loss by ~1e-4 relative, each leaf's gradient by a few percent of
# its L2 norm, and each leaf's AdamW update more (an element whose gradient
# is as small as that noise can change the sign of its update)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-2
TRAIN_GRAD_REL_L2 = 0.1
TRAIN_UPDATE_REL_L2 = 0.3
_STEP_LINE = re.compile(r"^\[train\] step\s+(\d+) loss (\S+) gnorm (\S+) lr (\S+) \((\S+)s\)$")


def _train_log(out: str) -> dict:
    """{step: (loss, grad norm, lr, seconds since the start)} of a
    ``launch.train.main`` run's log."""
    steps = {}
    for ln in out.splitlines():
        m = _STEP_LINE.match(ln)
        if m:
            steps[int(m.group(1))] = tuple(float(m.group(i)) for i in (2, 3, 4, 5))
    return steps


def _train_step_timed(torch, dev, cfg, remat, params, opt, batch):
    """One train step of ``make_train_step(remat=remat)``: (ms, peak device
    memory over the step, metrics).  Updates params and opt in place."""
    from repro_torch.train.step import make_train_step

    step = make_train_step(cfg, total_steps=100, warmup_steps=5, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, torch.cuda.max_memory_allocated(), m


def phase_train(torch, dev, name, card, timings):
    """Phase 10b, one model at full width and depth: ``launch.train.main``
    (``--seq 1024 --batch 4``, remat, ``--log-every 1``, checkpoints every
    ``TRAIN_PATHS`` steps into a temporary directory), every launch count
    set to 0 just before: no kernel launches; every loss and grad norm
    finite; the last loss below the first; peak device memory under
    MEM_LIMIT.  Then the final checkpoint is removed and the same command
    run again: it must resume from the first checkpoint and give the first
    run's losses within RESUME_LOSS_TOL.  Then one step with remat and, for
    llama, one without (ms, tokens/s, peak memory) and one traced step
    (device busy, idle share, top device work)."""
    import shutil

    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import make_batch_fn, to_device
    from repro_torch.launch import train

    steps, every, remat_off = TRAIN_PATHS[name]
    cfg = _model_cfg(name)
    counters = _counters()
    argv = ["--arch", name, "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
            "--steps", str(steps), "--ckpt-every", str(every), "--log-every", "1"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        argv += ["--ckpt-dir", tmp]
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rc, out = _captured(train.main, argv)
        wall = time.perf_counter() - t0
        peak = _check_memory(torch, f"{name} training")
        check(rc == 0, f"{name}: launch.train.main exited {rc}")
        log_a = _train_log(out)
        check(sorted(log_a) == list(range(steps)), f"{name}: logged steps {sorted(log_a)}")
        losses = [log_a[s][0] for s in range(steps)]
        gnorms = [log_a[s][1] for s in range(steps)]
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"{name}: losses {losses}, grad norms {gnorms}")
        check(losses[-1] < losses[0], f"{name}: loss {losses[0]} -> {losses[-1]}, not down")
        check("(DOWN)" in out, f"{name}: no DOWN line")
        check(store.committed_steps(tmp) and sorted(store.committed_steps(tmp)) ==
              list(range(every, steps, every)) + [steps],
              f"{name}: checkpoints {sorted(store.committed_steps(tmp))}")
        # a crash after the first checkpoint: only it is left, and the same
        # command resumes from it
        for s in store.committed_steps(tmp):
            if s != every:
                shutil.rmtree(Path(tmp) / f"step_{s:09d}")
        torch.cuda.reset_peak_memory_stats()
        rc, out_b = _captured(train.main, argv)
        peak_resume = _check_memory(torch, f"{name} resumed training")
        check(rc == 0, f"{name}: the resumed run exited {rc}")
        check(f"auto-resumed from step {every}" in out_b, f"{name}: did not resume at {every}")
        log_b = _train_log(out_b)
        check(sorted(log_b) == list(range(every, steps)),
              f"{name}: resumed run logged {sorted(log_b)}")
        resume_diff = max(abs(log_b[s][0] - log_a[s][0]) for s in log_b)
        check(resume_diff <= RESUME_LOSS_TOL, f"{name}: resumed losses differ by "
              f"{resume_diff} > {RESUME_LOSS_TOL}")
    launches = {k: c.launches for k, c in counters.items()}
    check(not any(launches.values()), f"{name}: kernels launched while training: {launches}")
    times = [log_a[s][3] for s in range(steps)]
    step_s = sorted(b - a for a, b in zip(times, times[1:]))

    # one step each with remat on and off, at the run's shapes, then one traced
    params, opt = train.build_state(cfg, dev, 0)
    batch = to_device(make_batch_fn(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)(0), dev)
    _train_step_timed(torch, dev, cfg, True, params, opt, batch)  # warm-up
    modes = {}
    for remat in (True, False) if remat_off else (True,):
        ms, pk, m = _train_step_timed(torch, dev, cfg, remat, params, opt, batch)
        check(math.isfinite(float(m["loss"])), f"{name}: remat={remat} loss not finite")
        modes["on" if remat else "off"] = {
            "ms": ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
            "peak_memory_bytes": pk}
    for c in counters.values():
        c.launches = 0
    prof, twall = _profiled(torch, lambda: _train_step_timed(torch, dev, cfg, True, params,
                                                             opt, batch))
    check(not any(c.launches for c in counters.values()), f"{name}: traced step launched kernels")
    per_act = device_kernels(prof)
    trace = _trace_summary(per_act, (), twall) if per_act else {"device": "not measured"}
    del params, opt, batch
    torch.cuda.empty_cache()

    timings[f"train/{name}"] = dict(
        card=card, layers=cfg.n_layers, params=cfg.param_count(), seq=TRAIN_SEQ,
        batch=TRAIN_BATCH, steps=steps, wall_s=wall, losses=losses, grad_norms=gnorms,
        step_s_median=step_s[len(step_s) // 2], peak_memory_bytes=peak,
        peak_memory_resumed_bytes=peak_resume, resumed_at=every,
        resumed_losses={s: log_b[s][0] for s in log_b}, resume_loss_diff=resume_diff,
        remat=modes, launches=launches, trace=trace)
    log(f"{name} training ({cfg.n_layers} layers, {cfg.param_count() / 1e9:.2f} B params, "
        f"B={TRAIN_BATCH}, S={TRAIN_SEQ}) on {card}: {steps} steps in {wall:.2f}s through "
        f"launch.train.main, loss {losses[0]:.6f} -> {losses[-1]:.6f}, grad norms "
        f"{[round(g, 4) for g in gnorms]}, median step {step_s[len(step_s) // 2] * 1e3:.1f} ms "
        f"(host clock between log lines), peak device memory {peak / 1e9:.2f} GB; resumed at "
        f"step {every}: losses within {resume_diff:.3g} of the first run's (peak "
        f"{peak_resume / 1e9:.2f} GB); no kernel launched ({launches})")
    log(f"{name} one step on {card}: " + "; ".join(
        f"remat {k}: {v['ms']:.1f} ms, {v['tokens_per_s']:.0f} tokens/s, peak "
        f"{v['peak_memory_bytes'] / 1e9:.2f} GB" for k, v in modes.items()))
    if "device_busy_s" in trace:
        log(f"{name} traced train step (remat on): {trace['wall_s']:.3f}s host clock, device "
            f"busy {trace['device_busy_s'] * 1e3:.2f} ms (idle share {trace['idle_share']:.4f}), "
            f"{trace['device_activities']} device activities, GEMMs {trace['gemm'][0]:.2f} ms "
            f"x{trace['gemm'][1]}, index_put {trace['index_put'][0]:.2f} ms "
            f"x{trace['index_put'][1]}; top: " + "; ".join(
                f"{t['name'][:60]} {t['ms']:.2f} ms x{t['count']}" for t in trace["top"][:6]))
    else:
        log(f"{name} traced train step: device time not measured")
    return launches


def _rel_l2(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / torch.clamp_min(b.norm(), 1e-30))


def phase_train_card_vs_cpu(torch, dev, card, timings):
    """One train step of each ``TRAIN_REDUCED`` config on the card against the
    same step on the CPU: the same float32 weights (from seed 0 on the CPU;
    mixtral's routers zeroed, so that every probability ties and both
    devices route alike) and the same batch (the data pipeline's step 0),
    the moments filled by a step at learning rate 0 on the CPU.  Loss and
    grad norm within TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL, each leaf's
    gradient within TRAIN_GRAD_REL_L2 and its update within
    TRAIN_UPDATE_REL_L2 (relative L2); no kernel launches."""
    from repro_torch.data.pipeline import make_batch_fn, to_device
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import input_specs
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_flatten, tree_leaves, tree_unflatten
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import loss_fn, make_train_step

    cpu = torch.device("cpu")
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = {}
    for name in TRAIN_REDUCED:
        cfg = _model_cfg(name).reduced()
        params = transformer.init(cfg, torch.Generator().manual_seed(0))
        for slot in params["blocks"]:
            if "router" in slot.get("ffn", {}):
                slot["ffn"]["router"].zero_()
        for p in tree_leaves(params):
            p.requires_grad_()
        extras = {k: v for k, v in input_specs(cfg, ShapeSpec("t", 64, 4, "train")).items()
                  if k not in ("inputs", "targets")}
        host = make_batch_fn(cfg.vocab_size, 64, 4, seed=0, extras=extras)(0)
        kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
        params, opt, _ = make_train_step(cfg, **kw)(params, adamw_init(params),
                                                    to_device(host, cpu))

        def to(tree, d):
            leaves, td = tree_flatten(tree)
            return tree_unflatten(td, [x.detach().to(d, copy=True).requires_grad_(x.requires_grad)
                                       for x in leaves])

        grads = []  # card, CPU
        for d in (dev, cpu):
            p = to(params, d)
            loss, _ = loss_fn(cfg, p, to_device(host, d))
            grads.append(torch.autograd.grad(loss, tree_leaves(p)))
        before = [x.detach().clone() for x in tree_leaves(params)]
        res = []
        for d in (dev, cpu):
            p, o = to(params, d), to(opt, d)
            p, o, m = make_train_step(cfg, **kw)(p, o, to_device(host, d))
            res.append(([x.detach().cpu() for x in tree_leaves(p)],
                        {k: float(v) for k, v in m.items()}))
        (pg, mg), (pc, mc) = res
        grad_rel = [_rel_l2(torch, a, b) for a, b in zip(*grads)]
        upd_rel = [_rel_l2(torch, a - x, b - x) for a, b, x in zip(pg, pc, before)]
        loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
        gn_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
        check(all(math.isfinite(v) for v in mg.values()), f"{name} reduced: card metrics {mg}")
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{name} reduced: card loss {mg['loss']} vs CPU "
              f"{mc['loss']}")
        check(gn_rel <= TRAIN_GNORM_RTOL, f"{name} reduced: card grad norm {mg['grad_norm']} "
              f"vs CPU {mc['grad_norm']}")
        check(max(grad_rel) <= TRAIN_GRAD_REL_L2, f"{name} reduced: gradient relative L2 "
              f"{max(grad_rel)} > {TRAIN_GRAD_REL_L2}")
        check(max(upd_rel) <= TRAIN_UPDATE_REL_L2, f"{name} reduced: update relative L2 "
              f"{max(upd_rel)} > {TRAIN_UPDATE_REL_L2}")
        out[name] = {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
                     "grad_rel_l2_max": max(grad_rel), "update_rel_l2_max": max(upd_rel),
                     "moe_aux": (mg["moe_aux"], mc["moe_aux"]), "leaves": len(pg)}
        log(f"{name} reduced train step, card vs CPU ({card}): loss {mg['loss']:.6f} vs "
            f"{mc['loss']:.6f} (rel {loss_rel:.3g}), grad norm rel {gn_rel:.3g}, moe aux "
            f"{mg['moe_aux']:.6g} vs {mc['moe_aux']:.6g}; over {len(pg)} leaves, gradient "
            f"relative L2 up to {max(grad_rel):.3g}, update up to {max(upd_rel):.3g}")
    launches = {k: c.launches for k, c in counters.items()}
    check(not any(launches.values()), f"card-vs-CPU train steps launched kernels: {launches}")
    timings["train/card_vs_cpu"] = out
    return launches


# ------------------------------------------------------ training on a mesh
# phase 10c: (a) llama at full width and depth through launch.train.main
# --data 1 --model 1 in a world of one under NCCL against phase 10b's
# meshless run; (b) two ranks at --data 2 and --model 2, full width, 2
# layers, from the meshless runs at the same settings
MESH_TRAIN_MODELS = ("llama3.2-1b", "mamba2-780m")
MESH_TRAIN_DEPTH = 2
MESH_TRAIN_ARGS = ("--seq", "256", "--batch", "4", "--steps", "4", "--log-every", "1")
# the mesh runs count the collectives of their last step only (a dispatch
# mode, slow on the host): their step ms come from the steps before it
MESH_COUNT_ARGS = ("--count-comm",)
MESH_TRAIN_SHAPES = ((2, 1), (1, 2))
# a mesh run's loss against the meshless run's: each rank's products are
# the meshless ones on its shards, but a sum split over ranks (the batch of
# a weight's gradient over data, a row-parallel product over model) is
# summed in float32 and rounded once, not by the meshless GEMM, and Adam
# turns those bf16 ulps into other updates (tests/test_torch_mesh_train.py
# reads up to 4.8e-4 over 4 steps on the CPU)
MESH_LOSS_TOL = 1e-3
# step 0's grad norm against the meshless run's, relative: both runs hold
# the same parameters, so only the rounding of the split sums differs
# (tests/test_torch_mesh_train.py reads up to 5.6e-4 on the CPU); a
# gradient summed twice, or missing a rank's rows, moves it by far more
MESH_GNORM_RTOL = 2e-3
# local (params, moments) bytes of a rank of a two-rank llama mesh against
# the meshless run's: FSDP over data or the vocab over model halves the
# embedding, which is most of a 2-layer llama
MESH_BYTES_RATIO = 0.55
MESH_TRAIN_DEADLINE_S = 420
_MESH_STEP = re.compile(r"^\[train\] step\s+(\d+) loss (\S+) gnorm (\S+) lr (\S+) \((\S+)s\)"
                        r"(?: comm (\d+) calls (\d+) B)?$")
_MESH_BYTES = re.compile(r"^\[train\] rank (\d+) local state bytes (\d+)$")
_MESH_COMM = re.compile(r"^\[train\] (?:rank \d+ )?step\s+(\d+) .*comm (\d+) calls (\d+) B$")


def _mesh_train_log(out: str) -> dict:
    """{step: (loss, grad norm, lr, seconds, collective calls, bytes)} of a
    ``launch.train.main`` log, the collective counts 0 off a mesh."""
    steps = {}
    for ln in out.splitlines():
        m = _MESH_STEP.match(ln)
        if m:
            steps[int(m.group(1))] = tuple(float(m.group(i)) for i in (2, 3, 4, 5)) + (
                int(m.group(6) or 0), int(m.group(7) or 0))
    return steps


def _spec_state_bytes(cfg, shape) -> int:
    """Local bytes of (float32 params, mu, nu) plus the int32 step that the
    specs imply on a (data, model) mesh of ``shape``."""
    from repro_torch.core.distributed import MeshLayout
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.models.common import ParamDecl

    sizes = dict(zip(("data", "model"), shape))
    total = 0

    def walk(spec, decl):
        nonlocal total
        if isinstance(decl, ParamDecl):
            n = math.prod(decl.shape)
            for entry in spec:
                for ax in (entry if isinstance(entry, tuple) else (entry,)):
                    n //= sizes.get(ax, 1) if ax else 1
            total += 3 * 4 * n
        elif isinstance(decl, dict):
            for k in decl:
                walk(spec[k], decl[k])
        else:
            for a, b in zip(spec, decl):
                walk(a, b)

    tmpl = transformer.param_template(cfg)
    walk(sharding.spec_tree(tmpl, MeshLayout(("data", "model"), shape)), tmpl)
    return total + 4


def _train_captured(torch, argv, depth=None):
    """``launch.train.main(argv)`` with its stdout captured, the model cut to
    ``depth`` layers at full width (``_model_cfg``; the launcher's
    ``--layers`` reduces the width too), and the state it trained kept:
    (exit code, stdout, (params, AdamW state) after the last step; the step
    updates them in place)."""
    from repro_torch.launch import train

    build, get, kept = train.build_state, train.get_config, []

    def keep(*a, **k):
        kept.append(build(*a, **k))
        return kept[-1]

    train.build_state = keep
    train.get_config = lambda name: _model_cfg(name, depth)
    try:
        rc, out = _captured(train.main, argv)
    finally:
        train.build_state, train.get_config = build, get
    return rc, out, (kept[-1] if kept else None)


def _gloo_probe_worker(outdir: str) -> int:
    """One rank of the probe: a DTensor all-gather of the card's tensors
    under gloo (the functional collectives DTensor runs); a crash prints
    its Python stack."""
    import faulthandler

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_world, make_test_mesh

    faulthandler.enable()
    rank, _, _ = init_world("cuda", backend="gloo")
    mesh = make_test_mesh(2, 1, device_type="cuda")
    x = DTensor.from_local(torch.full((2, 3), float(rank), device="cuda"), mesh,
                           [Shard(0), Replicate()])
    got = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()[:, 0].tolist()
    torch.distributed.destroy_process_group()
    Path(outdir, f"probe{rank}.json").write_text(json.dumps(got))
    return 0


def _ranks(tmp: Path, mode: str, cards: int, deadline_s: float) -> list:
    """Run this script's ``mode`` on two ranks (torchrun's variables, rank r
    on card r, or both on card 0 with ``cards`` 1) within the deadline
    (killed past it).  Returns each rank's (exit code, log)."""
    import os

    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r if cards > 1 else 0), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        logf = open(tmp / f"{mode[2:]}{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()), mode,
                                        str(tmp)], env=env, cwd=str(ROOT), stdout=logf,
                                       stderr=subprocess.STDOUT), logf))
    deadline = time.monotonic() + deadline_s
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    return [(p.returncode, (tmp / f"{mode[2:]}{r}.log").read_text())
            for r, (p, _) in enumerate(procs)]


def gloo_takes_dtensor_cuda(torch) -> str:
    """Whether gloo runs DTensor's collectives on the card's tensors for
    two ranks sharing it: "yes", or what the ranks did."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        res = _ranks(tmp, "--gloo-probe", 1, 120)
        if all(rc == 0 for rc, _ in res):
            got = [json.loads((tmp / f"probe{r}.json").read_text()) for r in range(2)]
            return "yes" if got == [[0.0, 1.0]] * 2 else f"wrong values {got}"
        tail = [ln for ln in res[0][1].splitlines() if "Fatal" in ln or "wait_tensor" in ln
                or "Error" in ln][:3]
        return f"no: ranks exited {[rc for rc, _ in res]} ({'; '.join(tail)})"


def train_mesh_worker(outdir: str) -> int:
    """One rank of phase 10c (b) (``chip_smoke.py --train-mesh-worker DIR``):
    each model of ``MESH_TRAIN_MODELS`` at each of ``MESH_TRAIN_SHAPES``
    through ``launch.train.main`` (llama at 2x1 with a checkpoint every 2
    steps), then the 2x1 checkpoint resumed at 1x2; every launch count set
    to 0 just before each run.  Writes ``DIR/rank<r>.json``."""
    import shutil

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_world

    backend = "gloo" if torch.cuda.device_count() < 2 else "nccl"
    rank, world, dev = init_world("cuda", backend=backend)
    counters = _counters()
    ckpt = Path(outdir) / "ckpt"
    rec = {"rank": rank, "backend": backend, "device": str(dev), "runs": []}

    def one(name, shape, extra=(), label=None):
        argv = ["--arch", name, *MESH_TRAIN_ARGS, *MESH_COUNT_ARGS, "--data", str(shape[0]),
                "--model", str(shape[1]), *extra]
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rc, out, _ = _train_captured(torch, argv, MESH_TRAIN_DEPTH)
        wall = time.perf_counter() - t0
        m = [int(x.group(2)) for x in map(_MESH_BYTES.match, out.splitlines()) if x]
        comm = {int(x.group(1)): (int(x.group(2)), int(x.group(3)))
                for x in map(_MESH_COMM.match, out.splitlines()) if x}
        rec["runs"].append({"name": name, "shape": list(shape), "label": label or "run",
                            "rc": rc, "wall_s": wall, "log": _mesh_train_log(out), "comm": comm,
                            "local_bytes": m[0] if m else None,
                            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                            "launches": {k: c.launches for k, c in counters.items()},
                            "by_op": next((ln.split(": ", 1)[1] for ln in out.splitlines()
                                           if ln.startswith("[train] comm by op: ")), ""),
                            "resumed": "auto-resumed from step 2" in out})

    for shape in MESH_TRAIN_SHAPES:
        for name in MESH_TRAIN_MODELS:
            extra = (("--ckpt-dir", str(ckpt), "--ckpt-every", "2")
                     if shape == (2, 1) and name == "llama3.2-1b" else ())
            one(name, shape, extra)
    if rank == 0:  # a crash after step 2 of the 2x1 run: resume at 1x2
        shutil.rmtree(ckpt / "step_000000004")
    torch.distributed.barrier()
    one("llama3.2-1b", (1, 2), ("--ckpt-dir", str(ckpt)), "resume")
    rec["serve"] = serve_rank_cells(torch, dev, rank, outdir)
    torch.distributed.destroy_process_group()
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def phase_train_mesh_ranks(torch, dev, card, timings, gloo: str):
    """Phase 10c (b): two ranks at ``--data 2`` and ``--model 2`` (gloo
    sharing the card when it takes DTensor's collectives there, else NCCL
    with a card per rank), against the meshless runs at the same settings
    in this process: each logged loss within MESH_LOSS_TOL; each rank's
    local state bytes exactly what ``params_sharding`` implies, and at most
    MESH_BYTES_RATIO of the meshless bytes for llama; no kernel launched;
    the 2x1 checkpoint resumed at 1x2 repeats the unbroken 2x1 run's losses
    within MESH_LOSS_TOL; collective calls and bytes per rank per step,
    step ms and peak memory logged.  Returns {kernel: launches}, or None
    when it cannot run here (one card that gloo cannot share)."""
    cards = torch.cuda.device_count()
    if gloo != "yes" and cards < 2:
        log(f"train mesh (b), two ranks: not run on one {card}: gloo {gloo}; NCCL takes "
            "one card per rank: `python3 chip_smoke.py --train-mesh` on two or more cards")
        timings["train_mesh/ranks"] = {"card": card, "run": False, "gloo_dtensor_cuda": gloo}
        return None
    counters = _counters()
    ref = {}
    for name in MESH_TRAIN_MODELS:
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rc, out, state = _train_captured(torch, ["--arch", name, *MESH_TRAIN_ARGS],
                                         MESH_TRAIN_DEPTH)
        check(rc == 0, f"{name} meshless ({MESH_TRAIN_DEPTH} layers) exited {rc}")
        from repro_torch.launch.train import local_bytes

        ref[name] = {"log": _mesh_train_log(out), "bytes": local_bytes(state),
                     "peak": torch.cuda.max_memory_allocated()}
        del state
        torch.cuda.empty_cache()
    serve_ref = {name: serve_cells(torch, dev, _model_cfg(name, MESH_TRAIN_DEPTH), None,
                                   SERVE_RANK_BATCH, SERVE_RANK_SEQ, SERVE_RANK_STEPS, "kernel")
                 for name in MESH_TRAIN_MODELS}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        res = _ranks(tmp, "--train-mesh-worker", 1 if gloo == "yes" else 2,
                     MESH_TRAIN_DEADLINE_S)
        wall = time.perf_counter() - t0
        for r, (rc, text) in enumerate(res):
            frames = [ln for ln in text.splitlines() if "repro_torch" in ln or "Error" in ln]
            check(rc == 0, f"train mesh rank {r} exited {rc}: " + "\n".join(frames[-40:])
                  + text[-1500:])
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        timings["serve_mesh/ranks"] = _check_serve_ranks(torch, tmp, ranks, serve_ref, card)
    launches = dict.fromkeys(counters, 0)
    out = {"card": card, "backend": ranks[0]["backend"], "wall_s": wall, "runs": []}
    for i, run0 in enumerate(ranks[0]["runs"]):
        name, shape, label = run0["name"], tuple(run0["shape"]), run0["label"]
        cfg = _model_cfg(name, MESH_TRAIN_DEPTH)
        want_bytes = _spec_state_bytes(cfg, shape)
        log0 = {int(k): v for k, v in run0["log"].items()}
        for rk in ranks:
            run = rk["runs"][i]
            check(run["rc"] == 0, f"{name} {shape} rank {rk['rank']} exited {run['rc']}")
            check(run["local_bytes"] == want_bytes, f"{name} {shape} rank {rk['rank']}: local "
                  f"state {run['local_bytes']} bytes, the specs imply {want_bytes}")
            check(not any(run["launches"].values()), f"{name} {shape}: kernels launched "
                  f"{run['launches']}")
            for k, v in run["launches"].items():
                launches[k] += v
        ratio = want_bytes / ref[name]["bytes"]
        if name == "llama3.2-1b":
            check(ratio <= MESH_BYTES_RATIO, f"{name} {shape}: local bytes {ratio:.3f} of the "
                  f"meshless run's > {MESH_BYTES_RATIO}")
        if label == "resume":
            check(run0["resumed"], f"{name}: the 1x2 run did not resume from step 2")
            unbroken = {int(k): v for k, v in next(
                r for r in ranks[0]["runs"] if r["name"] == name and tuple(r["shape"]) == (2, 1)
                and r["label"] == "run")["log"].items()}
            check(sorted(log0) == [2, 3], f"{name}: resumed run logged {sorted(log0)}")
            gap = max(abs(log0[s][0] - unbroken[s][0]) for s in log0)
            check(gap <= MESH_LOSS_TOL, f"{name}: 2x1 checkpoint resumed at 1x2: losses "
                  f"{gap} from the unbroken run's")
            log(f"train mesh (b) {name}: the 2x1 checkpoint resumed at 1x2 (restore_resharded)"
                f", steps 2-3 within {gap:.3g} of the unbroken 2x1 run")
            out["resume_gap"] = gap
            continue
        want = ref[name]["log"]
        check(sorted(log0) == sorted(want) == list(range(4)), f"{name} {shape}: steps "
              f"{sorted(log0)}")
        gap = max(abs(log0[s][0] - want[s][0]) for s in want)
        gn = max(abs(log0[s][1] - want[s][1]) for s in want)
        gn0 = abs(log0[0][1] - want[0][1]) / want[0][1]
        check(gap <= MESH_LOSS_TOL, f"{name} {shape}: losses {gap} from the meshless run's")
        check(gn0 <= MESH_GNORM_RTOL, f"{name} {shape}: step 0's grad norm {log0[0][1]} is "
              f"{gn0:.3g} (relative) from the meshless run's {want[0][1]}")
        # the faster of steps 1 and 2: step 0 warms up, step 3 runs the
        # collective counter, and llama's 2x1 run writes a checkpoint
        # between steps 1 and 2
        times = [log0[s][3] for s in range(3)]
        step_ms = min(b - a for a, b in zip(times, times[1:])) * 1e3
        ref_t = [want[s][3] for s in range(3)]
        ref_ms = min(b - a for a, b in zip(ref_t, ref_t[1:])) * 1e3
        per_rank = [(rk["rank"], *rk["runs"][i]["comm"]["3"], rk["runs"][i]["peak_memory_bytes"])
                    for rk in ranks]  # step 3's collectives
        out["runs"].append({"name": name, "shape": list(shape), "loss_gap": gap,
                            "gnorm_gap": gn, "gnorm_step0_rel_gap": gn0,
                            "local_bytes": want_bytes,
                            "meshless_bytes": ref[name]["bytes"], "bytes_ratio": ratio,
                            "step_ms": step_ms, "meshless_step_ms": ref_ms,
                            "collectives_by_op_rank0": run0["by_op"],
                            "collectives_per_step": [(r, c, b) for r, c, b, _ in per_rank],
                            "peak_memory_bytes": [p for *_, p in per_rank],
                            "meshless_peak_memory_bytes": ref[name]["peak"]})
        log(f"train mesh (b) {name} {shape[0]}x{shape[1]} ({ranks[0]['backend']}, "
            f"{'two ranks on one card' if ranks[0]['backend'] == 'gloo' else 'a card per rank'}"
            f", {card}): losses within {gap:.3g} of the meshless run's (grad norms "
            f"{gn:.3g}; step 0's {gn0:.3g} relative); local state {want_bytes} bytes per rank = the specs' "
            f"({ratio:.3f} of the meshless {ref[name]['bytes']}); median step "
            f"{step_ms:.1f} ms against the meshless {ref_ms:.1f} ms (the faster of steps 1 and 2)"
            f"; by op on rank 0 ({run0['by_op']}); per rank, step 3: "
            + "; ".join(f"rank {r} {c} collectives {b} bytes, peak {p / 1e9:.2f} GB"
                        for r, c, b, p in per_rank)
            + f" (meshless peak {ref[name]['peak'] / 1e9:.2f} GB); no kernel launched")
    timings["train_mesh/ranks"] = out
    return launches


def serve_rank_cells(torch, dev, rank, outdir, device_type="cuda") -> list:
    """One rank's serving cells of ``--train-mesh``: each
    ``MESH_TRAIN_MODELS`` model at each ``MESH_TRAIN_SHAPES`` mesh through
    ``serve_cells`` (impl="kernel"), every launch count set to 0 just
    before; the logits to ``outdir/serve_<name>_<d>x<m>_<rank>.pt``.
    Returns [{name, shape, prefill_ms, decode_ms, peak_bytes, decode_comm,
    launches}]."""
    from repro_torch.launch.mesh import make_test_mesh

    counters, out = _counters(), []
    for shape in MESH_TRAIN_SHAPES:
        mesh = make_test_mesh(*shape, device_type=device_type)
        for name in MESH_TRAIN_MODELS:
            for c in counters.values():
                c.launches = 0
            r = serve_cells(torch, dev, _model_cfg(name, MESH_TRAIN_DEPTH), mesh,
                            SERVE_RANK_BATCH, SERVE_RANK_SEQ, SERVE_RANK_STEPS, "kernel")
            torch.save(r.pop("logits"), Path(outdir, f"serve_{name}_{shape[0]}x{shape[1]}_"
                                                     f"{rank}.pt"))
            out.append({"name": name, "shape": list(shape), **r,
                        "launches": {k: c.launches for k, c in counters.items()}})
    return out


def _dryrun_serve(cfg, shape):
    """The dry-run of ``serve_cells``' two cells on a fake mesh of
    ``shape`` (the plain attention and SSD: fake tensors take no kernel):
    (the larger of the prefill's and the decode's peak per device, a decode
    step's collective calls and bytes per device)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch.mesh import fake_world, make_test_mesh

    B, S, T = SERVE_RANK_BATCH, SERVE_RANK_SEQ, SERVE_RANK_STEPS
    with fake_world(shape[0] * shape[1], "cuda"):
        mesh = make_test_mesh(*shape, device_type="cuda")
        pre, dec = (dryrun.dryrun_cell(cells.Cell(cfg, s), mesh, save=False, device="cuda")
                    for s in (ShapeSpec("prefill", S, B, "prefill"),
                              ShapeSpec("decode", S + T, B, "decode")))
    coll = dec["collectives"]
    return (max(pre["memory"]["per_device_bytes"], dec["memory"]["per_device_bytes"]),
            (sum(coll["counts"].values()), coll["total_bytes"]))


def _check_serve_ranks(torch, tmp, ranks, refs, card) -> list:
    """--train-mesh's serving cells: each rank's prefill and decode logits
    (``serve_cells`` on its mesh) within LM_LOGIT_TOL of the meshless run
    (``refs``); each rank's measured peak logged beside the dry-run's
    prediction for that mesh."""
    out = []
    for i, s0 in enumerate(ranks[0]["serve"]):
        name, shape = s0["name"], tuple(s0["shape"])
        cfg = _model_cfg(name, MESH_TRAIN_DEPTH)
        want, want_comm = _dryrun_serve(cfg, shape)
        for rk in ranks:
            got = {"logits": torch.load(tmp / f"serve_{name}_{shape[0]}x{shape[1]}_"
                                              f"{rk['rank']}.pt")}
            gap = _logit_gap(got, refs[name])
            check(gap <= LM_LOGIT_TOL, f"serve mesh {name} {shape} rank {rk['rank']}: logits "
                  f"{gap} from the meshless run's > {LM_LOGIT_TOL}")
            s = rk["serve"][i]
            out.append({"name": name, "shape": list(shape), "rank": rk["rank"], "gap": gap,
                        "peak_bytes": s["peak_bytes"], "dryrun_peak_bytes": want,
                        "prefill_ms": s["prefill_ms"], "decode_ms": s["decode_ms"],
                        "decode_comm": s["decode_comm"], "dryrun_decode_comm": want_comm,
                        "launches": s["launches"]})
            log(f"serve mesh (ranks) {name} {shape[0]}x{shape[1]} rank {rk['rank']} "
                f"({MESH_TRAIN_DEPTH} layers, B={SERVE_RANK_BATCH}, S={SERVE_RANK_SEQ}, "
                f"{SERVE_RANK_STEPS} decode steps, impl=kernel, {card}): logits within "
                f"{gap:.4g} of the meshless run; peak {s['peak_bytes'] / 1e9:.3f} GB beside the "
                f"dry-run's {want / 1e9:.3f} GB; prefill {s['prefill_ms']:.1f} ms, decode "
                f"{s['decode_ms']:.1f} ms a step (meshless {refs[name]['prefill_ms']:.1f} / "
                f"{refs[name]['decode_ms']:.1f}); a decode step's collectives "
                f"{s['decode_comm'][0]} calls {s['decode_comm'][1]} B (the dry-run's "
                f"{want_comm[0]} calls {want_comm[1]} B); launches {s['launches']}")
    return out


def _traced_1x1_step(torch, dev, name):
    """One step of ``name`` at phase 10b's shapes on a 1x1 mesh in a world
    of one under NCCL, as ``launch.train --data 1 --model 1`` runs it
    (DTensor state, ``use_rules``): (ms of an untraced step after a
    warm-up, the trace summary of one more: device busy, idle share)."""
    import torch.distributed as dist

    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train

    cfg = _model_cfg(name)
    lmesh.init_world("cuda")
    try:
        mesh = lmesh.make_test_mesh(1, 1, device_type="cuda")
        params, opt = train.build_state(cfg, dev, 0, mesh)
        batch_fn, placed = train.batch_source(cfg, TRAIN_SEQ, TRAIN_BATCH, 0, dev, mesh)
        batch = placed(batch_fn(0))

        def one():
            return _train_step_timed(torch, dev, cfg, True, params, opt, batch)[0]

        with ctx.use_rules(mesh, sharding.make_rules(mesh)):
            one()  # warm-up
            ms = one()
            prof, wall = _profiled(torch, one)
        per = device_kernels(prof)
        del params, opt, batch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return ms, (_trace_summary(per, (), wall) if per else {"device": "not measured"})


def phase_train_mesh(torch, dev, card, timings):
    """Phase 10c: (a) llama3.2-1b at full width and depth (``--seq 1024
    --batch 4``, phase 10b's steps and seed) through ``launch.train.main``
    meshless and then at ``--data 1 --model 1`` in a world of one under
    NCCL, every launch count set to 0 just before each run: the 1x1 run's
    losses and grad norms within MESH_LOSS_TOL of phase 10b's and of the
    meshless run here (the largest gap logged, and whether the final
    parameters and moments are the meshless run's bits), its step ms and
    peak memory beside phase 10b's, no kernel launched; (b) the two-rank
    runs (``phase_train_mesh_ranks``).  Returns {kernel: launches}."""
    import torch.distributed as dist

    from repro_torch.models.common import tree_leaves

    name = "llama3.2-1b"
    steps = TRAIN_PATHS[name][0]
    counters = _counters()
    argv = ["--arch", name, "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
            "--steps", str(steps), "--log-every", "1"]
    runs = {}
    for label, extra in (("meshless", []), ("1x1", ["--data", "1", "--model", "1"])):
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rc, out, state = _train_captured(torch, argv + extra)
        check(rc == 0, f"{name} {label}: launch.train.main exited {rc}")
        peak = _check_memory(torch, f"{name} {label} training")
        launches = {k: c.launches for k, c in counters.items()}
        check(not any(launches.values()), f"{name} {label}: kernels launched {launches}")
        if label == "1x1":
            check("(1 ranks, nccl)" in out, f"{name} 1x1 did not run in a world of one under "
                  f"NCCL: {out.splitlines()[:1]}")
            check(not dist.is_initialized(), "the 1x1 run left its process group")
        lg = _mesh_train_log(out)
        check(sorted(lg) == list(range(steps)), f"{name} {label}: steps {sorted(lg)}")
        # on the host: the next run's peak counts only its own tensors
        leaves = [(x.to_local() if hasattr(x, "to_local") else x).detach().cpu()
                  for x in tree_leaves(state)]
        runs[label] = {"log": lg, "peak": peak, "leaves": leaves, "launches": launches}
        del state
    ref10b = timings[f"train/{name}"]
    mesh, plain = runs["1x1"], runs["meshless"]
    gap10b = max(max(abs(mesh["log"][s][0] - ref10b["losses"][s]),
                     abs(mesh["log"][s][1] - ref10b["grad_norms"][s])) for s in range(steps))
    gap = max(max(abs(mesh["log"][s][0] - plain["log"][s][0]),
                  abs(mesh["log"][s][1] - plain["log"][s][1])) for s in range(steps))
    check(gap10b <= MESH_LOSS_TOL and gap <= MESH_LOSS_TOL, f"{name} 1x1: losses / grad norms "
          f"{gap10b} from phase 10b's, {gap} from the meshless run's")
    bits = len(mesh["leaves"]) == len(plain["leaves"]) and all(
        torch.equal(a, b) for a, b in zip(mesh["leaves"], plain["leaves"]))
    del plain["leaves"], mesh["leaves"]
    torch.cuda.empty_cache()

    def median_ms(lg):
        t = [lg[s][3] for s in range(steps)]
        d = sorted(b - a for a, b in zip(t, t[1:]))
        return d[len(d) // 2] * 1e3

    rec = {"card": card, "steps": steps, "loss_gnorm_gap_10b": gap10b,
           "loss_gnorm_gap_meshless": gap, "state_bits_equal": bits,
           "step_ms_median": median_ms(mesh["log"]),
           "meshless_step_ms_median": median_ms(plain["log"]),
           "step_ms_median_10b": ref10b["step_s_median"] * 1e3,
           "peak_memory_bytes": mesh["peak"], "meshless_peak_memory_bytes": plain["peak"],
           "peak_memory_bytes_10b": ref10b["peak_memory_bytes"]}
    # where the 1x1 step's time goes: one step timed and one traced, beside
    # phase 10b's traced meshless step (both without the collective counter)
    for c in counters.values():
        c.launches = 0
    rec["one_step_ms"], trace = _traced_1x1_step(torch, dev, name)
    check(not any(c.launches for c in counters.values()), f"{name} 1x1: the traced steps "
          "launched kernels")
    rec["trace"] = trace
    ref_trace = ref10b.get("trace", {})
    timings["train_mesh/1x1"] = rec
    log(f"train mesh (a) {name} ({TRAIN_PATHS[name][0]} steps, 16 layers, B={TRAIN_BATCH}, "
        f"S={TRAIN_SEQ}) at --data 1 --model 1, a world of one under NCCL on {card}: losses "
        f"and grad norms within {gap10b:.3g} of phase 10b's and {gap:.3g} of the meshless run "
        f"here; final params and moments {'equal' if bits else 'NOT equal'} to the meshless "
        f"run's bits; median step {rec['step_ms_median']:.1f} ms (meshless here "
        f"{rec['meshless_step_ms_median']:.1f}, phase 10b {rec['step_ms_median_10b']:.1f}), "
        f"peak {mesh['peak'] / 1e9:.2f} GB (meshless here {plain['peak'] / 1e9:.2f}, phase 10b "
        f"{ref10b['peak_memory_bytes'] / 1e9:.2f}); no kernel launched")
    if "device_busy_s" in trace and "device_busy_s" in ref_trace:
        log(f"train mesh (a) {name} 1x1 one step {rec['one_step_ms']:.1f} ms (phase 10b's "
            f"remat step {ref10b['remat']['on']['ms']:.1f}); traced: {trace['wall_s']:.3f}s host "
            f"clock, device busy {trace['device_busy_s'] * 1e3:.2f} ms (idle share "
            f"{trace['idle_share']:.4f}), {trace['device_activities']} device activities, "
            f"against phase 10b's meshless step {ref_trace['wall_s']:.3f}s, busy "
            f"{ref_trace['device_busy_s'] * 1e3:.2f} ms (idle share "
            f"{ref_trace['idle_share']:.4f}), {ref_trace['device_activities']} activities")
    else:
        log(f"train mesh (a) {name} 1x1 one step {rec['one_step_ms']:.1f} ms; device time "
            "not measured")
    gloo = gloo_takes_dtensor_cuda(torch)
    timings["train_mesh/gloo_dtensor_cuda"] = gloo
    log(f"gloo takes DTensor's collectives on the card's tensors (two ranks on one {card}): "
        f"{gloo}")
    ranks = phase_train_mesh_ranks(torch, dev, card, timings, gloo)
    launches = dict(mesh["launches"])  # the 1x1 run's, then every rank's of (b)
    for k, v in (ranks or {}).items():
        launches[k] += v
    return launches


# ------------------------------------------------------ serving on a mesh
# phase 10d: (a) llama and mamba2 prefill and decode through cells.build_step
# (impl="kernel") on a 1x1 mesh in a world of one under NCCL, held to the
# meshless kernel path; (b) the dry-run of phase 10b's llama step on a 1x1
# fake mesh beside that step's measured peak, time and FLOPs; (c) the
# dry-run of four production cells on the fake 16x16 mesh, run in the
# background from before phase 10 (host work: it overlaps the card's)
SERVE_MESH_MODELS = ("llama3.2-1b", "mamba2-780m")
SERVE_MESH_BATCH, SERVE_MESH_SEQ, SERVE_MESH_STEPS = 8, 1024, 8
# (a)'s kernel launches per prefill at full depth (decode launches none)
SERVE_MESH_LAUNCHES = {"llama3.2-1b": {"flash_attention": 16},
                       "mamba2-780m": {"ssd_scan": 48}}
# --train-mesh's cells on two ranks: full width, 2 layers
SERVE_RANK_BATCH, SERVE_RANK_SEQ, SERVE_RANK_STEPS = 4, 256, 4
# (arch, shape or None for all of its cells) dry-run on the fake 16x16 mesh
DRYRUN_CELLS = (("llama3.2-1b", None), ("mamba2-780m", "long_500k"))
DRYRUN_DEADLINE_S = 900
_DRY_LINE = re.compile(r"^\[(\S+) @ (\S+)\] (OK|FAIL) (.*)$")
# (d) the fleet DSE evaluation on B1's operator, traced with fake CUDA tensors
FLEET_DRYRUN = ("--search-mesh", "1x1", "--backend", "kernel", "--device", "cuda", "--no-save")
_FLEET_LINE = re.compile(r"^\[paper-dse-fleet (\S+)\] ok searches=(\d+) backend=kernel (.*)$")


def serve_cells(torch, dev, cfg, mesh, batch, seq, steps, impl):
    """A prefill of ``batch`` prompts of ``seq`` tokens and ``steps`` decode
    steps through ``cells.build_step`` on ``mesh`` (None: meshless), the
    float32 masters from seed 0 on ``dev`` (on a mesh cut to this rank's
    shards, the whole tree freed before the prefill), the tokens from seed
    1 (each decode step fed the next token, not a sampled one); the
    prefill cache gathered, padded to ``seq + steps`` rows and laid out by
    the decode bundle.  Returns {"logits": [prefill (B, 1, V), each decode
    step's], float32 on the host, "prefill_ms", "decode_ms" (per step; host
    clock, synchronised; the last step, which counts its collectives, not
    timed), "peak_bytes" (``max_memory_allocated`` from the prefill on: the
    shards, the cache, the temporaries), "decode_comm" (the last decode
    step's collective calls and bytes on this rank)}."""
    import contextlib
    import gc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import cells
    from repro_torch.models import transformer

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def place(tree, places):
        if mesh is None:
            return tree
        return cells.map_placed(lambda x, pl: x if pl is None else ctx.distribute(x, mesh, pl),
                                tree, places)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init(cfg, gen, device=dev)
    gen.manual_seed(1)
    toks = torch.randint(0, min(cfg.vocab_size, 1000), (batch, seq + steps), generator=gen,
                         device=dev)
    scope = (ctx.use_rules(mesh, sharding.make_rules(mesh)) if mesh is not None
             else contextlib.nullcontext())
    with scope:
        pre = cells.build_step(cfg, ShapeSpec("prefill", seq, batch, "prefill"), mesh, impl=impl)
        params, tokens = place((params, {"tokens": toks[:, :seq]}), pre.in_placements)
        gc.collect()  # what an earlier phase left unreachable is not this peak's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = pre.fn(params, tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out = [whole(logits).float().cpu()]
        padded = transformer.pad_cache(
            cfg, [{k: whole(v) for k, v in s.items()} for s in cache], seq + steps)
        del cache, tokens
        decode_ms = []
        dec = cells.build_step(cfg, ShapeSpec("decode", seq + steps, batch, "decode"), mesh)
        run = place(padded, dec.in_placements[1])
        del padded
        for t in range(steps):
            b = place({"token": toks[:, seq + t:seq + t + 1],
                       "pos": torch.full((batch,), seq + t, dtype=torch.int64, device=dev)},
                      dec.in_placements[2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if t == steps - 1:
                sharding.COMM.reset()
                with sharding.count_collectives():
                    lg, run = dec.fn(params, run, b)
                comm = (sharding.COMM.calls, sharding.COMM.bytes)
            else:
                lg, run = dec.fn(params, run, b)
                torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(whole(lg).float().cpu())
    peak = torch.cuda.max_memory_allocated()
    del params, run
    torch.cuda.empty_cache()
    return {"logits": out, "prefill_ms": prefill_ms, "decode_ms": sum(decode_ms) / len(decode_ms),
            "peak_bytes": peak, "decode_comm": comm}


def _logit_gap(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a["logits"], b["logits"]))


def start_dryruns(tmp: Path):
    """Phase 10d's dry-runs in the background, each a process of its own
    (fake tensors claiming the card: nothing is allocated there): (b)'s
    train step (``--dryrun-step``, its record to ``tmp/step.json``), then
    (c), one ``launch.dryrun`` per ``DRYRUN_CELLS`` entry on the fake
    16x16 mesh, records to ``tmp``, then (d), ``launch.dryrun`` of the
    fleet DSE evaluation on the kernel backend (``FLEET_DRYRUN``).
    Returns (the start's host clock, [(proc, log path)])."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    with open(tmp / "step.log", "w") as f:
        procs = [(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                    "--dryrun-step", str(tmp / "step.json")], env=env,
                                   cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT),
                  tmp / "step.log")]
    for i, (arch, shape) in enumerate(DRYRUN_CELLS):
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--mesh", "single", "--device", "cuda", "--out", str(tmp)]
        if shape:
            argv += ["--shape", shape]
        logf = tmp / f"dryrun{i}.log"
        with open(logf, "w") as f:
            procs.append((subprocess.Popen(argv, env=env, cwd=str(ROOT), stdout=f,
                                           stderr=subprocess.STDOUT), logf))
    logf = tmp / "fleet.log"
    with open(logf, "w") as f:
        procs.append((subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                                        *FLEET_DRYRUN], env=env, cwd=str(ROOT), stdout=f,
                                       stderr=subprocess.STDOUT), logf))
    return time.perf_counter(), procs


def stop_dryruns(started) -> None:
    for p, _ in started[1]:
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_serve_mesh(torch, dev, card, timings):
    """Phase 10d (a): each ``SERVE_MESH_MODELS`` model at full width and
    depth, ``SERVE_MESH_BATCH`` prompts of ``SERVE_MESH_SEQ`` tokens and
    ``SERVE_MESH_STEPS`` decode steps through ``cells.build_step(...,
    impl="kernel")``, meshless and then on a 1x1 mesh in a world of one
    under NCCL, every launch count set to 0 just before the mesh run: its
    prefill and decode logits within LM_LOGIT_TOL of the meshless run's,
    its prefill's kernel launches ``SERVE_MESH_LAUNCHES`` and no other.
    Returns {kernel: launches of the mesh runs}."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_test_mesh

    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    out = {}
    for name in SERVE_MESH_MODELS:
        cfg = _model_cfg(name)
        shape = (SERVE_MESH_BATCH, SERVE_MESH_SEQ, SERVE_MESH_STEPS)
        ref = serve_cells(torch, dev, cfg, None, *shape, "kernel")
        init_world("cuda")
        try:
            mesh = make_test_mesh(1, 1, device_type="cuda")
            for c in counters.values():
                c.launches = 0
            got = serve_cells(torch, dev, cfg, mesh, *shape, "kernel")
            mine = {k: c.launches for k, c in counters.items()}
        finally:
            dist.destroy_process_group()
        _check_launches(f"{name} prefill on a 1x1 mesh", mine, SERVE_MESH_LAUNCHES[name])
        for k, v in mine.items():
            launches[k] += v
        gap = _logit_gap(got, ref)
        check(gap <= LM_LOGIT_TOL, f"{name} 1x1 mesh: logits {gap} from the meshless kernel "
              f"path's > {LM_LOGIT_TOL}")
        check(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
              f"{name} 1x1 mesh: logits not finite")
        out[name] = {"gap": gap, "launches": mine, **{k: got[k] for k in
                                                       ("prefill_ms", "decode_ms", "peak_bytes")},
                     "meshless": {k: ref[k] for k in ("prefill_ms", "decode_ms", "peak_bytes")}}
        log(f"serve mesh (a) {name} ({cfg.n_layers} layers, B={SERVE_MESH_BATCH}, "
            f"S={SERVE_MESH_SEQ}, {SERVE_MESH_STEPS} decode steps) through cells.build_step "
            f"impl=kernel on a 1x1 mesh under NCCL ({card}): prefill and decode logits within "
            f"{gap:.4g} of the meshless kernel path (bound {LM_LOGIT_TOL}); launches {mine}; "
            f"prefill {got['prefill_ms']:.1f} ms (meshless {ref['prefill_ms']:.1f}), decode "
            f"{got['decode_ms']:.1f} ms a step (meshless {ref['decode_ms']:.1f}), peak "
            f"{got['peak_bytes'] / 1e9:.2f} GB (meshless {ref['peak_bytes'] / 1e9:.2f})")
    timings["serve_mesh/1x1"] = out
    return launches


def dryrun_step_worker(path: str) -> int:
    """``chip_smoke.py --dryrun-step FILE``: the dry-run of phase 10b's
    llama3.2-1b step (B=4, S=1024, remat, one microbatch) on a 1x1 fake
    mesh of fake tensors on the card's device type; writes its record to
    FILE (phase 10d (b) reads it), with the meshless step's dry-run memory
    (``meshless``) beside."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch.mesh import fake_world, make_test_mesh

    cell = cells.Cell(_model_cfg("llama3.2-1b"), ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                                           "train"))
    with fake_world(1, "cuda"):
        mesh = make_test_mesh(1, 1, device_type="cuda")
        rec = dryrun.dryrun_cell(cell, mesh, save=False, device="cuda",
                                 build_kwargs={"accum": 1})
    rec["meshless"] = dryrun.dryrun_cell(cell, None, save=False, device="cuda",
                                         build_kwargs={"accum": 1})["memory"]
    Path(path).write_text(json.dumps(rec, default=str))
    return 0


def phase_dryrun_step(started, card, timings):
    """Phase 10d (b): the dry-run of phase 10b's llama3.2-1b step
    (``dryrun_step_worker``, in the background since the training phases
    began), its per-device peak beside phase 10b's measured
    ``max_memory_allocated`` of that step, its counted FLOPs beside
    ``model_flops``; and the step's ``mfu`` (model FLOPs over the measured
    step time at the bf16 peak) and the counted FLOPs' share of the same."""
    from repro_torch.analysis.roofline import PEAK_FLOPS

    name = "llama3.2-1b"
    p, logf = _wait_dryrun(started, 0)
    check(p.returncode == 0, f"dry-run of the train step exited {p.returncode}: "
          + logf.read_text()[-1500:])
    rec = json.loads((logf.parent / "step.json").read_text())
    measured = timings[f"train/{name}"]["remat"]["on"]
    step_s = measured["ms"] / 1e3
    mf, counted = rec["cost"]["model_flops_global"], rec["cost"]["flops_per_device"]
    mfu, share = mf / (step_s * PEAK_FLOPS), counted / (step_s * PEAK_FLOPS)
    peak, got = measured["peak_memory_bytes"], rec["memory"]["per_device_bytes"]
    timings["dryrun/train_step"] = {"card": card, "mfu": mfu, "counted_share": share,
                                    "step_ms": measured["ms"], "model_flops": mf,
                                    "counted_flops": counted, "dryrun_peak_bytes": got,
                                    "measured_peak_bytes": peak, "trace_s": rec["trace_s"],
                                    "memory": rec["memory"], "meshless_memory": rec["meshless"]}
    log(f"{name} train step (B={TRAIN_BATCH}, S={TRAIN_SEQ}, remat) on {card}: "
        f"{measured['ms']:.1f} ms (phase 10b), mfu {mfu:.4f} (model_flops {mf:.4e} over the "
        f"step at {PEAK_FLOPS:.3g} FLOP/s), counted FLOPs' share {share:.4f}")
    log(f"dry-run (b) {name} train step on a 1x1 fake mesh (trace {rec['trace_s']:.1f}s): "
        f"peak per device {got / 1e9:.2f} GB beside phase 10b's measured "
        f"{peak / 1e9:.2f} GB (dry-run / measured {got / peak:.3f}; the meshless step's "
        f"dry-run {rec['meshless']['per_device_bytes'] / 1e9:.2f} GB); counted FLOPs "
        f"{counted:.4e} beside model_flops {mf:.4e} (ratio {counted / mf:.3f})")


def _wait_dryrun(started, i):
    """The ``i``-th background dry-run, waited for within DRYRUN_DEADLINE_S
    of the start (killed past it): (its process, its log path)."""
    t0, procs = started
    p, logf = procs[i]
    try:
        p.wait(timeout=max(1.0, DRYRUN_DEADLINE_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    return p, logf


def phase_dryrun_cells(started, card, timings):
    """Phase 10d (c): wait for the background dry-runs (``start_dryruns``)
    within DRYRUN_DEADLINE_S of their start, each exiting 0 with every
    cell OK: llama3.2-1b's train_4k, prefill_32k, decode_32k and
    mamba2-780m's long_500k on the fake 16x16 mesh; each cell's line
    (trace seconds, memory, FLOPs, collective bytes, bottleneck) logged.
    Then (d): the fleet DSE dry-run on the kernel backend exits 0 with
    its OK line (B1's operator traced with fake CUDA tensors)."""
    t0, procs = started
    lines = []
    for i in range(1, len(procs) - 1):
        p, logf = _wait_dryrun(started, i)
        text = logf.read_text()
        lines += [m for m in map(_DRY_LINE.match, text.splitlines()) if m]
        check(p.returncode == 0, f"dry-run {p.args[4:]} exited {p.returncode}: "
              + text[-1500:])
    ok = [m for m in lines if m.group(3) == "OK"]
    check(len(ok) == 4 and len(lines) == 4, f"dry-run cells: {[m.group(0) for m in lines]}")
    timings["dryrun/16x16"] = {"card": card, "wall_s": time.perf_counter() - t0,
                               "cells": [m.group(0) for m in lines]}
    for m in ok:
        log(f"dry-run (c) {m.group(1)} on the fake 16x16 mesh ({card}'s host): {m.group(4)}")
    p, logf = _wait_dryrun(started, len(procs) - 1)
    text = logf.read_text()
    fleet = [m for m in map(_FLEET_LINE.match, text.splitlines()) if m]
    check(p.returncode == 0 and len(fleet) == 1,
          f"dry-run {' '.join(FLEET_DRYRUN)} exited {p.returncode}: " + text[-1500:])
    timings["dryrun/fleet_kernel"] = {"card": card, "line": fleet[0].group(0)}
    log(f"dry-run (d) the fleet DSE evaluation on B1's operator ({card}'s host): "
        f"{fleet[0].group(0)}")


def train_mesh_main() -> int:
    """``chip_smoke.py --train-mesh``: phase 10c (b) alone, on two cards or
    more under NCCL (a card per rank); prints its lines and the last line
    ``{"ok": true, ...}``."""
    try:
        import torch

        if torch.cuda.device_count() < 2:
            raise SmokeFailure(f"--train-mesh needs two cards, {torch.cuda.device_count()} seen")
        sys.path.insert(0, str(SRC))
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        card, name = phase_card(torch)
        timings = {"card": card}
        phase_build(timings)  # the serving cells' kernels, built before anything is timed
        phase_train_mesh_ranks(torch, dev, card, timings, "not asked (a card per rank)")
        log("timings " + json.dumps(timings))
    except SmokeFailure as e:
        print(f"[smoke] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def lm_phases(torch, dev, card, timings):
    """Phases 10 to 10d: (per-model LM launches, training launches,
    training-mesh launches, serving-mesh launches).  Phase 10d (c)'s
    dry-runs run in the background from the training phases on (host
    work beside mostly device-bound steps; phase 10's host-bound serving
    clocks run alone)."""
    lm = {name: phase_lm(torch, dev, name, card, timings) for name in LM_PATHS}
    lm.update({name: phase_lm_steps(torch, dev, name, card, timings) for name in STEP_PATHS})
    with tempfile.TemporaryDirectory(dir=ROOT) as dry_dir:
        dry = start_dryruns(Path(dry_dir))
        try:
            train_runs = [phase_train(torch, dev, name, card, timings) for name in TRAIN_PATHS]
            train_runs.append(phase_train_card_vs_cpu(torch, dev, card, timings))
            train = {k: sum(r[k] for r in train_runs) for k in train_runs[0]}
            train_mesh = phase_train_mesh(torch, dev, card, timings)
            serve_mesh = phase_serve_mesh(torch, dev, card, timings)
            phase_dryrun_step(dry, card, timings)
            phase_dryrun_cells(dry, card, timings)
        finally:
            stop_dryruns(dry)
    return lm, train, train_mesh, serve_mesh


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card, name = phase_card(torch)
    timings = {"card": card}
    phase_build(timings)
    paper = _paper_ws()
    b1_err = phase_b1(torch, dev, paper, timings)
    phase_b2(torch, dev, timings)
    phase_host_split(torch, dev, paper, timings)
    b3_err = phase_b3(torch, dev, timings)
    b4_err = phase_b4(torch, dev, timings)

    from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi

    b1_launches = phase_main_path(torch, dev, "kernel", imc_eval_multi, timings=timings)
    b2_launches = phase_main_path(torch, dev, "table", ga_gen_step, timings=timings)
    for backend in ("kernel", "table"):
        phase_trace(torch, dev, backend, timings)
    serve_launches = phase_service(torch, dev, card, timings)
    fam = phase_families(torch, dev, card, timings)
    threefry = phase_threefry(torch, dev, card, timings)
    mesh = phase_mesh(torch, dev, card, timings)
    surface = phase_surface(torch, dev, card, timings)
    fam_b1 = {k: v["imc_eval"] for k, v in fam.items() if v["imc_eval"]}
    fam_b2 = {k: v["ga_gen_step"] for k, v in fam.items() if v["ga_gen_step"]}
    surf = {kname: {k: v[kname] for k, v in surface.items() if v[kname]}
            for kname in ("imc_eval", "ga_gen_step", "flash_attention", "ssd_scan")}
    lm, train, train_mesh, serve_mesh = lm_phases(torch, dev, card, timings)
    lm_b3 = {k: v["flash_attention"] for k, v in lm.items() if "flash_attention" in v}
    lm_b4 = {k: v["ssd_scan"] for k, v in lm.items() if "ssd_scan" in v}

    log("timings " + json.dumps(timings))


    t1, t2 = timings["imc_eval/main"], timings["ga_gen_step/main"]
    s1, s2 = timings["imc_eval/separate"], timings["ga_gen_step/separate"]
    v1, v2 = timings["imc_eval/service"], timings["ga_gen_step/service"]
    # B3 and B4 at the longest prompt of the main path, in the model's dtype
    t3, t4 = timings["flash_attention/s1024"], timings["ssd_scan/bf16_s1024"]
    # ... and at mixtral's, gemma's and jamba's prefill shapes
    m3, j4 = timings["flash_attention/mixtral_s1024"], timings["ssd_scan/jamba_bf16_s1024"]
    g3 = timings["flash_attention/gemma_s1024"]
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "plain_device_ms",
             "max_abs_err")
    kernels = [
        {"name": "imc_eval", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/imc_eval.cu",
         "replaces": "src/repro/kernels/imc_eval/kernel.py:47",
         "launches": b1_launches + serve_launches["imc_eval"] + sum(fam_b1.values())
         + sum(v["imc_eval"] for v in threefry.values())
         + sum(v["imc_eval"] for v in mesh.values()) + sum(surf["imc_eval"].values()),
         "launches_by_path": {"search": b1_launches,
                              "serve": serve_launches["imc_eval"], **fam_b1,
                              **{k: v["imc_eval"] for k, v in threefry.items()},
                              **{k: v["imc_eval"] for k, v in mesh.items()},
                              **surf["imc_eval"],
                              "train": train["imc_eval"], "train_mesh": train_mesh["imc_eval"]},
         "max_abs_err": b1_err[0],
         "max_rel_err": b1_err[1],
         "ms": t1["ms"], "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
         "bound_by": t1["bound_by"], "library_ms": None,
         "device_ms": t1["device_ms"], "plain_device_ms": t1["plain_device_ms"],
         "separate_ms": s1["ms"], "separate_device_ms": s1["device_ms"],
         "service_ms": v1["ms"], "service_device_ms": v1["device_ms"],
         "service_bound_ms": v1["bound_ms"]},
        {"name": "ga_gen_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ga_gen_step.cu",
         "replaces": "src/repro/kernels/ga_gen_step/kernel.py:115",
         "launches": b2_launches + serve_launches["ga_gen_step"] + sum(fam_b2.values())
         + sum(v["ga_gen_step"] for v in threefry.values())
         + sum(v["ga_gen_step"] for v in mesh.values()) + sum(surf["ga_gen_step"].values()),
         "launches_by_path": {"search": b2_launches,
                              "serve": serve_launches["ga_gen_step"], **fam_b2,
                              **{k: v["ga_gen_step"] for k, v in threefry.items()},
                              **{k: v["ga_gen_step"] for k, v in mesh.items()},
                              **surf["ga_gen_step"],
                              "train": train["ga_gen_step"],
                              "train_mesh": train_mesh["ga_gen_step"]},
         "max_abs_err": 0.0,
         "ms": t2["ms"], "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
         "bound_by": t2["bound_by"], "library_ms": None,
         "device_ms": t2["device_ms"], "plain_device_ms": t2["plain_device_ms"],
         "separate_ms": s2["ms"], "separate_device_ms": s2["device_ms"],
         "service_ms": v2["ms"], "service_device_ms": v2["device_ms"],
         "service_bound_ms": v2["bound_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
         "launches": sum(lm_b3.values()) + serve_mesh["flash_attention"]
         + sum(surf["flash_attention"].values()),
         "launches_by_path": {**lm_b3, **surf["flash_attention"],
                              "train": train["flash_attention"],
                              "train_mesh": train_mesh["flash_attention"],
                              "serve_mesh": serve_mesh["flash_attention"]},
         "max_abs_err": b3_err["s1024"],
         "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": t3["library_ms"],
         "device_ms": t3["device_ms"], "plain_device_ms": t3["plain_device_ms"],
         "library_device_ms": t3["library_device_ms"], "encode_us": t3["encode_us"],
         "tensor_core_instructions": timings["flash_attention/sass"],
         **{f"{shape}_shape": {k: r[k] for k in times + ("library_ms", "library_device_ms",
                                                           "encode_us")}
            for shape, r in (("mixtral", m3), ("gemma", g3))}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:33",
         "launches": sum(lm_b4.values()) + serve_mesh["ssd_scan"]
         + sum(surf["ssd_scan"].values()),
         "launches_by_path": {**lm_b4, **surf["ssd_scan"], "train": train["ssd_scan"],
                              "train_mesh": train_mesh["ssd_scan"],
                              "serve_mesh": serve_mesh["ssd_scan"]},
         "max_abs_err": b4_err["bf16_s1024"][0],
         "max_abs_err_f32": b4_err["s1024"][0], "device_kernels_per_call": len(t4["device_parts"]),
         "ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
         "bound_by": t4["bound_by"], "library_ms": None,
         "device_ms": t4["device_ms"], "plain_device_ms": t4["plain_device_ms"],
         "device_ms_by_kernel": t4["device_parts"],
         "tensor_core_instructions": timings["ssd_scan/sass"],
         "jamba_shape": {**{k: j4[k] for k in times if k != "max_abs_err"},
                         "max_abs_err": j4["max_abs_err_y"], "library_ms": None,
                         "device_ms_by_kernel": j4["device_parts"]}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as e:
        print(f"[smoke] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-worker":
        sys.exit(mesh_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--train-mesh-worker":
        sys.exit(train_mesh_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--gloo-probe":
        sys.exit(_gloo_probe_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-step":
        sys.exit(dryrun_step_worker(sys.argv[2]))
    if sys.argv[1:] == ["--train-mesh"]:
        sys.exit(train_mesh_main())
    sys.exit(main())

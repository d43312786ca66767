"""The plain reference against the port's dense path on the CPU, its
factored grid against its dense form, and the control's distance."""
import numpy as np
import pytest
import torch

from bench.reference import grid, model


@pytest.fixture(scope="module")
def cnn4():
    from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload

    return {n: cnn_workload(n) for n in PAPER_WORKLOADS}


def _genomes(n, seed=0):
    return torch.rand((n, 9), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", model.KINDS)
@pytest.mark.parametrize("area", [150.0, 1e9])
def test_reference_equals_the_ports_dense_path(cnn4, kind, area):
    from repro_torch.core import space
    from repro_torch.core.objectives import make_objective
    from repro_torch.imc.cost import evaluate_designs
    from repro_torch.workloads.pack import pack_workloads

    g = _genomes(400)
    ws = pack_workloads(list(cnn4.items()))
    prog = make_objective(kind, area)(evaluate_designs(space.decode(g), ws)).double()
    feats, mask = model.workload_tensors(list(cnn4.values()))
    ref = model.score_genomes(g, feats, mask, kind, area)
    assert torch.equal(torch.isfinite(prog), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    assert torch.allclose(prog[fin], ref[fin], rtol=1e-5, atol=0)
    # decoding: the port's grid cell of every genome
    assert torch.equal(model.decode(g), space.decode_indices(g))


def test_vf_boundary_cell_is_invalid():
    """v = 0.9 V, t = 1.0 ns: t_min is 1.0000001 in float32."""
    table = model.vf_table()
    v = list(model.GRID["v_op"]).index(np.float32(0.9))
    t = list(model.GRID["t_cycle_ns"]).index(np.float32(1.0))
    assert not bool(table[v, t]) and bool(table[v, t + 1])


def test_factored_grid_equals_the_dense_model(cnn4):
    idx = model.decode(_genomes(500, 1))
    feats, mask = model.workload_tensors(list(cnn4.values()))
    energy, latency, a, fits, valid = model.evaluate(idx, feats, mask)
    tabs = [grid.workload_tables(t, "cpu") for t in cnn4.values()]
    per, a2, valid2 = grid._metrics({f: idx[:, j] for j, f in enumerate(model.FIELDS)}, tabs)
    assert torch.equal(valid, valid2) and torch.allclose(a, a2, rtol=1e-14)
    for w, (e, lat, f) in enumerate(per):
        assert torch.allclose(e, energy[:, w], rtol=1e-12)
        assert torch.allclose(lat, latency[:, w], rtol=1e-12)
        assert torch.equal(f, fits[:, w])


def test_rank_share_counts_strictly_better_cells(cnn4):
    """On one workload and the latency objective, the rank of a cell is the
    count of feasible cells of lower latency, counted here the slow way."""
    names = ("alexnet",)
    tables = {"alexnet": grid.workload_tables(cnn4["alexnet"], "cpu")}
    idx = model.decode(_genomes(3, 2)).numpy()
    idx[:, model.FIELDS.index("v_op")] = 12  # 1.0 V: valid at every cycle >= 1 ns
    shares = grid.rank_shares(tables, [(names, "l", 1e9, i) for i in idx] +
                              [(names, "l", 1e9, None)], "cpu")
    all_idx = torch.cartesian_prod(*[torch.arange(len(model.GRID[f])) for f in model.FIELDS])
    feats, mask = model.workload_tensors([cnn4["alexnet"]])
    s = torch.cat([model.score("l", 1e9, *model.evaluate(all_idx[i:i + 400000], feats, mask))
                   for i in range(0, len(all_idx), 400000)])
    fin = s[torch.isfinite(s)]
    for i, share in zip(idx, shares):
        mine = model.score("l", 1e9, *model.evaluate(torch.as_tensor(i)[None], feats, mask))
        assert share == pytest.approx(float((fin < mine).sum()) / len(fin), rel=1e-12)
    assert shares[-1] == 1.0


def test_the_control_is_far_from_the_reference(cnn4):
    g = _genomes(2000, 3)
    feats, mask = model.workload_tensors(list(cnn4.values()))
    ref = model.score_genomes(g, feats, mask, "ela", 1e9)
    low = model.score_genomes(g, feats, mask, "ela", 1e9, dtype=torch.bfloat16).double()
    fin = torch.isfinite(ref) & torch.isfinite(low)
    gap = ((low[fin] - ref[fin]).abs() / ref[fin].abs()).max()
    assert gap > 1e-3

"""The benchmark's plain reference of the IMC search's answers.

A frozen rewrite, in plain PyTorch, of what a design-space search answers
with: the decoding of a genome to a grid cell (``model.decode``), the
analytical cost model's energy, latency, area, fit and V/f validity of a
design on a workload (``model.evaluate``), the objective under the area
limit (``model.score``), and the exact rank of a design among every cell of
the 19,200,000-cell grid (``grid.rank_shares``).  It imports nothing of the
program under test and takes nothing it made: the layer tables come from
the benchmark's configuration files, the grid and the technology constants
are written out here.  It computes in float64 unless asked for a lower
precision (the control).
"""

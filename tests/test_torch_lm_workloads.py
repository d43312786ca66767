"""Port parity: LM configurations exported as IMC workloads.

For each of the ten configurations and both modes, the port's
``workloads/lm.py`` exports the reference's layers exactly, the packed
``WorkloadSet`` has the reference's fingerprint (so content caches key the
same sets alike), and the configurations carry the reference's fields.
The CLI's ``--lm-workloads`` builds the same set, and an unknown mode is
refused."""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import pytest

from repro.configs.base import get_config as rget
from repro.configs.base import list_configs as rlist
from repro.workloads.cnn import cnn_workload as r_cnn
from repro.workloads.lm import lm_workload as r_lm
from repro.workloads.pack import pack_workloads as rpack
from repro_torch.configs.base import get_config, list_configs
from repro_torch.launch.search import build_workloads
from repro_torch.workloads.lm import lm_workload
from repro_torch.workloads.pack import pack_workloads

MODES = [("decode", 1), ("prefill", 64)]


def test_registry_holds_the_reference_configs():
    assert list_configs() == rlist()


@pytest.mark.parametrize("name", rlist())
def test_config_fields_match_reference(name):
    ours, ref = dataclasses.asdict(get_config(name)), dataclasses.asdict(rget(name))
    assert ours == {k: ref[k] for k in ours}


@pytest.mark.parametrize("mode,seq", MODES)
@pytest.mark.parametrize("name", rlist())
def test_lm_layers_and_fingerprint_match_reference(name, mode, seq):
    ours = lm_workload(get_config(name), mode=mode, seq=seq)
    ref = r_lm(rget(name), mode=mode, seq=seq)
    assert ours == ref
    ws, ws_r = pack_workloads([(name, ours)]), rpack([(name, ref)])
    np.testing.assert_array_equal(ws.feats.numpy(), np.asarray(ws_r.feats))
    assert ws.fingerprint() == ws_r.fingerprint()


def test_cli_builds_the_reference_mix():
    args = argparse.Namespace(workloads="alexnet", lm_workloads="llama3.2-1b,mamba2-780m",
                              mode="prefill", seq=32)
    ws = build_workloads(args)
    ws_r = rpack([("alexnet", r_cnn("alexnet"))]
                 + [(n, r_lm(rget(n), mode="prefill", seq=32))
                    for n in ("llama3.2-1b", "mamba2-780m")])
    assert ws.names == ws_r.names and ws.fingerprint() == ws_r.fingerprint()
    with pytest.raises(ValueError, match="mode"):
        lm_workload(get_config("llama3.2-1b"), mode="train")

"""The frozen layer tables are the published networks' shapes: the port's
exports at this commit where those follow the publication, and written
out here where they do not (ResNet18's padded max pool, whisper-medium's
decoder at decode).  The frozen roofline arithmetic gives the bounds
PERF.md reports."""
import json

import pytest

from bench.harness import yardstick
from bench.harness.spec import ROOT


def _config(name):
    return json.loads((ROOT / "bench/configs" / f"{name}.json").read_text())


def _conv(h, c, cout, k, s, p):
    ho = (h + 2 * p - k) // s + 1
    return [ho * ho, c * k * k, cout, h * h * c, ho * ho * cout, 1], ho


def _resnet18():
    """He et al. (2016) at 224x224: 7x7/2 conv, 3x3/2 max pool with
    padding 1, four stages of two basic blocks, a 1x1/2 shortcut at each
    widening stage, global pool, FC."""
    row, h = _conv(224, 3, 64, 7, 2, 3)
    rows, c = [row], 64
    h = (h + 2 - 3) // 2 + 1  # the padded max pool: 112 -> 56
    for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for b in range(2):
            s = stride if b == 0 else 1
            if s != 1 or c != cout:
                ho = (h - 1) // s + 1
                rows.append([ho * ho, c, cout, h * h * c, ho * ho * cout, 1])
            row, h2 = _conv(h, c, cout, 3, s, 1)
            rows.append(row)
            row, h2 = _conv(h2, cout, cout, 3, 1, 1)
            rows.append(row)
            h, c = h2, cout
    return rows + [[1, 512, 1000, 512, 1000, 1]]


def test_cnn4_tables_are_the_published_networks():
    from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload

    cfg = _config("cnn4")
    assert tuple(cfg["workloads"]) == PAPER_WORKLOADS
    assert cfg["workloads"]["resnet18"] == _resnet18()
    assert [r[0] for r in _resnet18()[1:5]] == [56 * 56] * 4
    for n in PAPER_WORKLOADS:
        assert cfg["layers_per_workload"][n] == len(cfg["workloads"][n])
        if n != "resnet18":
            assert cfg["workloads"][n] == [list(r) for r in cnn_workload(n)]
    # the port's ResNet18 differs only where its max pool drops the padding
    port = [list(r) for r in cnn_workload("resnet18")]
    differ = [i for i, (a, b) in enumerate(zip(port, cfg["workloads"]["resnet18"])) if a != b]
    assert len(port) == 21 and differ == [1, 2, 3, 4, 5, 6]


def _whisper_medium_decode():
    """arXiv:2212.04356 / openai/whisper-medium: d_model 1024, 24 decoder
    layers, fc1/fc2 of 4096 (GELU, no gate), vocab 51865.  A decoded token
    runs self-attention q, k, v, o, cross-attention q, o and fc1, fc2 of
    each block, then the head; the cross-attention k, v and the encoder run
    once an utterance."""
    d, f, v = 1024, 4096, 51865

    def gemm(k, n):
        return [1, k, n, k, n, 1]

    block = [gemm(d, d)] * 6 + [gemm(d, f), gemm(f, d)]
    return [list(r) for _ in range(24) for r in block] + [gemm(d, v)]


def test_lm3_tables_are_the_published_models():
    from repro_torch.configs.base import get_config
    from repro_torch.workloads.lm import lm_workload

    cfg = _config("lm3-decode")
    assert cfg["layers_per_workload"] == {"mamba2-780m": 97, "qwen2-vl-2b": 197,
                                          "whisper-medium": 193}
    assert cfg["workloads"]["whisper-medium"] == _whisper_medium_decode()
    for n in ("mamba2-780m", "qwen2-vl-2b"):
        assert cfg["workloads"][n] == [list(r) for r in lm_workload(get_config(n), mode="decode")]
    for n, t in cfg["workloads"].items():
        assert cfg["layers_per_workload"][n] == len(t)


@pytest.mark.parametrize("B, P, W, tot, want_ms", [
    (8, 40, 4, 1180, 0.000028), (4, 40, 1, 1180, 0.000012), (64, 40, 4, 1180, 0.000223)])
def test_b2_bound(B, P, W, tot, want_ms):
    from repro_torch.core.ga import block_layout

    assert block_layout(P, 9).tot == tot
    ms, by = yardstick.bound(*yardstick.b2_bound(B, P, W, tot, 5, 5, 4, 10))
    assert by == "bytes" and round(ms, 6) == want_ms


@pytest.mark.parametrize("B, W, layers, want_ms", [(8, 4, 8 * 109, 0.000023),
                                                   (4, 1, 109, 0.000004)])
def test_b1_bound(B, W, layers, want_ms):
    ms, by = yardstick.bound(*yardstick.b1_bound(B, 40, W, 64, layers))
    assert by == "bytes" and round(ms, 6) == want_ms

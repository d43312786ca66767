"""Each way an answer can be malformed counts once in ``bad_answers``, and
a search that never improved counts in ``stalled_share``."""
import copy
import numpy as np
import pytest
import torch

from bench.harness import check
from bench.harness.spec import Spec


@pytest.fixture(scope="module")
def sound():
    spec = Spec()
    cfg = spec.config("cnn4")
    traffic = {**spec.traffic("sweep-table"), "seeds_per_call": 2}
    d = spec.driver("sweep").Driver(cfg, traffic, 3, torch.device("cpu"))
    d.call(0)
    return cfg, [a for a in d.collected() if not a.rescore and len(a.result.top_scores) >= 2]


def _broken(a, how):
    a = copy.copy(a)
    r = a.result = copy.copy(a.result)
    if how == "twice":
        r.top_genomes = np.concatenate([r.top_genomes[:1], r.top_genomes[:-1]])
        r.top_scores = np.concatenate([r.top_scores[:1], r.top_scores[:-1]])
        r.top_designs = r.top_designs[:1] + r.top_designs[:-1]
    elif how == "order":
        r.top_scores = r.top_scores[::-1].copy()
        r.top_genomes = r.top_genomes[::-1].copy()
        r.top_designs = r.top_designs[::-1]
    elif how == "value":
        first = dict(r.top_designs[0], rows=r.top_designs[0]["rows"] * 2)
        r.top_designs = [first] + r.top_designs[1:]
    elif how == "partial":
        r.partial = True
    elif how == "names":
        a.names = a.names[::-1]
    elif how == "copied":  # another seed's answer, as a batch left half out gives
        a.seed = a.seed + 1
    return a


@pytest.mark.parametrize("how", ["twice", "order", "value", "partial", "names", "copied"])
def test_each_fault_of_form_counts_once(sound, how):
    cfg, answers = sound
    out = check.compare(answers + [_broken(answers[0], how)], cfg["workloads"], "cpu")
    assert out["bad_answers"] == 1 and out["unanswered"] == 0
    ok = check.compare(answers, cfg["workloads"], "cpu")
    assert ok["bad_answers"] == 0 and ok["score_gap"] < 1e-4


def test_unanswered_and_failed(sound):
    cfg, answers = sound
    lost = copy.copy(answers[0])
    lost.result = None
    failed = copy.copy(answers[1])
    failed.result = RuntimeError("launch failed")
    out = check.compare([lost, failed] + answers[2:], cfg["workloads"], "cpu")
    assert out["unanswered"] == 2 and out["bad_answers"] == 0



def test_stalled_share_counts_searches_that_never_improved(sound):
    cfg, answers = sound
    assert check.compare(answers, cfg["workloads"], "cpu")["stalled_share"] == 0.0
    flat = copy.copy(answers[0])
    r = flat.result = copy.copy(flat.result)
    r.convergence = np.full_like(np.asarray(r.convergence), r.top_scores[0])
    out = check.compare([flat] + answers[1:], cfg["workloads"], "cpu")
    assert out["stalled_share"] == pytest.approx(1 / len(answers)) and out["bad_answers"] == 0


@pytest.mark.parametrize("how", ["rises", "ends_elsewhere"])
def test_a_best_so_far_that_disagrees_is_bad(sound, how):
    cfg, answers = sound
    a = copy.copy(answers[0])
    r = a.result = copy.copy(a.result)
    conv = np.asarray(r.convergence, np.float32).copy()
    if how == "rises":
        conv[1] = conv[0] * 2
    else:
        conv[-1] = conv[-1] * np.float32(0.999)
    r.convergence = conv
    assert check.compare([a] + answers[1:], cfg["workloads"], "cpu")["bad_answers"] == 1


def test_two_call_seeds_that_share_a_stream_are_not_copies():
    """``separate_search`` seeds each workload's search with a 32-bit word
    of the call seed: 1654655367 and 1654653915 give qwen2-vl-2b the same
    word, so the same search, which is no copy; a joint answer handed to
    another seed is."""
    spec = Spec()
    cfg = spec.config("lm3-decode")
    traffic = {**spec.traffic("sweep-table"), "seeds_per_call": 1}
    kind = spec.driver("sweep")
    seeds = (1654655367, 1654653915)
    assert kind.stream_seeds(seeds[0], 3)[1] == kind.stream_seeds(seeds[1], 3)[1]
    d = kind.Driver(cfg, traffic, 5, torch.device("cpu"))
    d.calls = type("Fixed", (), {"__getitem__": lambda self, c: ([2 ** 30 + c], [seeds[c]])})()
    d.call(0)
    d.call(1)
    searches = [a for a in d.collected() if not a.rescore]
    qwen = [a for a in searches if a.names == ("qwen2-vl-2b",)]
    assert np.array_equal(qwen[0].result.top_genomes, qwen[1].result.top_genomes)
    assert check.compare(searches, cfg["workloads"], "cpu")["bad_answers"] == 0
    joint = [a for a in searches if len(a.names) == 3]
    copied = copy.copy(joint[1])
    copied.result = joint[0].result
    out = check.compare(searches + [copied], cfg["workloads"], "cpu")
    assert out["bad_answers"] == 1

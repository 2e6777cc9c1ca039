"""The general generator: every input from the seed, the same work for
every seed."""

from collections import Counter

import numpy as np
import pytest

from portbench import harness, traffic

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
SERVE = harness.resolve(MANIFEST, "gpt2s-serve-open")
LM = harness.resolve(MANIFEST, "gpt2s-train-downpour")
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_schedule_is_a_function_of_the_seed(seed):
    a = traffic.schedule(seed, SERVE.traffic, 50257, 10.0)
    b = traffic.schedule(seed, SERVE.traffic, 50257, 10.0)
    assert [(r.due_s, r.max_new, r.prompt.tolist()) for r in a] == [
        (r.due_s, r.max_new, r.prompt.tolist()) for r in b]


def test_every_seed_gets_the_same_work_in_another_order():
    a = traffic.schedule(1, SERVE.traffic, 50257, 20.0)
    b = traffic.schedule(2, SERVE.traffic, 50257, 20.0)
    assert Counter(len(r.prompt) for r in a) == Counter(len(r.prompt) for r in b)
    assert sum(r.max_new for r in a) == sum(r.max_new for r in b)
    assert [r.due_s for r in a] != [r.due_s for r in b]
    assert len(a) == len(b) == round(SERVE.traffic["arrivals"]["rate"] * 20)


def test_schedule_keeps_to_the_mix():
    tr = SERVE.traffic
    reqs = traffic.schedule(3, tr, 50257, 30.0)
    assert reqs[0].due_s == 0.0 and all(r.due_s < 30.0 for r in reqs)
    assert all(a.due_s <= b.due_s for a, b in zip(reqs, reqs[1:]))
    for r in reqs:
        assert tr["prompt"]["min"] <= len(r.prompt) <= tr["prompt"]["max"]
        assert tr["output"]["min"] <= r.max_new <= tr["output"]["max"]
        assert len(r.prompt) + r.max_new <= tr["max_total"]
        assert 0 <= r.prompt.min() and r.prompt.max() < 50257
    # prompts longer than answers, as in the conversation trace
    assert np.median([len(r.prompt) for r in reqs]) > np.median([r.max_new for r in reqs])


def test_training_rows_are_a_function_of_the_seed():
    tr, vocab = LM.traffic, LM.config["vocab_size"]
    x1, y1 = traffic.train_rows(BIG_SEED, tr, vocab, 12)
    x2, y2 = traffic.train_rows(BIG_SEED, tr, vocab, 12)
    x3, _ = traffic.train_rows(BIG_SEED + 1, tr, vocab, 12)
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2) and not np.array_equal(x1, x3)
    assert x1.shape == (12, tr["seq_len"]) and x1.dtype == np.int32
    assert len({row.tobytes() for row in x1}) == 12  # every row differs
    assert np.array_equal(x1[:, 1:], y1[:, :-1])  # labels are the next tokens


def test_sample_takes_the_longest():
    lengths = [5, 9, 300, 7, 8, 2]
    picks = traffic.sample_indices(4, lengths, 3)
    assert picks[0] == 2 and len(picks) == 3 and len(set(picks)) == 3
    assert picks == traffic.sample_indices(4, lengths, 3)


def test_percentile_is_nearest_rank():
    assert traffic.percentile(list(range(1, 101)), 95) == 95
    assert traffic.percentile([1.0, float("inf")], 95) == float("inf")

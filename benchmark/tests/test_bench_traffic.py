"""Each traffic generator gives the same work for the same seed and
another for another seed."""
import numpy as np
import pytest

from benchmark.runners import train
from benchmark.harness import Context
from benchmark.weights import make_weights

from .tiny import TINY, TINY_TRAIN, TRAFFIC_SYNTH, TRAFFIC_TRAIN


def test_synthesis_inputs_follow_the_seed():
    from benchmark.runners import synth

    def inputs(seed):
        return synth.make_inputs(Context({}, TINY, TRAFFIC_SYNTH, seed, 1.0, False, "cpu"), None)

    a, b, c = inputs(3), inputs(3), inputs(2**31 + 11)
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in ("phones", "waves"))
    assert not np.array_equal(a["phones"].numpy(), c["phones"].numpy())
    assert not np.array_equal(a["waves"].numpy(), c["waves"].numpy())


def test_training_batches_follow_the_seed_and_keep_their_sizes():
    a, b, c = (train.make_batches(s, TRAFFIC_TRAIN, TINY_TRAIN["plm"]) for s in (5, 5, 2**31 + 6))
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert any(not np.array_equal(x["p_codes"], y["p_codes"]) for x, y in zip(a, c))
    # the seed changes what is said and the order; the lengths stay
    sizes = lambda p: sorted(tuple(x["lens"].tolist()) for x in p)  # noqa: E731
    assert sizes(a) == sizes(c) and len({x["p_codes"].shape for x in a}) > 1
    for x in a:
        L = x["tc_latents"].shape[1]
        assert L % TRAFFIC_TRAIN["pad_multiple"] == 0 and x["p_codes"].shape[1] == L + 1
        assert max(x["lens"]) <= min(L, TRAFFIC_TRAIN["max_tokens"]) < max(x["lens"]) + 4


def test_row_lengths_by_hand():
    """Two cuts of exactly 1.0 s: 1 + 62 frames, ceil(63 / 8) = 8 codes each."""
    tr = dict(TRAFFIC_TRAIN, batch=2, cuts_per_row=2, cut_seconds=[1.0, 1.0], pool_batches=1,
              max_tokens=4096)
    assert train.row_lengths(tr).tolist() == [[16, 16]]
    assert train.row_lengths(dict(tr, max_tokens=10)).tolist() == [[10, 10]]


def test_weights_follow_the_seed():
    layout = [("x.weight", (4, 3)), ("x.bias", (4,)), ("norm.weight", (3,))]
    a, b, c = (make_weights(layout, s, "cpu") for s in (1, 1, 2))
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    assert not np.array_equal(a["x.weight"].numpy(), c["x.weight"].numpy())
    assert np.array_equal(a["norm.weight"].numpy(), np.ones(3, np.float32))


@pytest.mark.parametrize("seed", [0, 2**31 + 77, 2**40 + 1])
def test_large_seeds_are_taken(seed):
    assert len(train.make_batches(seed, TRAFFIC_TRAIN, TINY_TRAIN["plm"])) == \
        TRAFFIC_TRAIN["pool_batches"]

"""The port's ``rollout/policy.py:categorical_invcdf`` in distribution, in
the pattern of tests/test_sampling.py: frequencies within 4 binomial
sigmas of the softmax, masked logits never drawn, rows independent, a
fully masked row uniform; and its draws come from the generator alone."""

import numpy as np
import torch

from ctrl_sim_tpu_torch.rollout.policy import categorical_invcdf

torch.set_num_threads(2)


def test_matches_softmax_distribution():
    logits = torch.tensor([2.0, 0.0, -1.0, 3.0, 0.5, -30.0, 1.0, 0.0])
    probs = torch.softmax(logits, -1).numpy()
    n = 200_000
    draws = categorical_invcdf(torch.Generator().manual_seed(0), logits.expand(n, 8))
    freq = np.bincount(draws.numpy(), minlength=8) / n
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) < 4 * sigma + 1e-4), (freq, probs)


def test_masked_logits_never_sampled():
    neg = torch.finfo(torch.float32).min
    logits = torch.tensor([neg, 1.0, neg, 2.0, neg]).expand(20_000, 5)
    draws = categorical_invcdf(torch.Generator().manual_seed(1), logits)
    assert set(np.unique(draws.numpy())) <= {1, 3}


def test_batch_axes_independent_and_generator_driven():
    logits = torch.tensor([[100.0, 0.0, 0.0], [0.0, 100.0, 0.0], [0.0, 0.0, 100.0]])
    draws = categorical_invcdf(torch.Generator().manual_seed(2), logits[None].expand(4, 3, 3))
    np.testing.assert_array_equal(draws.numpy(), [[0, 1, 2]] * 4)
    flat = torch.zeros(64, 10)
    a = categorical_invcdf(torch.Generator().manual_seed(3), flat)
    b = categorical_invcdf(torch.Generator().manual_seed(3), flat)
    torch.testing.assert_close(a, b)


def test_all_masked_row_samples_uniform():
    neg = torch.finfo(torch.float32).min
    draws = categorical_invcdf(torch.Generator().manual_seed(4), torch.full((40_000, 4), neg))
    freq = np.bincount(draws.numpy(), minlength=4) / 40_000
    assert np.all(np.abs(freq - 0.25) < 4 * np.sqrt(0.25 * 0.75 / 40_000))

"""Port parity: serve/abuse.py, the bonus-abuse detector.

The same seeded event stream goes into the JAX package's
``SequenceAbuseDetector`` and the port's (``device="cpu"``), with the same
params (JAX's tree, converted). Histories must be bit-equal; model scores
agree to atol 1e-5 (tests/test_torch_sequence.py) with equal signals away
from the thresholds; the heuristic policy is numpy in both and must be
exactly equal; linked accounts are equal.
"""

import numpy as np
import pytest
import torch
from test_torch_sequence import SERVE_CFG, seq_tree

from igaming_platform_tpu.models.sequence import SeqConfig as JSeqConfig
from igaming_platform_tpu.serve.abuse import SequenceAbuseDetector as JDetector
from igaming_platform_tpu_torch.models.sequence import SeqConfig, init_sequence_model
from igaming_platform_tpu_torch.serve.abuse import AbuseShed, SequenceAbuseDetector

TYPES = ("deposit", "bet", "win", "bonus_grant", "bonus_wager", "withdraw")


def _feed(detectors, seed=0, n_accounts=12, max_events=90):
    """Per account a run of events (some longer than the 64-event window),
    bonus-heavy for some, with devices shared across accounts."""
    rng = np.random.default_rng(seed)
    for a in range(n_accounts):
        t = 1_700_000_000.0 + a
        p = [0.1, 0.2, 0.1, 0.2, 0.35, 0.05] if a % 3 == 0 else [0.3, 0.4, 0.15, 0.02, 0.03, 0.1]
        for _ in range(rng.integers(1, max_events)):
            t += float(rng.choice([5.0, 40.0, 900.0]) * rng.random())
            ev = dict(amount=int(rng.integers(0, 200_000)), tx_type=str(rng.choice(TYPES, p=p)),
                      game_weight=float(rng.choice([1.0, 0.1])),
                      device_id=f"dev{rng.integers(20)}" if rng.random() < 0.3 else "",
                      timestamp=t)
            for det in detectors:
                det.record_event(f"a{a}", **ev)
    return [f"a{a}" for a in range(n_accounts)] + ["never-seen"]


@pytest.fixture(scope="module")
def pair():
    tree, model = seq_tree(SERVE_CFG, seed=3)
    jdet = JDetector(params=tree, cfg=JSeqConfig(**SERVE_CFG))
    tdet = SequenceAbuseDetector(params=model, device="cpu")
    accounts = _feed([jdet, tdet])
    return jdet, tdet, accounts


def test_histories_scores_signals_and_links(pair):
    jdet, tdet, accounts = pair
    for seq_len in (64, 100):
        np.testing.assert_array_equal(tdet._history_matrix(accounts, seq_len),
                                      jdet._history_matrix(accounts, seq_len))
    steps = tdet.device_steps
    got = tdet.check_batch(accounts)
    assert tdet.device_steps == steps + 1 and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jdet.check_batch(accounts)), rtol=0, atol=1e-5)
    for acct in accounts:
        score, signals, linked = tdet.check(acct)
        jscore, jsignals, jlinked = jdet.check(acct)
        assert abs(score - jscore) <= 1e-5 and linked == jlinked
        if min(abs(jscore - 0.5), abs(jscore - 0.8)) > 1e-5:
            assert signals == jsignals, acct
        assert tdet.is_abuser(acct) == (score >= 0.5)
    assert any(tdet.linked_accounts(a) for a in accounts)
    assert tdet.check_batch([]).shape == (0,)


def test_heuristic_policy_is_exact(pair):
    jdet, tdet, accounts = pair
    tdet.policy = jdet.policy = "heuristic"
    try:
        np.testing.assert_array_equal(tdet.check_batch(accounts), jdet.check_batch(accounts))
        for acct in accounts:
            assert tdet.check(acct) == jdet.check(acct)
    finally:
        tdet.policy = jdet.policy = "model"


def test_policies_swap_and_device():
    det = SequenceAbuseDetector(policy="shed", device="cpu")
    det.record_event("a", 100, "bet", timestamp=5.0)
    with pytest.raises(AbuseShed):
        det.check("a")
    with pytest.raises(ValueError, match="unknown abuse policy"):
        SequenceAbuseDetector(policy="fast", device="cpu")
    det.policy = "model"
    before = det.check_batch(["a"])
    det.swap_params(init_sequence_model(det.cfg, seed=1))
    assert not np.array_equal(before, det.check_batch(["a"]))
    with pytest.raises(ValueError, match="params are for"):
        det.swap_params(init_sequence_model(SeqConfig(d_model=32, n_heads=2), seed=1))


def test_detector_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SequenceAbuseDetector()

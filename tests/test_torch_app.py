"""Port parity of the slice as a whole: platform/app.py's ``PlatformApp``,
with serve/ipintel.py and platform/risk_adapter.py, against the JAX package's.

The port's ``PlatformApp(device="cpu")`` and the JAX ``PlatformApp`` run at
``AppConfig(batch_size=32)`` for the ``mock`` and ``mlp+gbdt`` backends,
from the same params and the same abuse detector (the JAX app's own,
carried across by ``convert.sequence_from_tree``), on one seeded stream:
the scenarios of tests/test_app_integration.py, velocity bursts, a
blacklisted device, bonus claims and wagers, and an ipintel-flagged
request. One clock is pinned for both apps (feature windows, bonus
schedules, the wallet's money events). Every operation's outcome, every
risk gate's score, action, reasons and feature row, the abuse histories,
the bonus wagering progress and the books must be equal; score and action
are excused only on rows within 1e-4 of a floor boundary whose ml_score
differs, and those rows are counted.
"""

import threading
import types

import numpy as np
import pytest
from test_torch_gbdt import _forest
from test_torch_models import mlp_tree
from torch_front_common import no_jax_hostprof  # noqa: F401 - a fixture

import igaming_platform_tpu.platform.wallet as jwallet_mod
import igaming_platform_tpu.serve.feature_store as jfs
from igaming_platform_tpu.core.features import NUM_FEATURES
from igaming_platform_tpu.platform.app import AppConfig as JAppConfig
from igaming_platform_tpu.platform.app import PlatformApp as JPlatformApp
from igaming_platform_tpu.serve.ipintel import CIDRIPIntelligence as JIntel
from igaming_platform_tpu.serve.ipintel import IPRanges as JRanges
from igaming_platform_tpu.serve.scorer import ScoreRequest as JScoreRequest
from igaming_platform_tpu_torch.convert import sequence_from_tree
from igaming_platform_tpu_torch.models.sequence import SeqConfig
from igaming_platform_tpu_torch.platform.app import AppConfig, PlatformApp
from igaming_platform_tpu_torch.platform.reconcile import Reconciler
from igaming_platform_tpu_torch.platform.risk_adapter import GrpcRiskGate
from igaming_platform_tpu_torch.serve.ipintel import CIDRIPIntelligence, IPRanges
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

T0 = 1_772_668_800.0  # 2026-03-05 00:00 UTC, a Thursday
RANGES = dict(vpn=["10.8.0.0/16"], proxy=["45.12.0.0/16"], tor=["171.25.193.0/24"],
              country_ranges={"DE": ["88.0.0.0/8"]})


class Recorder:
    """An engine in front of the app's own: records each gate's response."""

    def __init__(self, engine, log: list):
        self._engine, self._log = engine, log

    def score(self, req, *args, **kwargs):
        resp = self._engine.score(req, *args, **kwargs)
        self._log.append({
            "score": resp.score, "action": str(getattr(resp.action, "value", resp.action)),
            "rule_score": resp.rule_score, "ml_score": np.float32(resp.ml_score),
            "reasons": [getattr(r, "value", r) for r in resp.reason_codes],
            "features": resp.features.to_array().view(np.int32)})
        return resp

    def __getattr__(self, name):
        return getattr(self._engine, name)


@pytest.fixture
def jax_thread_roles():
    """The JAX host profiler's registry keeps the roles of finished threads,
    and a new thread given a finished one's ident inherits its role: drop
    the registrations this test's JAX engine threads leave behind."""
    from igaming_platform_tpu.obs import hostprof as jhp

    before = set(jhp.registered_threads())
    yield
    alive = {t.ident for t in threading.enumerate()}
    for ident in set(jhp.registered_threads()) - before - alive:
        jhp.unregister_scoring_thread(ident)


def _apps(monkeypatch, backend: str):
    clock = [T0]
    now = lambda: clock[0]  # noqa: E731
    monkeypatch.setattr(jfs, "time", types.SimpleNamespace(time=now))
    stamp = jwallet_mod.new_transaction_event

    def stamped(*args, **kwargs):
        event = stamp(*args, **kwargs)
        event.timestamp = now()
        return event

    monkeypatch.setattr(jwallet_mod, "new_transaction_event", stamped)
    tree = None if backend == "mock" else {"mlp": mlp_tree(21, hidden=(32, 16)),
                                           "gbdt": _forest(22, n_trees=16, depth=3)}
    japp = JPlatformApp(JAppConfig(batch_size=32), ml_backend=backend, params=tree)
    japp.bonus.now_fn = now
    import jax

    detector = sequence_from_tree(jax.tree.map(np.asarray, japp.abuse.params),
                                  SeqConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128))
    papp = PlatformApp(AppConfig(batch_size=32), ml_backend=backend, params=tree,
                       abuse_params=detector, device="cpu", clock=now)
    logs = ([], [])
    for app, log in zip((japp, papp), logs):
        app.risk_gate.engine = Recorder(app.engine, log)
    return japp, papp, clock, logs


def _result(fn):
    try:
        res = fn()
    except Exception as exc:  # noqa: BLE001 - the exception is the outcome
        return type(exc).__name__
    if hasattr(res, "transaction"):
        tx = res.transaction
        return ("ok", res.new_balance, res.risk_score, res.real_deducted, res.bonus_deducted,
                tx.type.value, tx.amount, tx.status.value)
    if hasattr(res, "bonus_amount"):
        return ("bonus", res.rule_id, res.bonus_amount, res.wagering_required)
    return ("ok", res)


def _scenarios(app, ids):
    """tests/test_app_integration.py's flows, one op at a time."""
    a = {p: ids(p) for p in ("e2e-1", "e2e-2", "e2e-3", "e2e-4", "e2e-5", "e2e-6")}
    yield lambda: app.deposit(a["e2e-1"], 20_000, "d1")
    yield lambda: app.bet(a["e2e-1"], 5_000, "b1", game_id="g1")
    yield lambda: app.win(a["e2e-1"], 2_000, "w1")
    yield lambda: app.deposit(a["e2e-2"], 10_000, "d1")
    yield lambda: app.claim_bonus(a["e2e-2"], "welcome_bonus_100", deposit_amount=10_000)
    yield lambda: app.bet(a["e2e-2"], 400, "b1", game_id="g1", game_category="slots")
    yield lambda: app.deposit(a["e2e-3"], 50_000, "d1")
    yield lambda: app.claim_bonus(a["e2e-3"], "welcome_bonus_100", deposit_amount=10_000)
    yield lambda: app.bet(a["e2e-3"], 2_000, "big-bet")  # over the max bet
    for i in range(12):  # a velocity burst
        yield lambda i=i: app.deposit(a["e2e-4"], 100_000, f"d{i}")
    yield lambda: app.engine.features.add_to_blacklist("device", "bad-dev")
    yield lambda: app.withdraw(a["e2e-4"], 50_000, "wd1", device_id="bad-dev")
    yield lambda: app.deposit(a["e2e-5"], 5_000, "d1")
    yield lambda: app.bonus.award_bonus(a["e2e-5"], "friday_reload", deposit_amount=5_000)
    yield lambda: app.deposit(a["e2e-6"], 10_000, "d1")
    yield lambda: app.bet(a["e2e-6"], 3_000, "b1")
    yield lambda: app.win(a["e2e-6"], 4_500, "w1")
    yield lambda: app.withdraw(a["e2e-6"], 2_000, "wd1")


def _random_ops(app, ids, seed: int = 8, n: int = 200):
    rng = np.random.default_rng(seed)
    rules = ("welcome_bonus_100", "second_deposit_boost", "verified_account_credit",
             "friday_reload", "boost_code_reload")
    for i in range(n):
        a = ids(f"r{rng.integers(14)}")
        amount = int(rng.integers(100, 150_000))
        op = rng.choice(["deposit", "bet", "win", "withdraw", "claim", "burst"],
                        p=[0.3, 0.3, 0.1, 0.12, 0.1, 0.08])
        device = f"dev{rng.integers(6)}"
        if op == "claim":
            rule = rules[rng.integers(len(rules))]
            yield lambda a=a, rule=rule, amount=amount: app.claim_bonus(a, rule, amount)
        elif op == "burst":
            for j in range(6):
                yield lambda a=a, key=f"x{i}-{j}", amount=amount: app.deposit(
                    a, amount, key, device_id="dev0")
        elif op in ("deposit", "withdraw"):
            yield lambda a=a, op=op, amount=amount, device=device, key=f"k{i}": getattr(
                app, op)(a, amount, key, device_id=device)
        elif op == "bet":
            cat = str(rng.choice(["slots", "video_poker", "table_games", ""]))
            yield lambda a=a, amount=amount, cat=cat, key=f"k{i}": app.bet(
                a, amount // 10, key, game_category=cat)
        else:
            yield lambda a=a, amount=amount, key=f"k{i}": app.win(a, amount, key)


def _checked(got: dict, want: dict) -> bool:
    """Whether a gate's score and action are held exactly: all but rows
    within 1e-4 of a floor boundary whose ml_score differs."""
    pre = 0.4 * want["rule_score"] + 60.0 * float(want["ml_score"]) + 1e-4
    return abs(pre - round(pre)) > 1e-4 or got["ml_score"].view(np.int32) == \
        want["ml_score"].view(np.int32)


@pytest.mark.usefixtures("no_jax_hostprof", "jax_thread_roles")
@pytest.mark.parametrize("backend", ["mock", "mlp+gbdt"])
def test_platform_app_matches_jax(monkeypatch, backend):
    japp, papp, clock, (jlog, plog) = _apps(monkeypatch, backend)
    try:
        streams = []
        for app in (japp, papp):
            app.engine.features.add_to_blacklist("device", "dev5")
            acct = {}

            def ids(player, app=app, acct=acct):
                if player not in acct:
                    acct[player] = app.wallet.create_account(player).id
                return acct[player]

            scenarios = list(_scenarios(app, ids))
            streams.append((acct, [*scenarios, *_random_ops(app, ids)]))
        outcomes = []
        rng = np.random.default_rng(9)
        for i, (jop, pop) in enumerate(zip(streams[0][1], streams[1][1])):
            outcomes.append((_result(jop), _result(pop)))
            # The scenarios run at a human-script pace (their velocity burst
            # must read as one), the seeded ops at a mix of paces.
            clock[0] += 1.0 if i < len(scenarios) else float(rng.choice([0.5, 3.0, 40.0, 700.0]))
        # The ipintel-flagged request, scored by each engine directly.
        ip = "171.25.193.5"
        flagged = [app.risk_gate.engine.score(cls("tor-user", amount=1000, tx_type="deposit",
                                                  ip=ip, ip_flags=intel.flags(ip)))
                   for app, cls, intel in ((japp, JScoreRequest, JIntel(JRanges(**RANGES))),
                                           (papp, ScoreRequest, CIDRIPIntelligence(
                                               IPRanges(**RANGES))))]
        assert flagged[1].rule_score >= 15 and "VPN_DETECTED" in plog[-1]["reasons"]

        assert [o[0] for o in outcomes] == [o[1] for o in outcomes]
        kinds = {o[0] if isinstance(o[0], str) else o[0][0] for o in outcomes}
        assert {"ok", "bonus", "RiskReviewError", "BonusRestrictionError", "NotEligibleError",
                "InsufficientBalanceError"} <= kinds, kinds
        assert len(jlog) == len(plog) > 100
        excused = 0
        for want, got in zip(jlog, plog):
            for key in ("rule_score", "reasons"):
                assert got[key] == want[key], key
            np.testing.assert_array_equal(got["features"], want["features"])
            assert abs(float(got["ml_score"]) - float(want["ml_score"])) <= 1e-6
            if _checked(got, want):
                assert (got["score"], got["action"]) == (want["score"], want["action"])
            else:
                excused += 1
        assert excused <= 2, excused
        assert {g["action"] for g in plog} >= {"approve", "review"}

        jacct, pacct = streams[0][0], streams[1][0]
        assert jacct.keys() == pacct.keys()
        players = sorted(pacct)
        jrows, prows = (np.zeros((len(players), NUM_FEATURES), np.float32) for _ in range(2))
        for i, p in enumerate(players):
            japp.engine.features.fill_row(jrows[i], jacct[p], 5000, "bet", now=clock[0])
            papp.engine.features.fill_row(prows[i], pacct[p], 5000, "bet", now=clock[0])
            assert japp.abuse.history_length(jacct[p]) == papp.abuse.history_length(pacct[p])
            jb, pb = (sorted((b.rule_id, b.status.value, b.bonus_amount, b.wagering_progress)
                             for b in app.bonus.repo.get_active_by_account(acct[p]))
                      for app, acct in ((japp, jacct), (papp, pacct)))
            assert jb == pb
            jbal, pbal = japp.wallet.get_balance(jacct[p]), papp.wallet.get_balance(pacct[p])
            assert (jbal.balance, jbal.bonus, jbal.version) == (pbal.balance, pbal.bonus,
                                                                pbal.version)
        np.testing.assert_array_equal(prows.view(np.int32), jrows.view(np.int32))
        assert papp.gate_errors() == {"wallet_open": 0, "wallet_closed": 0, "bonus_abuse": 0}
        report = Reconciler(papp.wallet.accounts, papp.wallet.ledger).run_once()
        assert report.checked == len(players) and report.mismatched == 0
        assert papp.bridge.events_processed == japp.bridge.events_processed > 100
    finally:
        japp.close()
        papp.close()


def test_app_defaults_and_grpc_gate():
    """The rules resolve beside the module from any working directory;
    without a card the default device raises; the gRPC gate encodes the
    port's risk.v1 request and decodes its answer."""
    import os

    from igaming_platform_tpu_torch.platform import app as app_mod
    from igaming_platform_tpu_torch.serve import risk_codec

    assert os.path.isabs(app_mod.DEFAULT_RULES) and os.path.exists(app_mod.DEFAULT_RULES)
    with pytest.raises(RuntimeError):
        PlatformApp()

    sent = []

    class Stub:
        def ScoreTransaction(self, payload, timeout):
            sent.append(risk_codec.decode(risk_codec.SCORE_TRANSACTION_REQUEST, payload))
            return risk_codec.encode(risk_codec.SCORE_TRANSACTION_RESPONSE, {
                "score": 71, "action": 2, "reason_codes": ["VELOCITY_HIGH", "NEW_ACCOUNT"]})

    gate = GrpcRiskGate("127.0.0.1:1")
    gate._stub = Stub()
    assert gate.score_transaction("a1", 5000, "withdraw", ip="1.2.3.4", device_id="d") == (
        71, "review", ["VELOCITY_HIGH", "NEW_ACCOUNT"])
    assert (sent[0]["account_id"], sent[0]["amount"], sent[0]["transaction_type"],
            sent[0]["ip_address"], sent[0]["device_id"]) == ("a1", 5000, "withdraw", "1.2.3.4", "d")


@pytest.mark.parametrize("ip", ["10.8.3.4", "171.25.193.77", "45.12.9.9", "88.1.2.3",
                                "not-an-ip", "", "2001:db8::1"])
def test_ipintel_matches_jax(ip):
    port, jax = CIDRIPIntelligence(IPRanges(**RANGES)), JIntel(JRanges(**RANGES))
    assert vars(port.analyze(ip)) == vars(jax.analyze(ip))
    assert port.flags(ip) == jax.flags(ip)

"""Port parity: core/money.py and the pure platform modules (domain,
migrations, repository, outbox, wallet, bonus, cashback, reconcile, seed)
against the JAX package's.

Money cases run through both modules; the migrations run over SQLite (the
JAX package's Postgres-protocol rig) and leave the same ``sqlite_master``;
one seeded sequence of wallet operations goes through the JAX
``WalletService`` and the port's, over in-memory and SQLite stores, with a
stub risk gate giving both the same answers, and every outcome, balance,
ledger entry, outbox event, cashback award, reconcile report and seeded
fixture must agree (compared by idempotency key and player, never by
generated ID); the bonus engines load the same rules (the port's YAML reader
against ``yaml.safe_load``) and answer one seeded sequence of claims and
wagers alike under one pinned clock.
"""

import dataclasses
import enum
import json
import re
import sqlite3
import time

import numpy as np
import pytest
import yaml

from igaming_platform_tpu.core import money as jmoney
from igaming_platform_tpu.platform import bonus as jbonus
from igaming_platform_tpu.platform import cashback as jcashback
from igaming_platform_tpu.platform import migrations as jmigrations
from igaming_platform_tpu.platform import outbox as joutbox
from igaming_platform_tpu.platform import reconcile as jreconcile
from igaming_platform_tpu.platform import repository as jrepo
from igaming_platform_tpu.platform import seed as jseed
from igaming_platform_tpu.platform import wallet as jwallet
from igaming_platform_tpu.platform.app import DEFAULT_RULES as JAX_RULES
from igaming_platform_tpu.serve import events as jevents
from igaming_platform_tpu_torch.core import money
from igaming_platform_tpu_torch.core.enums import QUEUE_RISK_SCORING
from igaming_platform_tpu_torch.platform import (
    bonus,
    cashback,
    migrations,
    outbox,
    pg_testing,
    reconcile,
    repository,
    seed,
    wallet,
)
from igaming_platform_tpu_torch.platform.app import DEFAULT_RULES
from igaming_platform_tpu_torch.serve import events

PORT = dict(money=money, bonus=bonus, cashback=cashback, outbox=outbox,
            reconcile=reconcile, repo=repository, seed=seed, wallet=wallet, events=events)
JAX = dict(money=jmoney, bonus=jbonus, cashback=jcashback, outbox=joutbox,
           reconcile=jreconcile, repo=jrepo, seed=jseed, wallet=jwallet, events=jevents)
TUESDAY = 1_700_000_000.0  # 2023-11-14 22:13:20 UTC
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def _plain(value):
    """A value with the packages' enums and dataclasses as plain data."""
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _outcome(fn):
    try:
        return ("ok", _plain(fn()))
    except Exception as exc:  # noqa: BLE001 - the exception is the outcome
        return (type(exc).__name__, _UUID.sub("<id>", str(exc)))


# -- money ---------------------------------------------------------------------

MONEY_CASES = [
    ("from_cents", (12_345,), {}), ("from_cents", (-1,), {}), ("from_cents", (2**63,), {}),
    ("parse", ("12.34",), {}), ("parse", ("0.5",), {}), ("parse", ("1.234",), {}),
    ("parse", ("abc",), {}), ("parse", ("-3",), {}), ("parse", ("0.00000001", "BTC"), {}),
    ("parse", ("1.000000001", "ETH"), {}), ("parse", ("1.0000000001", "ETH"), {}),
    ("add", (100, 250), {}), ("sub", (100, 250), {}), ("sub", (300, 250), {}),
    ("add_mixed", (100, 250), {}), ("percent", (999, 33), {}), ("floordiv", (1001, 7), {}),
    ("mul_int", (2**62, 2), {}), ("min_max", (5, 9), {}), ("json", (123_456, "EUR"), {}),
    ("str", (105, "USD"), {}), ("str", (123_456_789, "BTC"), {}), ("zero", ("GBP",), {}),
]


def _money_case(mod, op, args):
    m = mod.Money

    def cur(name="USD"):
        return mod.Currency(name)

    if op == "from_cents":
        return _outcome(lambda: m.from_cents(*args))
    if op == "parse":
        return _outcome(lambda: m.parse(args[0], cur(*args[1:])))
    if op in ("add", "sub"):
        return _outcome(lambda: getattr(m.from_cents(args[0]), op)(m.from_cents(args[1])))
    if op == "add_mixed":
        return _outcome(lambda: m.from_cents(args[0]) + m.from_cents(args[1], cur("EUR")))
    if op in ("percent", "floordiv", "mul_int"):
        return _outcome(lambda: getattr(m.from_cents(args[0]), op)(args[1]))
    if op == "min_max":
        a, b = m.from_cents(args[0]), m.from_cents(args[1])
        return _outcome(lambda: (mod.money_min(a, b), mod.money_max(b, a), a < b, a >= b))
    if op == "json":
        return _outcome(lambda: m.from_json(m.from_cents(args[0], cur(args[1])).to_json()))
    if op == "str":
        return _outcome(lambda: str(m.from_cents(args[0], cur(args[1]))))
    return _outcome(lambda: (m.zero(cur(args[0])), m.zero(cur(args[0])).is_zero()))


@pytest.mark.parametrize("op,args,_", MONEY_CASES, ids=[f"{c[0]}-{i}" for i, c in
                                                         enumerate(MONEY_CASES)])
def test_money_matches_jax(op, args, _):
    assert _money_case(money, op, args) == _money_case(jmoney, op, args)


# -- migrations ----------------------------------------------------------------


def test_migrations_on_sqlite_match_jax(tmp_path):
    """Both runners, each over the JAX wire client and its SQLite-backed
    Postgres-protocol rig: up, status, down to 2, up again; the schema and
    the migration ledger's versions end the same."""
    from igaming_platform_tpu.platform.pg_testing import PgSqliteServer
    from igaming_platform_tpu.platform.pgwire import PgConnection

    dumps, statuses = [], []
    for mod, name in ((migrations, "port.db"), (jmigrations, "jax.db")):
        path = str(tmp_path / name)
        server = PgSqliteServer(path)
        conn = PgConnection(server.url)
        conn.connect()
        try:
            runner = mod.MigrationRunner(conn)
            ran = [runner.up(), runner.status(), runner.down(2), runner.up(4), runner.up()]
        finally:
            conn.close()
            server.close()
        statuses.append(ran)
        db = sqlite3.connect(path)
        dumps.append((db.execute("SELECT type, name, tbl_name, sql FROM sqlite_master "
                                 "ORDER BY type, name").fetchall(),
                      db.execute("SELECT version, name FROM schema_migrations "
                                 "ORDER BY version").fetchall()))
        db.close()
    assert statuses[0] == statuses[1] and statuses[0][0] == [1, 2, 3, 4, 5]
    assert dumps[0] == dumps[1] and len(dumps[0][0]) >= 8
    server = pg_testing.PgSqliteServer(str(tmp_path / "cli.db"))
    try:
        assert migrations.main([server.url, "up"]) == 0
        assert migrations.main([server.url, "status"]) == 0
    finally:
        server.close()


# -- wallet, outbox, cashback, reconcile, seed ----------------------------------


class StubRiskGate:
    """The same answers for both packages: a score from the request's
    fields, and an outage on one amount in 11 (counted by type)."""

    def __init__(self):
        self.raised = {"deposit": 0, "bet": 0, "withdraw": 0}

    def score_transaction(self, account_id, amount, tx_type, game_id="", ip="",
                          device_id="", fingerprint=""):
        if amount % 11 == 0:
            self.raised[tx_type] += 1
            raise RuntimeError("risk service down")
        score = (amount // 100 + len(tx_type) * 7 + len(device_id) * 3) % 101
        return score, "approve", ["VELOCITY_HIGH"] if score > 60 else []


def _wallet_pair(mods, kind: str, path: str):
    repo = mods["repo"]
    if kind == "sqlite":
        store = repo.SQLiteStore(path)
        parts, outbox_store, audit = (store.accounts, store.transactions, store.ledger), store, \
            store.audit
    else:
        store, audit = None, None
        parts = (repo.InMemoryAccountRepository(), repo.InMemoryTransactionRepository(),
                 repo.InMemoryLedgerRepository())
        outbox_store = mods["outbox"].InMemoryOutbox()
    svc = mods["wallet"].WalletService(*parts, events=mods["outbox"].OutboxPublisher(outbox_store),
                                       risk=StubRiskGate(), audit=audit)
    bonus_repo = mods["bonus"].SQLiteBonusRepository(store) if store is not None else None
    engine = mods["bonus"].BonusEngine(JAX_RULES if mods is JAX else DEFAULT_RULES,
                                       repo=bonus_repo, now_fn=lambda: TUESDAY)
    return svc, engine, store, outbox_store


def _drive_wallet(mods, kind: str, path: str, seed_: int) -> dict:
    svc, engine, store, outbox_store = _wallet_pair(mods, kind, path)
    rng = np.random.default_rng(seed_)
    players = [f"p{i}" for i in range(12)]
    ids = {p: svc.create_account(p).id for p in players}
    pid = {v: k for k, v in ids.items()}
    keys: dict[str, list[str]] = {p: [] for p in players}
    outcomes = []
    for i in range(360):
        p = players[rng.integers(len(players))]
        a, amount = ids[p], int(rng.integers(1, 40_000))
        kind_op = rng.choice(["deposit", "bet", "win", "withdraw", "refund", "grant_bonus",
                              "replay", "suspend", "forfeit"],
                             p=[0.26, 0.26, 0.12, 0.1, 0.05, 0.07, 0.08, 0.03, 0.03])
        key = f"k{i}"
        if kind_op == "replay" and keys[p]:
            key = keys[p][rng.integers(len(keys[p]))]  # a deposit under a used key
        keys[p].append(key)
        if kind_op == "refund":
            old = keys[p][rng.integers(len(keys[p]))]
            tx = svc.transactions.get_by_idempotency_key(a, old)
            fn = lambda: svc.refund(a, tx.id if tx else "none", key, reason="r")  # noqa: E731
        elif kind_op == "suspend":
            status = mods["wallet"].AccountStatus(
                "suspended" if rng.random() < 0.5 else "active")
            fn = lambda: svc.set_account_status(a, status, reason="ops").status  # noqa: E731
        elif kind_op == "forfeit":
            fn = lambda: svc.forfeit_bonus_balance(a, reason="early withdrawal")  # noqa: E731
        elif kind_op == "bet":
            fn = lambda: svc.bet(a, amount, key, game_id="g1", game_category="slots",  # noqa: E731
                                 device_id=f"d{amount % 5}")
        elif kind_op == "win":
            fn = lambda: svc.win(a, amount, key, game_id="g1")  # noqa: E731
        elif kind_op == "grant_bonus":
            fn = lambda: svc.grant_bonus(a, amount, key, rule_id="welcome_bonus_100")  # noqa: E731
        else:
            op = "deposit" if kind_op == "replay" else kind_op
            fn = lambda: getattr(svc, op)(a, amount, key, device_id="dev")  # noqa: E731
        result = _outcome(fn)
        if result[0] == "ok" and isinstance(result[1], dict) and "transaction" in result[1]:
            tx = result[1].pop("transaction")
            result[1]["tx"] = {k: tx[k] for k in ("type", "amount", "status", "balance_before",
                                                  "balance_after", "risk_score")}
        outcomes.append((p, str(kind_op), result))

    def books(p):
        acct = svc.get_balance(ids[p])
        txs = svc.get_transaction_history(ids[p], limit=10_000)
        by_id = {t.id: t.idempotency_key for t in txs}

        def norm_key(k):  # forfeit:<uuid>, cashback:<bonus id>
            return k.split(":")[0] if k and k.startswith(("forfeit:", "cashback:")) else k

        rows = sorted(
            (norm_key(t.idempotency_key), t.type.value, t.amount, t.status.value,
             t.balance_before, t.balance_after, t.risk_score,
             t.reference.replace(t.reference.split(":")[1], by_id[t.reference.split(":")[1]])
             if t.reference.startswith("refund:") else t.reference,
             sorted((e.entry_type.value, e.amount, e.balance_after, e.description)
                    for e in svc.ledger.get_by_transaction(t.id)))
            for t in txs)
        return (acct.balance, acct.bonus, acct.version, acct.status.value, rows)

    staged = list(outbox_store.outbox_drain())
    broker = mods["events"].default_broker()
    relayed = mods["outbox"].OutboxRelay(outbox_store, broker).flush()
    delivered = []
    while (raw := broker.get(QUEUE_RISK_SCORING, timeout=0)) is not None:
        delivered.append(raw)

    def norm_event(payload):
        ev = json.loads(payload)
        data = dict(ev["data"])
        for k in ("id", "transaction_id", "account_id"):
            if k in data:
                data[k] = pid.get(data[k], "tx")
        return ev["type"], ev["source"], data

    active = [ids[p] for p in players if svc.get_balance(ids[p]).status.value == "active"]
    cash = mods["cashback"].run_cashback_job(svc, engine, active,
                                             rule_id="tuesday_cashback",
                                             now=time.time() + 60.0)
    report = mods["reconcile"].Reconciler(svc.accounts, svc.ledger).run_once(keep_snapshots=True)
    out = {
        "outcomes": outcomes,
        "books": {p: books(p) for p in players},
        "outbox": [(ex, rk, norm_event(payload)) for _, ex, rk, payload in staged],
        "relayed": (relayed, [norm_event(r) for r in delivered]),
        "cashback": [(pid[c.account_id], c.losses, c.cashback, c.bonus_id is not None)
                     for c in cash],
        "reconcile": (report.checked, report.mismatched,
                      sorted((pid[s.account_id], s.balance, s.bonus, s.total_credit,
                              s.total_debit) for s in report.snapshots)),
        "gate_errors": (getattr(svc, "gate_errors", None), svc.risk.raised),
    }
    if store is not None:
        store.close()
    return out


@pytest.mark.parametrize("seed_", [1, 2])
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_wallet_outbox_cashback_reconcile_match_jax(tmp_path, kind, seed_):
    port = _drive_wallet(PORT, kind, str(tmp_path / "port.db"), seed_)
    jax = _drive_wallet(JAX, kind, str(tmp_path / "jax.db"), seed_)
    gate_errors, raised = port.pop("gate_errors")
    assert jax.pop("gate_errors") == (None, raised)
    for key in port:
        assert port[key] == jax[key], key
    kinds = {r[2][0] for r in port["outcomes"]}
    assert {"ok", "RiskBlockedError", "RiskReviewError", "RiskUnavailableError",
            "InsufficientBalanceError"} <= kinds
    assert port["reconcile"][1] == 0 and port["relayed"][0] == len(port["outbox"])
    # Every outage of the gate is counted: fail open, or closed.
    closed = sum(r[2][0] == "RiskUnavailableError" for r in port["outcomes"])
    assert gate_errors == {"open": raised["deposit"] + raised["bet"],
                           "closed": raised["withdraw"]} == {"open": gate_errors["open"],
                                                             "closed": closed}
    assert closed > 0 and gate_errors["open"] > 0


def test_seed_matches_jax(tmp_path, monkeypatch, capsys):
    rows = []
    for mods in (PORT, JAX):
        store = mods["repo"].SQLiteStore(str(tmp_path / f"{len(rows)}.db"))
        svc = mods["wallet"].WalletService(store.accounts, store.transactions, store.ledger,
                                           events=mods["outbox"].OutboxPublisher(store),
                                           audit=store.audit)
        first = [(p, total) for p, _, total in mods["seed"].seed(svc)]
        again = [(p, total) for p, _, total in mods["seed"].seed(svc)]  # idempotent
        report = mods["reconcile"].Reconciler(store.accounts, store.ledger).run_once()
        rows.append((first, again, report.checked, report.mismatched))
        store.close()
    assert rows[0] == rows[1] and rows[0][0] == rows[0][1] and rows[0][3] == 0
    monkeypatch.setenv("DATABASE_URL", f"sqlite://{tmp_path / 'cli.db'}")
    assert seed.main() == 0 and "seeded 3 accounts" in capsys.readouterr().out
    server = pg_testing.PgSqliteServer(str(tmp_path / "seed-pg.db"))
    try:
        monkeypatch.setenv("DATABASE_URL", server.url)
        assert seed.main() == 0 and "seeded 3 accounts into postgres://" in (
            capsys.readouterr().out)
    finally:
        server.close()
    monkeypatch.setenv("DATABASE_URL", "postgress://typo")
    assert seed.main() == 2


# -- bonus: the rule DSL and the engine -------------------------------------------


def _rule_yaml(rng, i: int) -> str:
    words = ["slots", "video_poker", "table_games", "live-casino", "featured_slot", "roulette"]
    lines = [f"  - id: rule_{i}", f'    name: "Rule #{i}: {rng.integers(1000)}% off"',
             f"    type: {rng.choice(['deposit_match', 'cashback', 'free_spins', 'no_deposit'])}",
             f"    description: {rng.choice(['plain words here', 'Weekend Boost 2', 'x'])}"]
    for key in ("match_percent", "max_bonus", "min_deposit", "wagering_multiplier",
                "max_bet_percent", "max_bet_absolute", "expiry_days", "fixed_amount"):
        if rng.random() < 0.7:
            lines.append(f"    {key}: {int(rng.integers(0, 100_000))}")
    games = rng.choice(words, int(rng.integers(0, 4)), replace=False)
    lines.append(f"    eligible_games: [{', '.join(games)}]")
    if rng.random() < 0.5:
        lines.append("    excluded_games: ['live_blackjack', \"craps\"]  # quoted items")
    if len(games) and rng.random() < 0.6:
        lines.append("    game_weights:")
        lines += [f"      {w}: {int(rng.integers(0, 101))}" for w in games]
    lines.append(f"    active: {'true' if rng.random() < 0.8 else 'false'}")
    lines.append(f"    one_time: {'true' if rng.random() < 0.5 else 'false'}")
    if rng.random() < 0.5:
        lines += ["    schedule:", "      days_of_week: [Friday, Saturday]",
                  f'      start_time: "{rng.integers(24):02d}:00"', "      end_time: '23:59'",
                  f'      start_date: "2026-0{rng.integers(1, 10)}-01"']
    if rng.random() < 0.5:
        lines += ["    conditions:", f"      min_deposits_lifetime: {int(rng.integers(0, 5))}",
                  f"      required_segment: {rng.choice(['vip', 'high'])}",
                  "      excluded_segments: [bonus_abuser, self_excluded]",
                  "      countries: []"]
    if rng.random() < 0.3:
        lines.append(f"    promo_code: 'CODE{i}'")
    return "\n".join(lines)


def _generated_rules(seed_: int) -> str:
    rng = np.random.default_rng(seed_)
    body = "\n\n".join(_rule_yaml(rng, i) for i in range(int(rng.integers(1, 7))))
    return f"# generated rule set {seed_}\nbonus_rules:\n{body}\n"


@pytest.mark.parametrize("source", ["shipped", *(f"generated-{s}" for s in range(6))])
def test_rules_reader_matches_safe_load(tmp_path, source):
    """The port's reader gives what yaml.safe_load gives, and the port's
    load_rules what the JAX one gives, on the shipped file and on seeded
    rule sets in the subset."""
    if source == "shipped":
        text = open(DEFAULT_RULES).read()
        assert yaml.safe_load(text) == yaml.safe_load(open(JAX_RULES).read())
        jax_path = JAX_RULES
    else:
        text = _generated_rules(int(source.split("-")[1]))
        jax_path = tmp_path / "rules.yaml"
        jax_path.write_text(text)
    assert bonus.read_yaml(text) == yaml.safe_load(text)
    port_path = tmp_path / "port.yaml"
    port_path.write_text(text)
    assert _plain(bonus.load_rules(str(port_path))) == _plain(jbonus.load_rules(str(jax_path)))


@pytest.mark.parametrize("snippet", [
    "t: 12:00", "d: 2026-03-01", "f: 1.5", "b: yes", "b: True", "n: ~", "n: null", "n:",
    "a: &x 1", "a: *x", "s: !!str 1", "s: |\n  text", "m: {a: 1}", "h: 0x10", "o: 010",
    "u: 1_000", 's: "a\\nb"', "k:\n\t- 1", "s: a  b", "s: a: b", "k: 1\nk: 2", "[1, 2]",
    "l: [a, [b]]", "s: 'it's'", "- a\nb: 1", "---\nk: 1"])
def test_rules_reader_refuses_outside_subset(snippet):
    """Anything outside the subset raises; the reader never guesses (YAML
    1.1 reads 12:00 as 720, 010 as 8, yes as True)."""
    with pytest.raises(bonus.YamlSubsetError):
        bonus.read_yaml(snippet)


def _drive_bonus(mods, seed_: int) -> list:
    clock = [1_772_000_000.0]  # 2026-02-25, before the launch window opens
    rng = np.random.default_rng(seed_)
    flagged = {f"a{i}" for i in range(0, 30, 7)}

    def risk(account_id):
        if account_id == "a3":
            raise RuntimeError("detector down")  # fail open
        return account_id in flagged

    def player(account_id):
        n = int(account_id[1:])
        return mods["bonus"].PlayerInfo(account_id, account_age_days=n % 12,
                                        total_deposits=n % 15, segment=("vip", "high", "")[n % 3])

    engine = mods["bonus"].BonusEngine(JAX_RULES if mods is JAX else DEFAULT_RULES,
                                       risk_checker=risk, player_data=player,
                                       now_fn=lambda: clock[0])
    rules = [r.id for r in engine.get_all_rules()]
    awarded: list = []
    out = []
    for _ in range(300):
        acct = f"a{rng.integers(30)}"
        op = rng.choice(["award", "wager", "max_bet", "eligible", "spin", "expire", "forfeit"],
                        p=[0.3, 0.3, 0.12, 0.1, 0.08, 0.05, 0.05])
        if op == "award":
            rule = rules[rng.integers(len(rules))]
            res = _outcome(lambda: engine.award_bonus(acct, rule,
                                                      deposit_amount=int(rng.integers(0, 300_000))))
            if res[0] == "ok":
                awarded.append(res[1].pop("id"))
        elif op == "wager":
            cat = str(rng.choice(["slots", "video_poker", "table_games", "", "craps"]))
            res = _outcome(lambda: sorted((b.rule_id, b.wagering_progress) for b in
                                          engine.process_wager(acct, int(rng.integers(1, 50_000)),
                                                               cat)))
        elif op == "max_bet":
            res = _outcome(lambda: engine.check_max_bet(acct, int(rng.integers(1, 5_000))))
        elif op == "eligible":
            res = _outcome(lambda: [r.id for r in engine.get_eligible_bonuses(acct)])
        elif op == "spin" and awarded:
            bid = awarded[rng.integers(len(awarded))]
            res = _outcome(lambda: engine.use_free_spin(bid, int(rng.integers(0, 900))))
            if res[0] == "ok":
                res[1].pop("id")
        elif op == "expire":
            res = _outcome(engine.expire_old_bonuses)
        else:
            res = _outcome(lambda: engine.forfeit_bonuses(acct))
        out.append((acct, str(op), res))
        clock[0] += float(rng.integers(0, 40_000))
    out.append(("abuse_check_errors", getattr(engine, "abuse_check_errors", None)))
    return out


@pytest.mark.parametrize("seed_", [3, 4])
def test_bonus_engine_matches_jax(seed_):
    port, jax = _drive_bonus(PORT, seed_), _drive_bonus(JAX, seed_)
    errors, jax_errors = port.pop(), jax.pop()
    assert port == jax
    assert jax_errors == ("abuse_check_errors", None) and errors[1] > 0
    kinds = {r[2][0] for r in port}
    assert {"ok", "NotEligibleError", "BonusAbuseError", "MaxBetExceededError"} <= kinds

"""Bonus engine — the YAML-DSL rule engine for promotions.

Semantics mirror
services/bonus/internal/service/bonus_engine.go: 5 bonus
types, rule schema with match %, caps, wagering multipliers, per-game
weights, schedules and eligibility conditions (:39-99); eligibility scan
(:207-242); award pipeline with abuse gate + one-time check and
wagering = amount x multiplier (:245-326); wagering progress with
game-weight contribution (:338-378, :485-514); max-bet enforcement under
active bonus (:389-418); expiry sweep (:421-442); forfeiture (:445-460).

A copy of ``igaming_platform_tpu/platform/bonus.py`` over the port's
modules, with one difference: the rule files are read by ``read_yaml``, a
reader of the YAML subset they use, so that the port needs no PyYAML. It
gives what ``yaml.safe_load`` gives on that subset and raises on anything
else. The engine counts the exceptions its fail-open abuse gate swallows
(``abuse_check_errors``).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Protocol

from igaming_platform_tpu_torch.core.enums import BonusStatus, BonusType
from igaming_platform_tpu_torch.platform.domain import new_id


@dataclass
class Schedule:
    days_of_week: list[str] = field(default_factory=list)
    start_time: str = ""
    end_time: str = ""
    start_date: str = ""
    end_date: str = ""


@dataclass
class Conditions:
    min_deposits_lifetime: int = 0
    min_account_age_days: int = 0
    max_account_age_days: int = 0
    required_segment: str = ""
    excluded_segments: list[str] = field(default_factory=list)
    countries: list[str] = field(default_factory=list)
    excluded_countries: list[str] = field(default_factory=list)


@dataclass
class BonusRule:
    id: str
    name: str = ""
    type: BonusType = BonusType.DEPOSIT_MATCH
    description: str = ""

    match_percent: int = 0
    max_bonus: int = 0
    min_deposit: int = 0
    fixed_amount: int = 0
    free_spins_count: int = 0
    cashback_percent: int = 0

    wagering_multiplier: int = 0
    max_bet_percent: int = 0
    max_bet_absolute: int = 0

    eligible_games: list[str] = field(default_factory=list)
    excluded_games: list[str] = field(default_factory=list)
    game_weights: dict[str, int] = field(default_factory=dict)

    expiry_days: int = 30
    schedule: Schedule | None = None
    conditions: Conditions | None = None

    active: bool = True
    one_time: bool = False
    promo_code: str = ""


@dataclass
class PlayerBonus:
    id: str
    account_id: str
    rule_id: str
    type: BonusType
    status: BonusStatus
    bonus_amount: int
    wagering_required: int
    wagering_progress: int = 0
    free_spins_total: int = 0
    free_spins_used: int = 0
    awarded_at: float = field(default_factory=time.time)
    expires_at: float = 0.0
    completed_at: float | None = None
    trigger_tx_id: str | None = None
    promo_code: str | None = None


@dataclass
class PlayerInfo:
    account_id: str
    account_age_days: int = 0
    total_deposits: int = 0  # lifetime deposit COUNT (bonus_engine.go:152)
    segment: str = ""
    country: str = ""
    total_bonus_claims: int = 0


class BonusRepository(Protocol):
    def create(self, bonus: PlayerBonus) -> None: ...
    def get_by_id(self, bonus_id: str) -> PlayerBonus | None: ...
    def get_active_by_account(self, account_id: str) -> list[PlayerBonus]: ...
    def update(self, bonus: PlayerBonus) -> None: ...
    def count_by_rule_and_account(self, rule_id: str, account_id: str) -> int: ...
    def get_expired(self, now: float) -> list[PlayerBonus]: ...


class InMemoryBonusRepository:
    def __init__(self):
        self._bonuses: dict[str, PlayerBonus] = {}

    def create(self, bonus: PlayerBonus) -> None:
        self._bonuses[bonus.id] = bonus

    def get_by_id(self, bonus_id: str) -> PlayerBonus | None:
        return self._bonuses.get(bonus_id)

    def get_active_by_account(self, account_id: str) -> list[PlayerBonus]:
        return [
            b for b in self._bonuses.values()
            if b.account_id == account_id and b.status == BonusStatus.ACTIVE
        ]

    def update(self, bonus: PlayerBonus) -> None:
        self._bonuses[bonus.id] = bonus

    def count_by_rule_and_account(self, rule_id: str, account_id: str) -> int:
        return sum(
            1 for b in self._bonuses.values()
            if b.rule_id == rule_id and b.account_id == account_id
        )

    def get_expired(self, now: float) -> list[PlayerBonus]:
        return [
            b for b in self._bonuses.values()
            if b.status == BonusStatus.ACTIVE and b.expires_at and b.expires_at < now
        ]


class SQLiteBonusRepository:
    """Durable bonus persistence (player_bonuses table, init-db.sql:75-115
    analog) on a SQLiteStore's connection."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS player_bonuses (
        id TEXT PRIMARY KEY,
        account_id TEXT NOT NULL,
        rule_id TEXT NOT NULL,
        type TEXT NOT NULL,
        status TEXT NOT NULL,
        bonus_amount INTEGER NOT NULL,
        wagering_required INTEGER NOT NULL,
        wagering_progress INTEGER NOT NULL DEFAULT 0,
        free_spins_total INTEGER NOT NULL DEFAULT 0,
        free_spins_used INTEGER NOT NULL DEFAULT 0,
        awarded_at REAL NOT NULL,
        expires_at REAL NOT NULL,
        completed_at REAL,
        trigger_tx_id TEXT,
        promo_code TEXT
    );
    CREATE INDEX IF NOT EXISTS idx_bonus_account_status
        ON player_bonuses(account_id, status);
    """

    def __init__(self, store):
        self._s = store
        with self._s._lock:
            self._s._conn.executescript(self._SCHEMA)

    def _row_to_bonus(self, r) -> PlayerBonus:
        return PlayerBonus(
            id=r[0], account_id=r[1], rule_id=r[2], type=BonusType(r[3]),
            status=BonusStatus(r[4]), bonus_amount=r[5], wagering_required=r[6],
            wagering_progress=r[7], free_spins_total=r[8], free_spins_used=r[9],
            awarded_at=r[10], expires_at=r[11], completed_at=r[12],
            trigger_tx_id=r[13], promo_code=r[14],
        )

    def create(self, b: PlayerBonus) -> None:
        with self._s._lock:
            self._s._conn.execute(
                "INSERT INTO player_bonuses VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (b.id, b.account_id, b.rule_id, b.type.value, b.status.value,
                 b.bonus_amount, b.wagering_required, b.wagering_progress,
                 b.free_spins_total, b.free_spins_used, b.awarded_at, b.expires_at,
                 b.completed_at, b.trigger_tx_id, b.promo_code),
            )
            self._s._conn.commit()

    def get_by_id(self, bonus_id: str) -> PlayerBonus | None:
        with self._s._lock:
            r = self._s._conn.execute(
                "SELECT * FROM player_bonuses WHERE id=?", (bonus_id,)
            ).fetchone()
        return self._row_to_bonus(r) if r else None

    def get_active_by_account(self, account_id: str) -> list[PlayerBonus]:
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT * FROM player_bonuses WHERE account_id=? AND status='active'",
                (account_id,),
            ).fetchall()
        return [self._row_to_bonus(r) for r in rows]

    def update(self, b: PlayerBonus) -> None:
        with self._s._lock:
            self._s._conn.execute(
                "UPDATE player_bonuses SET status=?, bonus_amount=?, wagering_required=?,"
                " wagering_progress=?, free_spins_used=?, completed_at=? WHERE id=?",
                (b.status.value, b.bonus_amount, b.wagering_required,
                 b.wagering_progress, b.free_spins_used, b.completed_at, b.id),
            )
            self._s._conn.commit()

    def count_by_rule_and_account(self, rule_id: str, account_id: str) -> int:
        with self._s._lock:
            r = self._s._conn.execute(
                "SELECT COUNT(*) FROM player_bonuses WHERE rule_id=? AND account_id=?",
                (rule_id, account_id),
            ).fetchone()
        return int(r[0])

    def get_expired(self, now: float) -> list[PlayerBonus]:
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT * FROM player_bonuses WHERE status='active' AND expires_at < ?",
                (now,),
            ).fetchall()
        return [self._row_to_bonus(r) for r in rows]


class BonusAbuseError(Exception):
    pass


class NotEligibleError(Exception):
    pass


class MaxBetExceededError(Exception):
    pass


_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_\-]*):(?:\s+(.*))?$")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_\-]*(?: [A-Za-z0-9_\-]+)*$")
# Plain words that YAML 1.1 resolves to a bool or to null.
_RESERVED = {"yes", "no", "on", "off", "true", "false", "null"}


class YamlSubsetError(ValueError):
    """A rule file uses YAML outside the subset ``read_yaml`` reads."""


def _strip_comment(line: str, lineno: int) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    if quote:
        raise YamlSubsetError(f"line {lineno}: unterminated quoted string")
    return line.rstrip()


def _scalar(text: str, lineno: int):
    """A scalar of the subset: a quoted string (no escapes), a decimal int,
    ``true``/``false``, or plain words that YAML 1.1 reads as a string
    (letters first, then letters, digits, ``_`` and ``-``, single spaces
    between words)."""
    if len(text) >= 2 and text[0] == text[-1] == '"':
        body = text[1:-1]
        if '"' in body or "\\" in body:
            raise YamlSubsetError(f"line {lineno}: escapes in {text!r}")
        return body
    if len(text) >= 2 and text[0] == text[-1] == "'":
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise YamlSubsetError(f"line {lineno}: bad quoting in {text!r}")
        return body.replace("''", "'")
    if _INT.match(text):
        return int(text)
    if text in ("true", "false"):
        return text == "true"
    if _WORD.match(text) and text.lower() not in _RESERVED:
        return text
    # Floats, dates, times (YAML 1.1 reads 12:00 as 720), nulls, anchors,
    # tags, block scalars, flow mappings, spaced plain strings: not read.
    raise YamlSubsetError(f"line {lineno}: {text!r} is outside the rule files' YAML subset")


def _flow_list(text: str, lineno: int) -> list:
    body = text[1:-1].strip()
    if not body:
        return []
    items, start, quote = [], 0, None
    for i, ch in enumerate(body + ","):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[]{}":
            raise YamlSubsetError(f"line {lineno}: nested flow collection in {text!r}")
        elif ch == ",":
            items.append(_scalar(body[start:i].strip(), lineno))
            start = i + 1
    return items


def _value(text: str, lineno: int):
    if text.startswith("[") and text.endswith("]"):
        return _flow_list(text, lineno)
    return _scalar(text, lineno)


def read_yaml(text: str):
    """The document of ``text`` in the subset the rule files use: block
    mappings with plain keys, block sequences (of mappings or scalars),
    flow lists of scalars, decimal ints, ``true``/``false``, quoted and
    plain strings, comments. Anything else raises ``YamlSubsetError``."""
    lines = []  # (indent, content, line number)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise YamlSubsetError(f"line {lineno}: tab")
        content = _strip_comment(raw, lineno)
        if content.strip():
            if content.strip() in ("---", "..."):
                raise YamlSubsetError(f"line {lineno}: document markers")
            lines.append((len(content) - len(content.lstrip(" ")), content.strip(), lineno))
    if not lines:
        raise YamlSubsetError("empty document")
    pos = 0

    def block(indent: int):
        if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
            return sequence(indent)
        return mapping(indent)

    def nested(parent: int, lineno: int):
        if pos >= len(lines) or lines[pos][0] <= parent:
            raise YamlSubsetError(f"line {lineno}: empty value (null)")
        return block(lines[pos][0])

    def mapping(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines) and lines[pos][0] == indent:
            _, content, lineno = lines[pos]
            m = _KEY.match(content)
            if m is None:
                raise YamlSubsetError(f"line {lineno}: {content!r} is not a plain key")
            key, rest = m.group(1), m.group(2)
            if key in out:
                raise YamlSubsetError(f"line {lineno}: duplicate key {key!r}")
            pos += 1
            out[key] = nested(indent, lineno) if rest is None else _value(rest, lineno)
        if pos < len(lines) and lines[pos][0] > indent:
            raise YamlSubsetError(f"line {lines[pos][2]}: unexpected indent")
        return out

    def sequence(indent: int) -> list:
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][0] == indent:
            _, content, lineno = lines[pos]
            if not content.startswith("- "):
                raise YamlSubsetError(f"line {lineno}: {content!r} in a sequence")
            rest = content[2:].lstrip(" ")
            if _KEY.match(rest):
                # A mapping item: its first key shares the dash's line.
                lines[pos] = (indent + len(content) - len(rest), rest, lineno)
                out.append(mapping(lines[pos][0]))
            else:
                pos += 1
                out.append(_value(rest, lineno))
        if pos < len(lines) and lines[pos][0] > indent:
            raise YamlSubsetError(f"line {lines[pos][2]}: unexpected indent")
        return out

    doc = block(lines[0][0])
    if pos < len(lines):
        raise YamlSubsetError(f"line {lines[pos][2]}: outdented past the document")
    return doc


def load_rules(config_path: str) -> list[BonusRule]:
    """Parse the YAML DSL (bonus_engine.go:171-204 / NewBonusEngine)."""
    with open(config_path) as f:
        raw = read_yaml(f.read())
    rules = []
    for entry in raw.get("bonus_rules", []):
        sched = entry.get("schedule")
        cond = entry.get("conditions")
        rules.append(BonusRule(
            id=entry["id"],
            name=entry.get("name", ""),
            type=BonusType(entry.get("type", "deposit_match")),
            description=entry.get("description", ""),
            match_percent=entry.get("match_percent", 0),
            max_bonus=entry.get("max_bonus", 0),
            min_deposit=entry.get("min_deposit", 0),
            fixed_amount=entry.get("fixed_amount", 0),
            free_spins_count=entry.get("free_spins_count", 0),
            cashback_percent=entry.get("cashback_percent", 0),
            wagering_multiplier=entry.get("wagering_multiplier", 0),
            max_bet_percent=entry.get("max_bet_percent", 0),
            max_bet_absolute=entry.get("max_bet_absolute", 0),
            eligible_games=entry.get("eligible_games", []) or [],
            excluded_games=entry.get("excluded_games", []) or [],
            game_weights=entry.get("game_weights", {}) or {},
            expiry_days=entry.get("expiry_days", 30),
            schedule=Schedule(**sched) if sched else None,
            conditions=Conditions(**cond) if cond else None,
            active=entry.get("active", True),
            one_time=entry.get("one_time", False),
            promo_code=entry.get("promo_code", ""),
        ))
    return rules


class BonusEngine:
    def __init__(
        self,
        rules: list[BonusRule] | str,
        repo: BonusRepository | None = None,
        risk_checker=None,  # callable(account_id) -> bool (is_abuser)
        player_data=None,  # callable(account_id) -> PlayerInfo
        now_fn=time.time,
    ):
        if isinstance(rules, str):
            rules = load_rules(rules)
        self.rules = rules
        self.rules_by_id = {r.id: r for r in rules}
        self.repo = repo or InMemoryBonusRepository()
        self.risk_checker = risk_checker
        self.player_data = player_data
        self.now_fn = now_fn
        # Exceptions of risk_checker that the fail-open abuse gate swallowed.
        self.abuse_check_errors = 0

    # -- eligibility (bonus_engine.go:207-242) -------------------------------

    def get_eligible_bonuses(self, account_id: str) -> list[BonusRule]:
        player = self.player_data(account_id) if self.player_data else PlayerInfo(account_id)
        eligible = []
        for rule in self.rules:
            if not rule.active:
                continue
            if rule.one_time and self.repo.count_by_rule_and_account(rule.id, account_id) > 0:
                continue
            if not self._check_conditions(rule, player):
                continue
            if not self._check_schedule(rule):
                continue
            eligible.append(rule)
        return eligible

    # -- award (bonus_engine.go:245-326) -------------------------------------

    def award_bonus(
        self,
        account_id: str,
        rule_id: str,
        deposit_amount: int = 0,
        trigger_tx_id: str | None = None,
        promo_code: str | None = None,
    ) -> PlayerBonus:
        rule = self.rules_by_id.get(rule_id)
        if rule is None:
            raise KeyError(f"bonus rule not found: {rule_id}")
        if not rule.active:
            raise NotEligibleError("bonus rule is not active")

        player = self.player_data(account_id) if self.player_data else PlayerInfo(account_id)
        if not self._check_conditions(rule, player):
            raise NotEligibleError("player not eligible for this bonus")

        # Abuse gate: fail-open on checker error (bonus_engine.go:268-275).
        if self.risk_checker is not None:
            try:
                if self.risk_checker(account_id):
                    raise BonusAbuseError("bonus blocked: suspected abuse")
            except BonusAbuseError:
                raise
            except Exception:
                self.abuse_check_errors += 1

        if rule.one_time and self.repo.count_by_rule_and_account(rule.id, account_id) > 0:
            raise NotEligibleError("bonus already claimed")

        amount = self._calculate_bonus_amount(rule, deposit_amount)
        # Free-spins bonuses legitimately start at zero monetary value —
        # winnings accrue per spin (use_free_spin). The reference's zero
        # check (bonus_engine.go:287-289) would wrongly reject them.
        if amount == 0 and not (rule.type == BonusType.FREE_SPINS and rule.free_spins_count > 0):
            raise NotEligibleError("calculated bonus amount is zero")

        now = self.now_fn()
        bonus = PlayerBonus(
            id=new_id(),
            account_id=account_id,
            rule_id=rule.id,
            type=rule.type,
            status=BonusStatus.ACTIVE,
            bonus_amount=amount,
            wagering_required=amount * rule.wagering_multiplier,
            free_spins_total=rule.free_spins_count,
            awarded_at=now,
            expires_at=now + rule.expiry_days * 86400,
            trigger_tx_id=trigger_tx_id,
            promo_code=promo_code,
        )
        self.repo.create(bonus)
        return bonus

    # -- wagering (bonus_engine.go:338-378) ----------------------------------

    def process_wager(self, account_id: str, bet_amount: int, game_category: str = "") -> list[PlayerBonus]:
        """Apply a bet's contribution to every active bonus; returns the
        bonuses that completed their wagering on this wager."""
        completed = []
        for bonus in self.repo.get_active_by_account(account_id):
            rule = self.rules_by_id.get(bonus.rule_id)
            if rule is None:
                continue
            contribution = self._wager_contribution(rule, game_category, bet_amount)
            if contribution == 0:
                continue
            bonus.wagering_progress += contribution
            if bonus.wagering_progress >= bonus.wagering_required:
                bonus.status = BonusStatus.COMPLETED
                bonus.completed_at = self.now_fn()
                completed.append(bonus)
            self.repo.update(bonus)
        return completed

    # -- max bet (bonus_engine.go:389-418) -----------------------------------

    def check_max_bet(self, account_id: str, bet_amount: int) -> None:
        for bonus in self.repo.get_active_by_account(account_id):
            rule = self.rules_by_id.get(bonus.rule_id)
            if rule is None:
                continue
            if rule.max_bet_percent > 0:
                max_bet = bonus.bonus_amount * rule.max_bet_percent // 100
                if bet_amount > max_bet:
                    raise MaxBetExceededError(
                        f"bet exceeds max bet limit: {bet_amount} > {max_bet}"
                        f" (max {rule.max_bet_percent}% of bonus)"
                    )
            if rule.max_bet_absolute > 0 and bet_amount > rule.max_bet_absolute:
                raise MaxBetExceededError(
                    f"bet exceeds absolute max bet: {bet_amount} > {rule.max_bet_absolute}"
                )

    # -- lifecycle (bonus_engine.go:421-460) ---------------------------------

    def expire_old_bonuses(self) -> int:
        count = 0
        for bonus in self.repo.get_expired(self.now_fn()):
            bonus.status = BonusStatus.EXPIRED
            self.repo.update(bonus)
            count += 1
        return count

    def forfeit_bonuses(self, account_id: str) -> int:
        count = 0
        for bonus in self.repo.get_active_by_account(account_id):
            bonus.status = BonusStatus.FORFEITED
            self.repo.update(bonus)
            count += 1
        return count

    # -- free spins (PlayerBonus free_spins_* accounting) ---------------------

    def use_free_spin(self, bonus_id: str, win_amount: int = 0) -> PlayerBonus:
        """Consume one free spin; spin winnings accrue to the bonus amount
        (capped at the rule's max win) and exhausting spins completes the
        spins phase — winnings then wager like any bonus funds."""
        bonus = self.repo.get_by_id(bonus_id)
        if bonus is None:
            raise KeyError(f"bonus not found: {bonus_id}")
        if bonus.type != BonusType.FREE_SPINS or bonus.status != BonusStatus.ACTIVE:
            raise NotEligibleError(f"not an active free-spins bonus: {bonus_id}")
        if bonus.free_spins_used >= bonus.free_spins_total:
            raise NotEligibleError("no free spins remaining")
        rule = self.rules_by_id.get(bonus.rule_id)
        bonus.free_spins_used += 1
        if win_amount > 0:
            bonus.bonus_amount += win_amount
            if rule is not None and rule.max_bonus and bonus.bonus_amount > rule.max_bonus:
                bonus.bonus_amount = rule.max_bonus
            if rule is not None:
                bonus.wagering_required = bonus.bonus_amount * rule.wagering_multiplier
        self.repo.update(bonus)
        return bonus

    def get_rule(self, rule_id: str) -> BonusRule | None:
        return self.rules_by_id.get(rule_id)

    def get_all_rules(self) -> list[BonusRule]:
        return [r for r in self.rules if r.active]

    # -- helpers (bonus_engine.go:464-604) -----------------------------------

    def _calculate_bonus_amount(self, rule: BonusRule, deposit_amount: int) -> int:
        if rule.type == BonusType.DEPOSIT_MATCH:
            bonus = deposit_amount * rule.match_percent // 100
            return min(bonus, rule.max_bonus) if rule.max_bonus else bonus
        if rule.type in (BonusType.NO_DEPOSIT, BonusType.FREEBET):
            return rule.fixed_amount
        if rule.type == BonusType.CASHBACK:
            return 0  # computed on losses by the cashback job
        return rule.fixed_amount

    def calculate_cashback(self, rule: BonusRule, weekly_losses: int) -> int:
        """Cashback = pct of losses, capped (the job the reference defers)."""
        if rule.type != BonusType.CASHBACK or weekly_losses <= 0:
            return 0
        amount = weekly_losses * rule.cashback_percent // 100
        return min(amount, rule.max_bonus) if rule.max_bonus else amount

    def _wager_contribution(self, rule: BonusRule, game_category: str, bet_amount: int) -> int:
        if game_category in rule.excluded_games:
            return 0
        if rule.eligible_games and game_category not in rule.eligible_games:
            return 0
        weight = rule.game_weights.get(game_category, 100)
        return bet_amount * weight // 100

    def _check_conditions(self, rule: BonusRule, player: PlayerInfo) -> bool:
        c = rule.conditions
        if c is None:
            return True
        if c.min_deposits_lifetime > 0 and player.total_deposits < c.min_deposits_lifetime:
            return False
        if c.min_account_age_days > 0 and player.account_age_days < c.min_account_age_days:
            return False
        if c.max_account_age_days > 0 and player.account_age_days > c.max_account_age_days:
            return False
        if c.required_segment and player.segment != c.required_segment:
            return False
        if player.segment in c.excluded_segments:
            return False
        if c.countries and player.country not in c.countries:
            return False
        if player.country in c.excluded_countries:
            return False
        return True

    def _check_schedule(self, rule: BonusRule) -> bool:
        s = rule.schedule
        if s is None:
            return True
        now = datetime.fromtimestamp(self.now_fn(), tz=timezone.utc)
        if s.start_date:
            start = datetime.strptime(s.start_date, "%Y-%m-%d").replace(tzinfo=timezone.utc)
            if now < start:
                return False
        if s.end_date:
            end = datetime.strptime(s.end_date, "%Y-%m-%d").replace(tzinfo=timezone.utc)
            if now > end:
                return False
        if s.days_of_week:
            today = now.strftime("%A")
            if today not in s.days_of_week:
                return False
        return True

"""Single-binary platform app: Wallet + Bonus + Risk wired end to end, on the card.

The port's counterpart of ``igaming_platform_tpu/platform/app.py``. The
reference deploys three processes coupled by gRPC + RabbitMQ
(README.md:19-36 topology); this app composes the same topology in one
process:

- every deposit, bet and withdrawal risk-gates through the
  ``TorchScoringEngine`` in process: one ``score()``, one engine step on
  the engine's device (with a GBDT backend, the forest kernel; with an MLP,
  the dense kernel);
- bet placement enforces bonus max-bet limits;
- completed transactions flow over the event broker into the scoring
  bridge (feature updates, abuse histories and a second score of each money
  event) and the bonus processor (wagering progress);
- the bonus award path runs the abuse gate against the sequence detector
  (``is_abuser``: the attention forward kernel and ``dense_f32``).

``params`` is a JAX-layout numpy params tree for ``ml_backend``, carried
across by ``convert.from_jax_params``; ``abuse_params`` is a
``SequenceModel`` (``convert.sequence_from_tree`` makes one from JAX
params), the detector's default when None. ``clock``, when given, is the
one clock of the feature windows, the bonus schedules and the wallet's
money events, so that two apps fed the same operations agree.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.core.enums import QUEUE_BONUS_PROCESSOR, EventType
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F
from igaming_platform_tpu_torch.platform.bonus import (
    BonusEngine,
    MaxBetExceededError,
    PlayerInfo,
    SQLiteBonusRepository,
)
from igaming_platform_tpu_torch.platform.domain import BonusRestrictionError
from igaming_platform_tpu_torch.platform.outbox import InMemoryOutbox, OutboxPublisher, OutboxRelay
from igaming_platform_tpu_torch.platform.repository import (
    InMemoryAccountRepository,
    InMemoryLedgerRepository,
    InMemoryTransactionRepository,
    SQLiteStore,
)
from igaming_platform_tpu_torch.platform.risk_adapter import InProcessRiskGate
from igaming_platform_tpu_torch.platform.wallet import WalletConfig, WalletService
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.serve.bridge import ScoringBridge
from igaming_platform_tpu_torch.serve.events import Consumer, Event, best_deduper, default_broker
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

# The port's own rules, found beside this module wherever the checkout is.
DEFAULT_RULES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                             "bonus_rules.yaml")


@dataclass
class AppConfig:
    bonus_rules_path: str = DEFAULT_RULES
    sqlite_path: str = ""  # empty = in-memory repositories
    scoring: ScoringConfig = None  # type: ignore[assignment]
    batch_size: int = 256

    def __post_init__(self):
        if self.scoring is None:
            self.scoring = ScoringConfig()


class PlatformApp:
    def __init__(self, config: AppConfig | None = None, *, ml_backend: str = "mock",
                 params=None, abuse_params=None, device: str = "cuda", clock=None):
        self.config = config or AppConfig()
        self.broker = default_broker()

        # Risk: the scoring engine and the sequence abuse detector.
        self.engine = TorchScoringEngine(
            self.config.scoring,
            ml_backend=ml_backend,
            params=None if params is None else from_jax_params(ml_backend, params),
            batcher_config=BatcherConfig(batch_size=self.config.batch_size, max_wait_ms=1.0),
            feature_store=InMemoryFeatureStore(clock=clock or time.time),
            device=device,
        )
        self.abuse = SequenceAbuseDetector(params=abuse_params, device=device)
        self.risk_gate = InProcessRiskGate(self.engine)
        self.bridge = ScoringBridge(self.engine, self.broker, abuse_detector=self.abuse)

        # Wallet.
        if self.config.sqlite_path:
            self.store = SQLiteStore(self.config.sqlite_path)
            accounts, transactions, ledger = (
                self.store.accounts, self.store.transactions, self.store.ledger
            )
        else:
            self.store = None
            accounts = InMemoryAccountRepository()
            transactions = InMemoryTransactionRepository()
            ledger = InMemoryLedgerRepository()
        # Transactional outbox: wallet events stage into the same store as
        # the money movement and a relay delivers them at least once, so a
        # broker outage at commit time delays events instead of dropping them.
        self.outbox = self.store if self.store is not None else InMemoryOutbox()
        self.outbox_relay = OutboxRelay(self.outbox, self.broker)
        self.wallet = WalletService(
            accounts, transactions, ledger,
            events=OutboxPublisher(self.outbox),
            risk=self.risk_gate,
            audit=self.store.audit if self.store is not None else None,
            config=WalletConfig(
                risk_threshold_block=self.config.scoring.block_threshold,
                risk_threshold_review=self.config.scoring.review_threshold,
            ),
            clock=clock,
        )

        # Bonus: abuse gate via the sequence detector, player data from the
        # feature store. Wagering progress is durable when the store is, so
        # the delivery claim (below) and the progress live in one store.
        self.bonus = BonusEngine(
            self.config.bonus_rules_path,
            repo=SQLiteBonusRepository(self.store) if self.store is not None else None,
            risk_checker=self.abuse.is_abuser,
            player_data=self._player_info,
            now_fn=clock or time.time,
        )
        self._bonus_consumer = Consumer(self.broker)
        self._bonus_consumer.subscribe(QUEUE_BONUS_PROCESSOR, self._on_wallet_event)
        # process_wager is not idempotent (progress accumulates) and the
        # relay delivers at least once: dedupe on the envelope id, durably
        # when the store is durable.
        self._wager_dedupe = best_deduper(self.store)

    # -- wiring --------------------------------------------------------------

    def _player_info(self, account_id: str) -> PlayerInfo:
        row = np.zeros(NUM_FEATURES, dtype=np.float32)
        self.engine.features.fill_row(row, account_id, 0, "bet")
        return PlayerInfo(
            account_id=account_id,
            account_age_days=int(row[F.ACCOUNT_AGE_DAYS]),
            total_deposits=int(row[F.DEPOSIT_COUNT]),
            total_bonus_claims=int(row[F.BONUS_CLAIM_COUNT]),
        )

    def _on_wallet_event(self, event: Event) -> None:
        """Bonus processor: bets drive wagering progress."""
        if event.type != EventType.TRANSACTION_COMPLETED.value:
            return
        if event.data.get("type") != "bet":
            return
        account_id = str(event.data.get("account_id", ""))
        amount = int(event.data.get("amount", 0))
        # The bet's real game category; an empty one takes the bonus
        # engine's default weight.
        category = str(event.data.get("game_category", ""))
        uow = getattr(self.store, "unit_of_work", None) if self.store is not None else None
        if uow is not None:
            # The claim and the progress commit in one unit of work: a crash
            # between them can neither double-apply nor drop the event.
            with uow():
                if event.id and not self._wager_dedupe.claim(event.id):
                    return
                self.bonus.process_wager(account_id, amount, category)
            return
        claimed = bool(event.id) and self._wager_dedupe.claim(event.id)
        if event.id and not claimed:
            return
        try:
            self.bonus.process_wager(account_id, amount, category)
        except BaseException:
            if claimed:
                self._wager_dedupe.release(event.id)
            raise

    def _max_bet_gate(self, account_id: str, amount: int) -> None:
        try:
            self.bonus.check_max_bet(account_id, amount)
        except MaxBetExceededError as exc:
            raise BonusRestrictionError(str(exc)) from exc

    # -- public flows ---------------------------------------------------------

    def deposit(self, account_id: str, amount: int, key: str, **kw):
        res = self.wallet.deposit(account_id, amount, key, **kw)
        self.pump()
        return res

    def bet(self, account_id: str, amount: int, key: str, **kw):
        res = self.wallet.bet(account_id, amount, key, max_bet_check=self._max_bet_gate, **kw)
        self.pump()
        return res

    def win(self, account_id: str, amount: int, key: str, **kw):
        res = self.wallet.win(account_id, amount, key, **kw)
        self.pump()
        return res

    def withdraw(self, account_id: str, amount: int, key: str, **kw):
        res = self.wallet.withdraw(account_id, amount, key, **kw)
        self.pump()
        return res

    def claim_bonus(self, account_id: str, rule_id: str, deposit_amount: int = 0):
        """Award a bonus and credit the wallet's bonus balance."""
        bonus = self.bonus.award_bonus(account_id, rule_id, deposit_amount=deposit_amount)
        self.wallet.grant_bonus(account_id, bonus.bonus_amount, f"bonus:{bonus.id}", rule_id=rule_id)
        self.engine.features.record_bonus_claim(account_id)
        self.pump()
        return bonus

    def pump(self) -> None:
        """Drain event queues synchronously (deterministic for tests)."""
        self.outbox_relay.flush()
        self.bridge.drain()
        self._bonus_consumer.drain(QUEUE_BONUS_PROCESSOR)

    def gate_errors(self) -> dict[str, int]:
        """Exceptions each fail-open or fail-closed gate swallowed so far."""
        return {"wallet_open": self.wallet.gate_errors["open"],
                "wallet_closed": self.wallet.gate_errors["closed"],
                "bonus_abuse": self.bonus.abuse_check_errors}

    def close(self) -> None:
        self.engine.close()
        if self.store is not None:
            self.store.close()

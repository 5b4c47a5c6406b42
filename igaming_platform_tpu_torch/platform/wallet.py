"""WalletService — deposits, bets, wins, withdrawals over the ledger.

Business semantics mirror
services/wallet/internal/service/wallet_service.go, with
every money-moving op running the same pipeline (SURVEY.md §3.1):

  idempotency replay -> account fetch + status check -> risk gate ->
  pending tx row -> optimistic-lock balance update -> ledger entry ->
  complete -> event publish

and the reference's deliberate risk asymmetry preserved:
- deposits/bets FAIL OPEN when risk is down (wallet_service.go:271,
  :388-389) and block at the block threshold;
- withdrawals FAIL CLOSED (:605-608) and use the stricter *review*
  threshold (:610-614);
- bets consume bonus before real money (:398-408); wins credit real
  balance only (:497); withdrawals exclude bonus (:589-593).

A copy of ``igaming_platform_tpu/platform/wallet.py`` over the port's
modules, with two additions. The service counts what its risk gate
swallows (``gate_errors``): a gate that fails open lets every deposit and
bet pass unscored, so a dead scoring path shows there and nowhere else. And
a ``clock`` may stamp its money events, whose timestamps the scoring
bridge's feature windows read (the default is the envelope's, the wall
clock).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Protocol

from igaming_platform_tpu_torch.core.enums import (
    EXCHANGE_WALLET,
    AccountStatus,
    EventType,
    LedgerEntryType,
    TxStatus,
    TxType,
)
from igaming_platform_tpu_torch.platform.domain import (
    Account,
    AccountNotFoundError,
    AccountSuspendedError,
    ConcurrentUpdateError,
    InsufficientBalanceError,
    InvalidAmountError,
    LedgerEntry,
    RiskBlockedError,
    RiskReviewError,
    RiskUnavailableError,
    Transaction,
    new_id,
)
from igaming_platform_tpu_torch.platform.outbox import OutboxPublisher
from igaming_platform_tpu_torch.platform.repository import store_of, uow_of
from igaming_platform_tpu_torch.serve.events import Event, Publisher, new_transaction_event


class RiskGate(Protocol):
    """Risk check seam (wallet_service.go:40-42). Implementations: the
    in-process scoring-engine adapter or a risk.v1 gRPC client."""

    def score_transaction(
        self, account_id: str, amount: int, tx_type: str,
        game_id: str = "", ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> tuple[int, str, list[str]]:
        """Returns (score, action, reason_codes); raises on unavailability."""
        ...


@contextlib.contextmanager
def _null_uow():
    yield


@dataclass
class WalletConfig:
    risk_threshold_block: int = 80
    risk_threshold_review: int = 50


@dataclass
class OpResult:
    transaction: Transaction
    new_balance: int  # total (real + bonus) after the op
    risk_score: int | None = None
    real_deducted: int = 0
    bonus_deducted: int = 0


class WalletService:
    def __init__(
        self,
        accounts,
        transactions,
        ledger,
        events: Publisher | None = None,
        risk: RiskGate | None = None,
        config: WalletConfig | None = None,
        audit=None,
        clock=None,
    ):
        self.accounts = accounts
        self.transactions = transactions
        self.ledger = ledger
        self.events = events
        self.risk = risk
        self.config = config or WalletConfig()
        # audit(entity, entity_id, action, old, new) — the append-only
        # audit_log of init-db.sql:191-204 (SQLiteStore.audit); None = no-op.
        self.audit = audit
        self.clock = clock
        # Exceptions the risk gate raised and the service absorbed: "open"
        # for deposits and bets that passed unscored, "closed" for
        # withdrawals refused as RiskUnavailableError; the last one kept.
        self.gate_errors = {"open": 0, "closed": 0}
        self.last_gate_error: BaseException | None = None

    # -- account management --------------------------------------------------

    def create_account(self, player_id: str, currency: str = "USD") -> Account:
        existing = self.accounts.get_by_player_id(player_id)
        if existing is not None:
            return existing  # idempotent (wallet_service.go:191-194)
        account = Account(id=new_id(), player_id=player_id, currency=currency)
        self.accounts.create(account)
        self._publish(Event(
            type=EventType.ACCOUNT_CREATED.value,
            source="wallet-service",
            aggregate_id=account.id,
            data={"account_id": account.id, "player_id": player_id, "currency": currency},
        ))
        return account

    def get_balance(self, account_id: str) -> Account:
        return self.accounts.get_by_id(account_id)

    def set_account_status(self, account_id: str, status: AccountStatus, reason: str = "") -> Account:
        """Back-office lifecycle op (suspend / reactivate / close).

        The reference models the states (domain/models.go AccountStatus,
        repository UpdateStatus) but exposes no operation that transitions
        them; here the transition exists and is audit-logged with
        old/new values (init-db.sql:191-204 audit_log semantics).
        """
        account = self.accounts.get_by_id(account_id)
        old = account.status
        if old == status:
            return account
        self.accounts.update_status(account_id, status)
        self._audit("account", account_id, "status_change",
                    old=old.value, new=f"{status.value}:{reason}" if reason else status.value)
        return self.accounts.get_by_id(account_id)

    def get_transaction_history(
        self, account_id: str, limit: int = 50, offset: int = 0,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ):
        return self.transactions.list_by_account(
            account_id, limit, offset,
            types=types, from_ts=from_ts, to_ts=to_ts, game_id=game_id,
        )

    def count_transactions(
        self, account_id: str,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> int:
        return self.transactions.count_by_account(
            account_id, types=types, from_ts=from_ts, to_ts=to_ts, game_id=game_id,
        )

    # -- money movement -------------------------------------------------------

    def deposit(
        self, account_id: str, amount: int, idempotency_key: str,
        payment_method: str = "", reference: str = "",
        ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> OpResult:
        self._check_amount(amount)
        replay, account = self._begin_op(account_id, idempotency_key)
        if replay is not None:
            return replay

        risk_score = self._risk_gate_open(
            account_id, amount, "deposit", ip=ip, device_id=device_id, fingerprint=fingerprint
        )

        tx = self._pending_tx(account, idempotency_key, TxType.DEPOSIT, amount, reference)
        new_balance = account.balance + amount
        self._commit(account, tx, new_balance, account.bonus, "Deposit", risk_score)
        return OpResult(tx, new_balance + account.bonus, risk_score)

    def bet(
        self, account_id: str, amount: int, idempotency_key: str,
        game_id: str = "", round_id: str = "", game_category: str = "",
        ip: str = "", device_id: str = "", fingerprint: str = "",
        max_bet_check=None,
    ) -> OpResult:
        self._check_amount(amount)
        replay, account = self._begin_op(account_id, idempotency_key)
        if replay is not None:
            return replay

        # Sufficient total balance: real + bonus (wallet_service.go:371-375).
        total = account.balance + account.bonus
        if total < amount:
            raise InsufficientBalanceError(f"available={total}, required={amount}")

        # Bonus max-bet gate (the coupling the reference documents but never
        # wires — SURVEY.md §3.2): raises BonusRestrictionError.
        if max_bet_check is not None:
            max_bet_check(account_id, amount)

        risk_score = self._risk_gate_open(
            account_id, amount, "bet", game_id=game_id, ip=ip,
            device_id=device_id, fingerprint=fingerprint,
        )

        # Bonus-first deduction split (wallet_service.go:398-408).
        if account.bonus >= amount:
            bonus_deducted, real_deducted = amount, 0
        else:
            bonus_deducted, real_deducted = account.bonus, amount - account.bonus
        new_balance = account.balance - real_deducted
        new_bonus = account.bonus - bonus_deducted

        tx = self._pending_tx(
            account, idempotency_key, TxType.BET, amount,
            f"game:{game_id}:round:{round_id}", game_id=game_id, round_id=round_id,
        )
        tx.balance_before = total
        tx.balance_after = new_balance + new_bonus
        self._commit(account, tx, new_balance, new_bonus, "Bet", risk_score,
                     event_type=EventType.TRANSACTION_COMPLETED,
                     event_extra={"game_category": game_category})
        return OpResult(tx, new_balance + new_bonus, risk_score, real_deducted, bonus_deducted)

    def win(
        self, account_id: str, amount: int, idempotency_key: str,
        game_id: str = "", round_id: str = "", bet_tx_id: str = "",
        win_type: str = "normal",
    ) -> OpResult:
        self._check_amount(amount)
        # Wins skip the risk gate entirely (SURVEY.md §3.2) and credit the
        # real balance only (wallet_service.go:497-500).
        replay, account = self._begin_op(account_id, idempotency_key, require_active=False)
        if replay is not None:
            return replay
        new_balance = account.balance + amount
        tx = self._pending_tx(
            account, idempotency_key, TxType.WIN, amount,
            f"win:game:{game_id}:round:{round_id}:bet:{bet_tx_id}",
            game_id=game_id, round_id=round_id,
        )
        tx.balance_before = account.balance + account.bonus
        tx.balance_after = new_balance + account.bonus
        self._commit(account, tx, new_balance, account.bonus, "Win", None)
        return OpResult(tx, new_balance + account.bonus)

    def withdraw(
        self, account_id: str, amount: int, idempotency_key: str,
        payout_method: str = "", ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> OpResult:
        self._check_amount(amount)
        replay, account = self._begin_op(account_id, idempotency_key)
        if replay is not None:
            return replay

        # Only real balance withdraws (wallet_service.go:589-593).
        if account.balance < amount:
            raise InsufficientBalanceError(
                f"available={account.balance}, required={amount} (bonus excluded)"
            )

        # Withdrawal risk: fail closed, stricter review threshold
        # (wallet_service.go:595-615).
        if self.risk is not None:
            try:
                score, _, reasons = self.risk.score_transaction(
                    account_id, amount, "withdraw", ip=ip, device_id=device_id,
                    fingerprint=fingerprint,
                )
            except Exception as exc:
                self._note_gate_error("closed", exc)
                raise RiskUnavailableError("withdrawal pending: risk service unavailable") from exc
            if score >= self.config.risk_threshold_review:
                raise RiskReviewError(score, reasons)
            risk_score = score
        else:
            risk_score = None

        new_balance = account.balance - amount
        tx = self._pending_tx(
            account, idempotency_key, TxType.WITHDRAW, amount, f"payout:{payout_method}"
        )
        tx.balance_before = account.balance + account.bonus
        tx.balance_after = new_balance + account.bonus
        self._commit(account, tx, new_balance, account.bonus, "Withdrawal", risk_score,
                     event_type=EventType.WITHDRAWAL_COMPLETED)
        return OpResult(tx, new_balance + account.bonus, risk_score)

    def refund(self, account_id: str, original_tx_id: str, idempotency_key: str, reason: str = "") -> OpResult:
        replay = self._replay(account_id, idempotency_key)
        if replay is not None:
            return replay
        original = self.transactions.get_by_id(original_tx_id)
        if original is None or original.account_id != account_id:
            raise InvalidAmountError(f"original transaction not found: {original_tx_id}")
        account = self._active_account(account_id)
        amount = original.amount
        new_balance = account.balance + amount
        tx = self._pending_tx(
            account, idempotency_key, TxType.REFUND, amount, f"refund:{original_tx_id}:{reason}"
        )
        tx.balance_before = account.balance + account.bonus
        tx.balance_after = new_balance + account.bonus
        self._commit(account, tx, new_balance, account.bonus, "Refund", None)
        return OpResult(tx, new_balance + account.bonus)

    # -- bonus credit path (used by the bonus engine) -------------------------

    def grant_bonus(self, account_id: str, amount: int, idempotency_key: str, rule_id: str = "") -> OpResult:
        self._check_amount(amount)
        replay, account = self._begin_op(account_id, idempotency_key)
        if replay is not None:
            return replay
        new_bonus = account.bonus + amount
        tx = self._pending_tx(
            account, idempotency_key, TxType.BONUS_GRANT, amount, f"bonus:{rule_id}"
        )
        tx.balance_before = account.balance + account.bonus
        tx.balance_after = account.balance + new_bonus
        self._commit(account, tx, account.balance, new_bonus, "Bonus grant", None,
                     event_type=EventType.BONUS_AWARDED)
        return OpResult(tx, account.balance + new_bonus)

    def forfeit_bonus_balance(self, account_id: str, reason: str = "") -> int:
        """Zero the bonus balance (early-withdrawal forfeiture support).

        Runs as a real ADJUSTMENT transaction through the commit pipeline
        so the double-entry ledger records the debit — forfeited money
        must leave the books, not vanish from them (the reconciliation
        sweep would flag a bare balance overwrite as a mismatch).
        """
        account = self.accounts.get_by_id(account_id)
        forfeited = account.bonus
        if forfeited:
            tx = self._pending_tx(
                account, f"forfeit:{new_id()}", TxType.ADJUSTMENT, forfeited,
                f"bonus-forfeiture:{reason}" if reason else "bonus-forfeiture",
            )
            tx.balance_before = account.balance + account.bonus
            tx.balance_after = account.balance
            self._commit(account, tx, account.balance, 0, "Bonus forfeiture", None)
            self._audit("account", account_id, "bonus_forfeiture",
                        old=str(forfeited), new="0")
        return forfeited

    # -- internals ------------------------------------------------------------

    def _check_amount(self, amount: int) -> None:
        if amount <= 0:
            raise InvalidAmountError(f"amount must be positive: {amount}")

    def _begin_op(
        self, account_id: str, idempotency_key: str, *, require_active: bool = True,
    ) -> tuple[OpResult | None, Account | None]:
        """Op prologue: idempotency replay check + account fetch.

        On backends exposing a combined pipelined read (PostgresStore's
        get_idem_and_account) both rows arrive in ONE wire round trip;
        otherwise two eager reads. Semantics identical either way: failed
        rows do not satisfy idempotency (_replay docstring), a missing
        account raises, and a replay hit returns before any status check
        (a suspended account still replays its past result)."""
        combo = getattr(self.transactions, "get_idem_and_account", None)
        if combo is None:
            replay = self._replay(account_id, idempotency_key)
            if replay is not None:
                return replay, None
            account = (self._active_account(account_id) if require_active
                       else self.accounts.get_by_id(account_id))
            return None, account
        existing, account = combo(account_id, idempotency_key)
        replay = self._replay_result(existing)
        if replay is not None:
            return replay, None
        if account is None:
            raise AccountNotFoundError(account_id)
        if require_active:
            self._check_active(account)
        return None, account

    def _replay(self, account_id: str, idempotency_key: str) -> OpResult | None:
        """Idempotency replay (wallet_service.go:242-248).

        Failed transactions do NOT satisfy idempotency: a retry after an
        optimistic-lock conflict must re-execute, not replay the failure.
        (The reference replays any status — a retried deposit whose first
        attempt lost the version race would silently never apply.)
        """
        existing = self.transactions.get_by_idempotency_key(account_id, idempotency_key)
        return self._replay_result(existing)

    @staticmethod
    def _replay_result(existing: Transaction | None) -> OpResult | None:
        """The one place the replay rule lives: failed rows never satisfy
        idempotency (both prologue paths share this filter)."""
        if existing is None or existing.status == TxStatus.FAILED:
            return None
        return OpResult(existing, existing.balance_after)

    @staticmethod
    def _check_active(account: Account) -> None:
        if account.status != AccountStatus.ACTIVE:
            raise AccountSuspendedError(f"account is not active: {account.status.value}")

    def _active_account(self, account_id: str) -> Account:
        account = self.accounts.get_by_id(account_id)
        self._check_active(account)
        return account

    def _risk_gate_open(
        self, account_id: str, amount: int, tx_type: str, *,
        game_id: str = "", ip: str = "", device_id: str = "", fingerprint: str = "",
    ) -> int | None:
        """Fail-open risk gate for deposits/bets: log-and-continue when risk
        is down, block at the block threshold (wallet_service.go:262-279)."""
        if self.risk is None:
            return None
        try:
            score, _, reasons = self.risk.score_transaction(
                account_id, amount, tx_type, game_id=game_id, ip=ip,
                device_id=device_id, fingerprint=fingerprint,
            )
        except Exception as exc:
            self._note_gate_error("open", exc)
            return None  # fail open
        if score >= self.config.risk_threshold_block:
            raise RiskBlockedError(score, reasons)
        return score

    def _note_gate_error(self, kind: str, exc: BaseException) -> None:
        self.gate_errors[kind] += 1
        self.last_gate_error = exc

    def _pending_tx(
        self, account: Account, idempotency_key: str, tx_type: TxType, amount: int,
        reference: str, game_id: str | None = None, round_id: str | None = None,
    ) -> Transaction:
        tx = Transaction(
            id=new_id(),
            account_id=account.id,
            idempotency_key=idempotency_key,
            type=tx_type,
            amount=amount,
            balance_before=account.balance,
            balance_after=account.balance + (amount if tx_type.is_credit else -amount),
            reference=reference,
            game_id=game_id,
            round_id=round_id,
        )
        return tx

    def _commit(
        self, account: Account, tx: Transaction, new_balance: int, new_bonus: int,
        description: str, risk_score: int | None,
        event_type: EventType = EventType.TRANSACTION_COMPLETED,
        event_extra: dict | None = None,
    ) -> None:
        """Persist the money movement: tx row -> optimistic balance update ->
        ledger -> complete + event.

        On a store with unit_of_work (SQLite) the WHOLE pipeline is one
        database transaction (postgres.go:393-443 UnitOfWork): a crash or
        error at any step rolls everything back — the books can never
        diverge mid-op. In-memory repos run step-by-step (divergence there
        is detectable via ledger.verify_balance, the reference's own
        guarantee level).
        """
        tx.risk_score = risk_score
        uow = uow_of(self.transactions)
        deferred_event: Event | None = None
        try:
            with uow() if uow is not None else _null_uow():
                self.transactions.create(tx)
                self.accounts.update_balance(account.id, new_balance, new_bonus, account.version)
                self._ledger_entry(tx, description)
                tx.complete()
                event = new_transaction_event(event_type.value, {
                    "id": tx.id, "account_id": tx.account_id, "type": tx.type.value,
                    "amount": tx.amount, "balance_before": tx.balance_before,
                    "balance_after": tx.balance_after, "status": tx.status.value,
                    "game_id": tx.game_id or "", "round_id": tx.round_id or "",
                    "risk_score": risk_score or 0,
                    **(event_extra or {}),
                })
                if self.clock is not None:
                    event.timestamp = self.clock()
                deferred_event = self._complete_and_publish(
                    tx, event, defer_publish=uow is not None)
            # A direct-broker publish must not race the database commit: a
            # rollback after publish would emit a ghost event for a money
            # movement that never happened. Publish only once the UoW above
            # has committed.
            if deferred_event is not None:
                self._publish(deferred_event)
        except ConcurrentUpdateError:
            # The optimistic-lock loser keeps an auditable FAILED row (the
            # UoW rolled its pending row back, so persist it afresh; the
            # partial unique index ignores failed rows, releasing the key
            # for the retry).
            tx.fail()
            if uow is not None:
                self.transactions.create(tx)
            else:
                self.transactions.update(tx)
            raise

    def _ledger_entry(self, tx: Transaction, description: str) -> None:
        """Double-entry record (wallet_service.go:679-704)."""
        entry_type = LedgerEntryType.CREDIT if tx.type.is_credit else LedgerEntryType.DEBIT
        self.ledger.create(LedgerEntry(
            id=new_id(),
            transaction_id=tx.id,
            account_id=tx.account_id,
            entry_type=entry_type,
            amount=tx.amount,
            balance_after=tx.balance_after,
            description=description,
        ))

    def _complete_and_publish(
        self, tx: Transaction, event: Event, *, defer_publish: bool = False
    ) -> Event | None:
        """Mark the transaction completed and emit its event.

        When the event seam is the transactional outbox backed by the SAME
        store as the transaction rows, the completion update and the event
        stage commit atomically (update_with_event) — a crash cannot
        complete the money movement without staging its event. Otherwise
        (in-memory repos, direct broker) the two steps run sequentially;
        with ``defer_publish`` the event is returned to the caller to
        publish after its unit of work commits, instead of reaching the
        broker while the transaction is still uncommitted.
        """
        atomic = (
            isinstance(self.events, OutboxPublisher)
            and hasattr(self.transactions, "update_with_event")
            and store_of(self.transactions) is self.events.outbox
        )
        if atomic:
            self.transactions.update_with_event(tx, EXCHANGE_WALLET, event.type, event.to_json())
            return None
        self.transactions.update(tx)
        if defer_publish:
            return event
        self._publish(event)
        return None

    def _audit(self, entity: str, entity_id: str, action: str, old: str = "", new: str = "") -> None:
        if self.audit is not None:
            try:
                self.audit(entity, entity_id, action, old, new)
            except Exception:  # noqa: BLE001 — auditing must not fail the op
                pass

    def _publish(self, event: Event) -> None:
        if self.events is not None:
            try:
                self.events.publish(EXCHANGE_WALLET, event)
            except Exception:  # noqa: BLE001 — events are best-effort
                pass

"""Wallet domain entities + errors.

Mirrors services/wallet/internal/domain/models.go: Account
with real + bonus balances in cents and an optimistic-lock version,
Transaction with before/after balances and idempotency key, LedgerEntry for
double-entry bookkeeping, BalanceSnapshot for audit.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field

from igaming_platform_tpu_torch.core.enums import (
    AccountStatus,
    LedgerEntryType,
    TxStatus,
    TxType,
)


class WalletError(Exception):
    code = "WALLET_ERROR"


class AccountNotFoundError(WalletError):
    code = "ACCOUNT_NOT_FOUND"


class AccountSuspendedError(WalletError):
    code = "ACCOUNT_SUSPENDED"


class InsufficientBalanceError(WalletError):
    code = "INSUFFICIENT_BALANCE"


class DuplicateTransactionError(WalletError):
    code = "DUPLICATE_TRANSACTION"


class InvalidAmountError(WalletError):
    code = "INVALID_AMOUNT"


class ConcurrentUpdateError(WalletError):
    code = "CONCURRENT_UPDATE"


class RiskBlockedError(WalletError):
    code = "RISK_BLOCKED"

    def __init__(self, score: int, reasons: list[str]):
        super().__init__(f"blocked by risk: score={score}, reasons={reasons}")
        self.score = score
        self.reasons = reasons


class RiskReviewError(WalletError):
    code = "RISK_REVIEW"

    def __init__(self, score: int, reasons: list[str]):
        super().__init__(f"requires review: score={score}, reasons={reasons}")
        self.score = score
        self.reasons = reasons


class RiskUnavailableError(WalletError):
    code = "RISK_UNAVAILABLE"


class BonusRestrictionError(WalletError):
    code = "BONUS_RESTRICTION"


def new_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Account:
    id: str
    player_id: str
    currency: str = "USD"
    balance: int = 0  # real, cents
    bonus: int = 0  # bonus, cents
    status: AccountStatus = AccountStatus.ACTIVE
    version: int = 1
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    @property
    def total_balance(self) -> int:
        return self.balance + self.bonus

    @property
    def available_for_withdraw(self) -> int:
        # Bonus funds are never withdrawable (models.go:72-74).
        return self.balance

    def can_transact(self) -> bool:
        return self.status == AccountStatus.ACTIVE


@dataclass
class Transaction:
    id: str
    account_id: str
    idempotency_key: str
    type: TxType
    amount: int  # always positive, cents
    balance_before: int
    balance_after: int
    status: TxStatus = TxStatus.PENDING
    reference: str = ""
    game_id: str | None = None
    round_id: str | None = None
    metadata: dict = field(default_factory=dict)
    risk_score: int | None = None
    created_at: float = field(default_factory=time.time)
    completed_at: float | None = None

    def complete(self) -> None:
        self.status = TxStatus.COMPLETED
        self.completed_at = time.time()

    def fail(self) -> None:
        self.status = TxStatus.FAILED

    @property
    def is_credit(self) -> bool:
        return self.type.is_credit

    @property
    def is_debit(self) -> bool:
        return self.type.is_debit


@dataclass
class LedgerEntry:
    id: str
    transaction_id: str
    account_id: str
    entry_type: LedgerEntryType
    amount: int
    balance_after: int
    description: str = ""
    created_at: float = field(default_factory=time.time)


@dataclass
class BalanceSnapshot:
    account_id: str
    balance: int
    bonus: int
    snapshot_at: float
    tx_count: int
    total_debit: int
    total_credit: int


def new_transaction(
    account_id: str,
    idempotency_key: str,
    tx_type: TxType,
    amount: int,
    balance_before: int,
    reference: str = "",
) -> Transaction:
    """Balance math per models.go:123-153: credits add, debits subtract."""
    balance_after = balance_before
    if tx_type.is_credit:
        balance_after = balance_before + amount
    elif tx_type.is_debit:
        balance_after = balance_before - amount
    return Transaction(
        id=new_id(),
        account_id=account_id,
        idempotency_key=idempotency_key,
        type=tx_type,
        amount=amount,
        balance_before=balance_before,
        balance_after=balance_after,
    )

"""Domain enums of the risk and wallet services.

A pure-Python copy of ``igaming_platform_tpu/core/enums.py``: the port keeps
its own so that it never imports the JAX package. The reason-bit order, the
action codes and every enum value are the same, so a reason mask or an
action code written by either package decodes the same way in the other.
"""

from __future__ import annotations

import enum


class ReasonCode(str, enum.Enum):
    HIGH_VELOCITY = "HIGH_VELOCITY"
    NEW_ACCOUNT_LARGE_TX = "NEW_ACCOUNT_LARGE_TX"
    IP_COUNTRY_MISMATCH = "IP_COUNTRY_MISMATCH"
    MULTIPLE_DEVICES = "MULTIPLE_DEVICES"
    SUSPICIOUS_PATTERN = "SUSPICIOUS_PATTERN"
    VPN_DETECTED = "VPN_DETECTED"
    KNOWN_FRAUDSTER = "KNOWN_FRAUDSTER"
    RAPID_DEPOSIT_WITHDRAW = "RAPID_DEPOSIT_WITHDRAW"
    BONUS_ABUSE = "BONUS_ABUSE"
    ML_HIGH_RISK = "ML_HIGH_RISK"
    MULTI_ACCOUNT = "MULTI_ACCOUNT"
    DEVICE_FINGERPRINT_MISMATCH = "DEVICE_FINGERPRINT_MISMATCH"
    # Stateful sequence scoring (serve/session_state.py): the session head
    # over the account's device-resident event window flagged a coordinated
    # pattern (SESSION_PATTERN), or the row was scored while the account's
    # session window was still cold — too few events for the sequence head
    # to speak (SESSION_COLD; the honest stateless-fallback marker).
    SESSION_PATTERN = "SESSION_PATTERN"
    SESSION_COLD = "SESSION_COLD"
    # Not part of the in-graph reason bitmask (REASON_BIT_ORDER): appended
    # host-side by the supervisor's CPU heuristic tier so degraded-mode
    # responses are wire-compatible yet visibly flagged.
    DEGRADED_CPU_HEURISTIC = "DEGRADED_CPU_HEURISTIC"


# Bit positions used for the in-graph reason bitmask. Order matches the
# reference's rule application order (engine.go:420-483) with ML_HIGH_RISK
# appended last (engine.go:285-287), so decoded reason lists compare equal.
# The two SESSION_* bits are APPENDED (never reordered): a mask written
# before they existed decodes to the same reason list, so ledger records
# and wire responses stay backward-compatible.
REASON_BIT_ORDER: tuple[ReasonCode, ...] = (
    ReasonCode.HIGH_VELOCITY,
    ReasonCode.NEW_ACCOUNT_LARGE_TX,
    ReasonCode.MULTIPLE_DEVICES,
    ReasonCode.IP_COUNTRY_MISMATCH,
    ReasonCode.VPN_DETECTED,
    ReasonCode.RAPID_DEPOSIT_WITHDRAW,
    ReasonCode.BONUS_ABUSE,
    ReasonCode.KNOWN_FRAUDSTER,
    ReasonCode.ML_HIGH_RISK,
    ReasonCode.SESSION_PATTERN,
    ReasonCode.SESSION_COLD,
)

# Bit indices of the session head's reason bits (serve/session_state.py
# sets them inside the fused scoring graph).
SESSION_PATTERN_BIT = REASON_BIT_ORDER.index(ReasonCode.SESSION_PATTERN)
SESSION_COLD_BIT = REASON_BIT_ORDER.index(ReasonCode.SESSION_COLD)


def decode_reason_mask(mask: int) -> list[ReasonCode]:
    """Expand an in-graph reason bitmask into ordered reason codes."""
    return [code for bit, code in enumerate(REASON_BIT_ORDER) if mask & (1 << bit)]


class Action(str, enum.Enum):
    APPROVE = "approve"
    REVIEW = "review"
    BLOCK = "block"


# Integer codes used on-device; must stay aligned with risk.v1 Action enum
# (proto/risk/v1/risk.proto): APPROVE=1, REVIEW=2, BLOCK=3.
ACTION_APPROVE = 1
ACTION_REVIEW = 2
ACTION_BLOCK = 3

_ACTION_BY_CODE = {ACTION_APPROVE: Action.APPROVE, ACTION_REVIEW: Action.REVIEW, ACTION_BLOCK: Action.BLOCK}


def action_from_code(code: int) -> Action:
    return _ACTION_BY_CODE[int(code)]


class TxType(str, enum.Enum):
    DEPOSIT = "deposit"
    WITHDRAW = "withdraw"
    BET = "bet"
    WIN = "win"
    REFUND = "refund"
    BONUS_GRANT = "bonus_grant"
    BONUS_WAGER = "bonus_wager"
    ADJUSTMENT = "adjustment"

    @property
    def is_credit(self) -> bool:
        return self in (TxType.DEPOSIT, TxType.WIN, TxType.REFUND, TxType.BONUS_GRANT)

    @property
    def is_debit(self) -> bool:
        return self in (TxType.WITHDRAW, TxType.BET, TxType.BONUS_WAGER)


class TxStatus(str, enum.Enum):
    PENDING = "pending"
    COMPLETED = "completed"
    FAILED = "failed"
    REVERSED = "reversed"


class AccountStatus(str, enum.Enum):
    ACTIVE = "active"
    SUSPENDED = "suspended"
    CLOSED = "closed"


class LedgerEntryType(str, enum.Enum):
    DEBIT = "debit"
    CREDIT = "credit"


class Segment(str, enum.Enum):
    VIP = "vip"
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"
    CHURNING = "churning"


# On-device segment codes; aligned with risk.v1 Segment enum.
SEGMENT_CODES = {
    Segment.VIP: 1,
    Segment.HIGH: 2,
    Segment.MEDIUM: 3,
    Segment.LOW: 4,
    Segment.CHURNING: 5,
}
SEGMENT_BY_CODE = {v: k for k, v in SEGMENT_CODES.items()}


class BonusType(str, enum.Enum):
    DEPOSIT_MATCH = "deposit_match"
    FREE_SPINS = "free_spins"
    CASHBACK = "cashback"
    NO_DEPOSIT = "no_deposit"
    FREEBET = "freebet"


class BonusStatus(str, enum.Enum):
    PENDING = "pending"
    ACTIVE = "active"
    COMPLETED = "completed"
    EXPIRED = "expired"
    CANCELLED = "cancelled"
    FORFEITED = "forfeited"


class EventType(str, enum.Enum):
    ACCOUNT_CREATED = "account.created"
    TRANSACTION_COMPLETED = "transaction.completed"
    TRANSACTION_FAILED = "transaction.failed"
    DEPOSIT_RECEIVED = "deposit.received"
    WITHDRAWAL_REQUESTED = "withdrawal.requested"
    WITHDRAWAL_COMPLETED = "withdrawal.completed"
    BET_PLACED = "bet.placed"
    WIN_PAID = "win.paid"
    BONUS_AWARDED = "bonus.awarded"
    BONUS_COMPLETED = "bonus.completed"
    BONUS_EXPIRED = "bonus.expired"
    RISK_SCORE_HIGH = "risk.score.high"
    RISK_BLOCKED = "risk.blocked"
    FRAUD_DETECTED = "fraud.detected"


# Exchange / queue topology (publisher.go:35-44).
EXCHANGE_WALLET = "wallet.events"
EXCHANGE_BONUS = "bonus.events"
EXCHANGE_RISK = "risk.events"

QUEUE_RISK_SCORING = "risk.scoring"
QUEUE_BONUS_PROCESSOR = "bonus.processor"
QUEUE_ANALYTICS = "analytics.events"
QUEUE_NOTIFICATIONS = "notifications.events"

"""Exact integer money for the host-side platform layer.

The reference keeps money as arbitrary-precision decimals
(pkg/money/money.go:16-19) but the wire contract and the
database schema are integer cents (wallet.proto:58-63, init-db.sql:13-26).
This framework standardises on int64 **minor units** everywhere — exact,
hashable, and directly usable as device arrays (an accelerator has no decimal type) —
with the same checked semantics: negative construction rejected,
currency-mismatch and insufficient-funds errors on arithmetic
(money.go:49-142).

The minor-unit exponent is per currency (money.go:24-31 lists BTC/ETH
alongside the fiats): fiat currencies use 2 (cents — the wire and DB
contract, unchanged), BTC uses 8 (satoshi), ETH uses 9 (nano-ETH / gwei).
Full 18-decimal wei would cap balances at ~9.2 ETH inside int64, so the
finest unit that keeps a practical range is used instead; 1 nano-ETH is
still ~7 orders of magnitude below a cent, i.e. genuinely sub-cent. For
USD — the only currency on the benchmarked wire paths — a ``Money``'s
integer value is bit-identical to the old cents representation.

Python ints are unbounded, so ``Money`` validates the int64 range explicitly
to preserve database/wire compatibility.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1


class Currency(str, enum.Enum):
    USD = "USD"
    EUR = "EUR"
    GBP = "GBP"
    RUB = "RUB"
    BTC = "BTC"
    ETH = "ETH"


#: Decimal digits in one major unit, per currency (money.go:24-31's set).
MINOR_UNIT_EXPONENT: dict[Currency, int] = {
    Currency.USD: 2,
    Currency.EUR: 2,
    Currency.GBP: 2,
    Currency.RUB: 2,
    Currency.BTC: 8,  # satoshi
    Currency.ETH: 9,  # nano-ETH; see module docstring for the int64 tradeoff
}


class MoneyError(ValueError):
    pass


class NegativeAmountError(MoneyError):
    pass


class InsufficientFundsError(MoneyError):
    pass


class CurrencyMismatchError(MoneyError):
    pass


class InvalidAmountError(MoneyError):
    pass


def _check_int64(cents: int) -> int:
    if not (INT64_MIN <= cents <= INT64_MAX):
        raise InvalidAmountError(f"amount out of int64 range: {cents}")
    return cents


@dataclass(frozen=True, slots=True)
class Money:
    """Immutable monetary value: integer minor units + currency.

    The field keeps its historical name ``cents`` — for every fiat
    currency the value IS cents, and the wallet wire contract
    (wallet.proto:58-63) reads it unchanged. For BTC/ETH it holds
    satoshi / nano-ETH per ``MINOR_UNIT_EXPONENT``.
    """

    cents: int
    currency: Currency = Currency.USD

    def __post_init__(self) -> None:
        if not isinstance(self.cents, int) or isinstance(self.cents, bool):
            raise InvalidAmountError(f"cents must be int, got {type(self.cents).__name__}")
        _check_int64(self.cents)
        if self.cents < 0:
            raise NegativeAmountError(f"amount cannot be negative: {self.cents}")

    @property
    def exponent(self) -> int:
        return MINOR_UNIT_EXPONENT[self.currency]

    # -- constructors -------------------------------------------------------

    @classmethod
    def zero(cls, currency: Currency = Currency.USD) -> "Money":
        return cls(0, currency)

    @classmethod
    def from_cents(cls, cents: int, currency: Currency = Currency.USD) -> "Money":
        """Wire-contract constructor: the int64 amount field, interpreted
        in the account currency's minor unit (cents for fiat)."""
        return cls(int(cents), currency)

    from_minor_units = from_cents

    @classmethod
    def parse(cls, value: str, currency: Currency = Currency.USD) -> "Money":
        """Parse a decimal string like '12.34' (or '0.00000001' BTC)
        into exact minor units at the currency's precision."""
        exp = MINOR_UNIT_EXPONENT[currency]
        text = value.strip()
        negative = text.startswith("-")
        if negative:
            raise NegativeAmountError(f"amount cannot be negative: {value}")
        if text.startswith("+"):
            text = text[1:]
        whole, _, frac = text.partition(".")
        if whole == "" and frac == "":
            raise InvalidAmountError(f"invalid amount format: {value!r}")
        try:
            units = int(whole or "0") * 10**exp
            if frac:
                if len(frac) > exp and any(c != "0" for c in frac[exp:]):
                    raise InvalidAmountError(
                        f"sub-{currency.value}-minor-unit precision not representable: {value!r}")
                frac = (frac + "0" * exp)[:exp]
                units += int(frac) if exp else 0
        except ValueError as exc:
            raise InvalidAmountError(f"invalid amount format: {value!r}") from exc
        return cls(units, currency)

    # -- predicates ---------------------------------------------------------

    def is_zero(self) -> bool:
        return self.cents == 0

    def is_positive(self) -> bool:
        return self.cents > 0

    # -- arithmetic (checked) ----------------------------------------------

    def _require_same_currency(self, other: "Money") -> None:
        if self.currency != other.currency:
            raise CurrencyMismatchError(f"{self.currency.value} != {other.currency.value}")

    def add(self, other: "Money") -> "Money":
        self._require_same_currency(other)
        return Money(_check_int64(self.cents + other.cents), self.currency)

    def sub(self, other: "Money") -> "Money":
        """Checked subtraction; going below zero is insufficient funds."""
        self._require_same_currency(other)
        result = self.cents - other.cents
        if result < 0:
            raise InsufficientFundsError(f"{self} - {other}")
        return Money(result, self.currency)

    def mul_int(self, factor: int) -> "Money":
        return Money(_check_int64(self.cents * factor), self.currency)

    def percent(self, percent: int) -> "Money":
        """percent% of the amount, truncated to whole cents (int64 math,
        matching the bonus engine's `amount * pct / 100` truncation at
        bonus_engine.go:467)."""
        return Money(_check_int64(self.cents * percent // 100), self.currency)

    def floordiv(self, divisor: int) -> "Money":
        if divisor <= 0:
            raise InvalidAmountError(f"divisor must be positive: {divisor}")
        return Money(self.cents // divisor, self.currency)

    def __add__(self, other: "Money") -> "Money":
        return self.add(other)

    def __sub__(self, other: "Money") -> "Money":
        return self.sub(other)

    # -- comparison ---------------------------------------------------------

    def __lt__(self, other: "Money") -> bool:
        self._require_same_currency(other)
        return self.cents < other.cents

    def __le__(self, other: "Money") -> bool:
        self._require_same_currency(other)
        return self.cents <= other.cents

    def __gt__(self, other: "Money") -> bool:
        self._require_same_currency(other)
        return self.cents > other.cents

    def __ge__(self, other: "Money") -> bool:
        self._require_same_currency(other)
        return self.cents >= other.cents

    # -- formatting ---------------------------------------------------------

    def _decimal_str(self) -> str:
        exp = self.exponent
        scale = 10**exp
        return f"{self.cents // scale}.{self.cents % scale:0{exp}d}"

    def __str__(self) -> str:
        return f"{self._decimal_str()} {self.currency.value}"

    def to_json(self) -> dict:
        return {"value": self._decimal_str(), "currency": self.currency.value}

    @classmethod
    def from_json(cls, obj: dict) -> "Money":
        return cls.parse(obj["value"], Currency(obj["currency"]))


def money_min(a: Money, b: Money) -> Money:
    return a if a < b else b


def money_max(a: Money, b: Money) -> Money:
    return a if a > b else b


MoneyLike = Union[Money, int]

"""A hand proto3 codec for the wallet.v1 messages (``proto/wallet/v1/wallet.proto``).

The port's counterpart of the generated ``wallet_pb2`` module of the JAX
package, without protobuf: the card's machine has none. It is built on the
schema primitives of ``serve/risk_codec.py`` (a message is a dict keyed by
field name; ``encode`` writes fields in number order and skips proto3
defaults; integers, negative ones included, are two's complement varints;
a sub-message that is not ``None`` is written even when empty, as protobuf
writes a set sub-message). ``TIMESTAMP`` is ``google.protobuf.Timestamp``.

Two things the generic schema cannot say are handled here:

- the ``identifier`` oneof of GetAccountRequest: a oneof member has
  presence, so ``decode_get_account`` returns which member was set (the
  last one on the wire, as protobuf's parser keeps), an empty string set
  explicitly included;
- ``timestamp(seconds)`` builds the sub-message the JAX service builds with
  ``Timestamp.FromSeconds(int(t))``, and ``timestamp_seconds`` reads one
  back with its sub-second part, as the JAX handler's ``_ts_to_float``.
"""

from __future__ import annotations

from igaming_platform_tpu_torch.serve.risk_codec import (  # noqa: F401 - the codec's surface
    BOOL,
    INT32,
    INT64,
    MAP,
    MESSAGE,
    STRING,
    TIMESTAMP,
    _fields,
    _read_varint,
    _skip,
    decode,
    encode,
)

WALLET_SERVICE = "wallet.v1.WalletService"

_MAP_ENTRY = _fields((1, "key", STRING), (2, "value", STRING))

ACCOUNT = _fields(
    (1, "id", STRING), (2, "player_id", STRING), (3, "currency", STRING),
    (4, "balance", INT64), (5, "bonus", INT64), (6, "status", STRING),
    (7, "created_at", MESSAGE, TIMESTAMP), (8, "updated_at", MESSAGE, TIMESTAMP),
)
TRANSACTION = _fields(
    (1, "id", STRING), (2, "account_id", STRING), (3, "idempotency_key", STRING),
    (4, "type", STRING), (5, "amount", INT64), (6, "balance_before", INT64),
    (7, "balance_after", INT64), (8, "status", STRING), (9, "reference", STRING),
    (10, "game_id", STRING), (11, "round_id", STRING), (12, "risk_score", INT32),
    (13, "created_at", MESSAGE, TIMESTAMP), (14, "completed_at", MESSAGE, TIMESTAMP),
)

CREATE_ACCOUNT_REQUEST = _fields((1, "player_id", STRING), (2, "currency", STRING))
CREATE_ACCOUNT_RESPONSE = _fields((1, "account", MESSAGE, ACCOUNT))
GET_ACCOUNT_RESPONSE = _fields((1, "account", MESSAGE, ACCOUNT))
GET_BALANCE_REQUEST = _fields((1, "account_id", STRING))
GET_BALANCE_RESPONSE = _fields(
    (1, "account_id", STRING), (2, "balance", INT64), (3, "bonus", INT64), (4, "total", INT64),
    (5, "withdrawable", INT64), (6, "currency", STRING),
)
DEPOSIT_REQUEST = _fields(
    (1, "account_id", STRING), (2, "amount", INT64), (3, "idempotency_key", STRING),
    (4, "payment_method", STRING), (5, "reference", STRING), (6, "ip_address", STRING),
    (7, "device_id", STRING), (8, "fingerprint", STRING),
)
DEPOSIT_RESPONSE = _fields(
    (1, "transaction", MESSAGE, TRANSACTION), (2, "new_balance", INT64),
    (3, "risk_score", INT32),
)
WITHDRAW_REQUEST = _fields(
    (1, "account_id", STRING), (2, "amount", INT64), (3, "idempotency_key", STRING),
    (4, "payout_method", STRING), (5, "payout_details", STRING), (6, "ip_address", STRING),
    (7, "device_id", STRING),
)
WITHDRAW_RESPONSE = _fields(
    (1, "transaction", MESSAGE, TRANSACTION), (2, "new_balance", INT64),
    (3, "risk_score", INT32), (4, "payout_status", STRING),
)
BET_REQUEST = _fields(
    (1, "account_id", STRING), (2, "amount", INT64), (3, "idempotency_key", STRING),
    (4, "game_id", STRING), (5, "round_id", STRING), (6, "game_category", STRING),
    (7, "ip_address", STRING), (8, "device_id", STRING), (9, "session_id", STRING),
)
BET_RESPONSE = _fields(
    (1, "transaction", MESSAGE, TRANSACTION), (2, "new_balance", INT64),
    (3, "risk_score", INT32), (4, "real_deducted", INT64), (5, "bonus_deducted", INT64),
)
WIN_REQUEST = _fields(
    (1, "account_id", STRING), (2, "amount", INT64), (3, "idempotency_key", STRING),
    (4, "game_id", STRING), (5, "round_id", STRING), (6, "bet_transaction_id", STRING),
    (7, "win_type", STRING), (8, "metadata", MAP, _MAP_ENTRY),
)
WIN_RESPONSE = _fields((1, "transaction", MESSAGE, TRANSACTION), (2, "new_balance", INT64))
REFUND_REQUEST = _fields(
    (1, "account_id", STRING), (2, "original_transaction_id", STRING),
    (3, "idempotency_key", STRING), (4, "reason", STRING),
)
REFUND_RESPONSE = _fields((1, "transaction", MESSAGE, TRANSACTION), (2, "new_balance", INT64))
GET_TRANSACTION_HISTORY_REQUEST = _fields(
    (1, "account_id", STRING), (2, "limit", INT32), (3, "offset", INT32),
    (4, "types", STRING, None, True), (5, "from", MESSAGE, TIMESTAMP),
    (6, "to", MESSAGE, TIMESTAMP), (7, "game_id", STRING),
)
GET_TRANSACTION_HISTORY_RESPONSE = _fields(
    (1, "transactions", MESSAGE, TRANSACTION, True), (2, "total", INT32), (3, "has_more", BOOL),
)
GET_TRANSACTION_REQUEST = _fields((1, "transaction_id", STRING))
GET_TRANSACTION_RESPONSE = _fields((1, "transaction", MESSAGE, TRANSACTION))

# The ten wallet.v1 methods: (request schema, response schema). GetAccount's
# request is the oneof, read by decode_get_account.
METHODS = {
    "CreateAccount": (CREATE_ACCOUNT_REQUEST, CREATE_ACCOUNT_RESPONSE),
    "GetAccount": (None, GET_ACCOUNT_RESPONSE),
    "GetBalance": (GET_BALANCE_REQUEST, GET_BALANCE_RESPONSE),
    "Deposit": (DEPOSIT_REQUEST, DEPOSIT_RESPONSE),
    "Withdraw": (WITHDRAW_REQUEST, WITHDRAW_RESPONSE),
    "Bet": (BET_REQUEST, BET_RESPONSE),
    "Win": (WIN_REQUEST, WIN_RESPONSE),
    "Refund": (REFUND_REQUEST, REFUND_RESPONSE),
    "GetTransaction": (GET_TRANSACTION_REQUEST, GET_TRANSACTION_RESPONSE),
    "GetTransactionHistory": (GET_TRANSACTION_HISTORY_REQUEST, GET_TRANSACTION_HISTORY_RESPONSE),
}
METHOD_NAMES = tuple(METHODS)

_GET_ACCOUNT_MEMBERS = {1: "account_id", 2: "player_id"}


def decode_get_account(buf: bytes) -> tuple[str | None, str]:
    """GetAccountRequest: (the ``identifier`` member set, or None, and its
    value). The last member on the wire wins; unknown fields are skipped."""
    which, value, pos, end = None, "", 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wire_type = tag >> 3, tag & 7
        if number in _GET_ACCOUNT_MEMBERS and wire_type == 2:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise ValueError("truncated length-delimited field")
            try:
                value = bytes(buf[pos:pos + n]).decode()
            except UnicodeDecodeError as exc:
                raise ValueError("GetAccountRequest: invalid UTF-8") from exc
            which = _GET_ACCOUNT_MEMBERS[number]
            pos += n
        else:
            pos = _skip(buf, pos, end, wire_type)
    return which, value


def timestamp(seconds: float) -> dict:
    """The Timestamp of ``Timestamp.FromSeconds(int(seconds))``."""
    return {"seconds": int(seconds), "nanos": 0}


def timestamp_seconds(ts: dict) -> float:
    """A decoded Timestamp as float epoch seconds, sub-second part kept."""
    return ts["seconds"] + ts["nanos"] / 1e9

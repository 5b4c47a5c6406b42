"""Dev/demo seed accounts.

The reference seeds three test accounts (one with VIP-scale balances)
straight into the database (deploy/init-db.sql:243-247 — raw INSERTs,
so the seeded rows have no transactions or ledger entries behind them).
Here the same fixture runs through the real service pipeline: accounts
are created and funded via WalletService, so every seeded balance is
backed by a transaction row and double-entry ledger entries and the
store passes reconciliation (`platform/reconcile.py`) from the first
sweep.

Idempotent: create_account replays on player_id, deposits replay on
fixed idempotency keys — running `make seed` twice changes nothing.

Usage (same DATABASE_URL contract as the wallet server):
    python -m igaming_platform_tpu_torch.platform.seed            # in-memory demo
    DATABASE_URL=sqlite://dev.db python -m igaming_platform_tpu_torch.platform.seed
    DATABASE_URL=postgres://... python -m igaming_platform_tpu_torch.platform.seed
"""

from __future__ import annotations

import os
import sys

# player_id -> (currency, opening balance in cents)
SEED_ACCOUNTS: dict[str, tuple[str, int]] = {
    "demo-player": ("USD", 75_000),       # $750 regular player
    "demo-vip": ("USD", 4_200_000),       # $42k VIP
    "demo-fresh": ("USD", 0),             # brand-new account, never funded
}


def seed(wallet) -> list[tuple[str, str, int]]:
    """Create/fund the fixture accounts through the service pipeline.
    Returns (player_id, account_id, total_balance) rows."""
    out = []
    for player_id, (currency, opening) in SEED_ACCOUNTS.items():
        account = wallet.create_account(player_id, currency=currency)
        if opening > 0:
            wallet.deposit(account.id, opening, f"seed-{player_id}",
                           reference="seed fixture")
        current = wallet.get_balance(account.id)
        out.append((player_id, account.id, current.balance + current.bonus))
    return out


def main() -> int:
    from igaming_platform_tpu_torch.platform.outbox import OutboxPublisher
    from igaming_platform_tpu_torch.platform.wallet import WalletService

    from igaming_platform_tpu_torch.platform.repository import SQLiteStore, store_from_url

    # EXACTLY the wallet server's DATABASE_URL dispatch (one shared
    # helper), so what seed writes is what the server will read.
    url = os.environ.get("DATABASE_URL", "")
    store = store_from_url(url)
    if store is None and url:
        # A typo'd scheme ('postgress://…') must not silently seed a
        # throwaway in-memory store and exit 0 — same fail-loudly policy
        # as WIRE_DTYPE in the scorer.
        print(f"error: unrecognized DATABASE_URL scheme "
              f"(want sqlite:// or postgres://)", file=sys.stderr)
        return 2
    if store is not None:
        # Redact userinfo — DATABASE_URL carries credentials and this
        # line lands in terminal scrollback and CI logs.
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        host = parts.hostname or ""
        label = f"{parts.scheme}://{host}{parts.path}" if parts.scheme else url
    else:
        store = SQLiteStore()  # throwaway demo run
        label = ":memory: (set DATABASE_URL=sqlite://… or postgres://… to persist)"
    wallet = WalletService(
        store.accounts, store.transactions, store.ledger,
        events=OutboxPublisher(store), audit=store.audit,
    )
    for player_id, account_id, total in seed(wallet):
        print(f"{player_id:12s}  {account_id}  balance={total}")
    print(f"seeded {len(SEED_ACCOUNTS)} accounts into {label}")
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ledger reconciliation sweep + balance snapshots.

The reference ships the pieces — `VerifyBalance` comparing the recorded
balance against the ledger-derived sum (postgres.go:371-390) and a
`BalanceSnapshot` audit type (domain/models.go:217-225) — but no job ever
runs them. Here the sweep is a real background job: every interval it
walks all accounts, records a snapshot per account, audits any
balance/ledger divergence, and exports the result as metrics. A
divergence can only arise from a bug or external mutation (the SQLite path
commits money ops atomically via unit_of_work), so the sweep is the
tripwire, not the fix.

The port's copy of ``igaming_platform_tpu/platform/reconcile.py``, with one
difference: over a ledger that reads every account's pair in one statement
(``balance_pairs``, the SQLite and Postgres stores' ledgers), the sweep takes
that snapshot instead of two reads an account in a unit of work of their own.
The report is the same; over the Postgres wire the sweep costs one round
trip, not three an account.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from igaming_platform_tpu_torch.platform.domain import BalanceSnapshot
from igaming_platform_tpu_torch.platform.repository import uow_of


@dataclass
class ReconciliationReport:
    checked: int = 0
    mismatched: int = 0
    run_at: float = 0.0
    duration_ms: float = 0.0
    mismatches: list[dict] = field(default_factory=list)
    snapshots: list[BalanceSnapshot] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "checked": self.checked,
            "mismatched": self.mismatched,
            "run_at": self.run_at,
            "duration_ms": round(self.duration_ms, 3),
            "mismatches": self.mismatches,
        }


class Reconciler:
    """Walks accounts, verifies balance == ledger sum, snapshots state.

    The ledger tracks every completed money movement (credits - debits),
    covering both real and bonus totals; the recorded total is
    balance + bonus.
    """

    def __init__(self, accounts, ledger, audit=None, metrics=None):
        self.accounts = accounts
        self.ledger = ledger
        self.audit = audit
        self.metrics = metrics
        self.last_report: ReconciliationReport | None = None

    def _read_pair(self, account_id: str):
        """Read (account, ledger-derived balance) as one consistent snapshot.

        The two reads must not interleave with a committing wallet op, or a
        perfectly healthy store reports a phantom mismatch. When the store
        exposes unit_of_work, reading inside it holds the store lock for
        both calls; otherwise the caller re-checks a mismatch once before
        believing it.
        """
        uow = uow_of(self.accounts)
        if uow is not None:
            with uow():
                return (
                    self.accounts.get_by_id(account_id),
                    self.ledger.get_account_balance(account_id),
                )
        return (
            self.accounts.get_by_id(account_id),
            self.ledger.get_account_balance(account_id),
        )

    def _pairs(self):
        """(account id, balance, bonus, ledger-derived balance) of every
        account: one snapshot where the ledger reads them all at once, else
        a consistent read pair an account."""
        if hasattr(self.ledger, "balance_pairs"):
            yield from self.ledger.balance_pairs()
            return
        for account_id in self.accounts.list_ids():
            acct, derived = self._read_pair(account_id)
            if derived != acct.balance + acct.bonus and uow_of(self.accounts) is None:
                # Torn-read defense, only for stores without unit_of_work
                # (a uow-backed read pair is already consistent): a wallet
                # op may have committed between the two reads above. An
                # observed mismatch must survive one re-read before it is
                # recorded as real.
                acct, derived = self._read_pair(account_id)
            yield account_id, acct.balance, acct.bonus, derived

    def run_once(self, keep_snapshots: bool = False) -> ReconciliationReport:
        start = time.monotonic()
        report = ReconciliationReport(run_at=time.time())
        for account_id, balance, bonus, derived in self._pairs():
            recorded = balance + bonus
            report.checked += 1
            if keep_snapshots:
                report.snapshots.append(BalanceSnapshot(
                    account_id=account_id,
                    balance=balance,
                    bonus=bonus,
                    snapshot_at=report.run_at,
                    tx_count=0,
                    total_debit=max(0, -derived),
                    total_credit=max(0, derived),
                ))
            if derived != recorded:
                report.mismatched += 1
                detail = {"account_id": account_id, "recorded": recorded, "ledger": derived}
                report.mismatches.append(detail)
                if self.audit is not None:
                    try:
                        self.audit("account", account_id, "reconciliation_mismatch",
                                   old=str(derived), new=str(recorded))
                    except Exception:  # noqa: BLE001
                        pass
        report.duration_ms = (time.monotonic() - start) * 1000.0
        if self.metrics is not None:
            self.metrics.reconciliation_checked.set(report.checked)
            self.metrics.reconciliation_mismatched.set(report.mismatched)
        self.last_report = report
        return report


class ReconciliationJob:
    """Periodic sweep thread (the cashback/expiry-sweep pattern)."""

    def __init__(self, reconciler: Reconciler, interval_s: float = 300.0):
        self.reconciler = reconciler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="reconciler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.reconciler.run_once()
            except Exception:  # noqa: BLE001 — sweep must not die
                pass
            self._stop.wait(self.interval_s)

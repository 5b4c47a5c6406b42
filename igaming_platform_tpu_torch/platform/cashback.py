"""Weekly cashback job — the loss-based bonus family the reference defers.

The reference's cashback rules return 0 from the award path with the note
"calculated on losses, handled separately" (bonus_engine.go:477-479) and no
separate handler exists. This job is that handler: compute each player's
net loss over a window from the wallet transaction history, apply the
cashback rule's percentage and cap, and credit the result as bonus balance
with the rule's wagering requirement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from igaming_platform_tpu_torch.core.enums import BonusType, TxStatus, TxType
from igaming_platform_tpu_torch.platform.bonus import BonusEngine
from igaming_platform_tpu_torch.platform.wallet import WalletService

WEEK_SECONDS = 7 * 86400


@dataclass
class CashbackResult:
    account_id: str
    losses: int
    cashback: int
    bonus_id: str | None


def weekly_losses(wallet: WalletService, account_id: str, now: float | None = None,
                  window_seconds: int = WEEK_SECONDS) -> int:
    """Net gaming loss = completed bets - wins over the window (>= 0)."""
    now = now or time.time()
    cutoff = now - window_seconds
    bets = wins = 0
    offset = 0
    while True:
        page = wallet.get_transaction_history(account_id, limit=100, offset=offset)
        if not page:
            break
        for tx in page:
            if tx.created_at < cutoff or tx.status != TxStatus.COMPLETED:
                continue
            if tx.type == TxType.BET:
                bets += tx.amount
            elif tx.type == TxType.WIN:
                wins += tx.amount
        if len(page) < 100 or page[-1].created_at < cutoff:
            break
        offset += 100
    return max(bets - wins, 0)


def run_cashback_job(
    wallet: WalletService,
    bonus_engine: BonusEngine,
    account_ids: list[str],
    rule_id: str = "weekly_cashback",
    now: float | None = None,
) -> list[CashbackResult]:
    """Compute and credit cashback for each account under ``rule_id``.

    Eligibility (conditions/schedule/one-time) is enforced through the
    normal award checks; accounts with zero computed cashback are skipped.
    """
    rule = bonus_engine.get_rule(rule_id)
    if rule is None or rule.type != BonusType.CASHBACK:
        raise ValueError(f"not a cashback rule: {rule_id}")

    results = []
    for account_id in account_ids:
        losses = weekly_losses(wallet, account_id, now)
        amount = bonus_engine.calculate_cashback(rule, losses)
        if amount <= 0:
            results.append(CashbackResult(account_id, losses, 0, None))
            continue
        # Route through the award pipeline as a fixed grant so abuse gates,
        # schedules and conditions still apply.
        from igaming_platform_tpu_torch.platform.bonus import PlayerBonus, BonusStatus
        from igaming_platform_tpu_torch.platform.domain import new_id

        player = bonus_engine.player_data(account_id) if bonus_engine.player_data else None
        if player is not None and not bonus_engine._check_conditions(rule, player):
            results.append(CashbackResult(account_id, losses, 0, None))
            continue
        if not bonus_engine._check_schedule(rule):
            results.append(CashbackResult(account_id, losses, 0, None))
            continue

        now_ts = bonus_engine.now_fn()
        bonus = PlayerBonus(
            id=new_id(),
            account_id=account_id,
            rule_id=rule.id,
            type=rule.type,
            status=BonusStatus.ACTIVE,
            bonus_amount=amount,
            wagering_required=amount * rule.wagering_multiplier,
            awarded_at=now_ts,
            expires_at=now_ts + rule.expiry_days * 86400,
        )
        bonus_engine.repo.create(bonus)
        wallet.grant_bonus(account_id, amount, f"cashback:{bonus.id}", rule_id=rule.id)
        results.append(CashbackResult(account_id, losses, amount, bonus.id))
    return results

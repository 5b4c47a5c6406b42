"""Host platform: wallet, bonus engine, repositories, app composition (the
port's copies of ``igaming_platform_tpu/platform``'s pure-Python modules, and
its own single-binary app over the scoring engine)."""

from igaming_platform_tpu_torch.platform.bonus import BonusEngine, BonusRule, load_rules
from igaming_platform_tpu_torch.platform.domain import Account, LedgerEntry, Transaction
from igaming_platform_tpu_torch.platform.wallet import WalletConfig, WalletService

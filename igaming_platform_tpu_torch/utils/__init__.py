"""Utilities of the PyTorch port: structured logging."""

from igaming_platform_tpu_torch.utils.logging import JSONFormatter, kv, log_context, setup_logging

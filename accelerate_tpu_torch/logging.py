"""Rank-aware logging.

Port of :mod:`accelerate_tpu.logging`: a ``logging`` adapter that gates
records on ``main_process_only`` / per-process emission and supports
``in_order`` sequential printing across processes, plus ``warning_once``.
The process state is the port's own :class:`~.state.PartialState`; before
anything made one, every record passes without making one (which would
claim the card and join the process group).
"""

from __future__ import annotations

import logging
import os
from typing import Optional


class MultiProcessAdapter(logging.LoggerAdapter):
    """The reference's ``MultiProcessAdapter``."""

    # (logger name, message) pairs already emitted via warning_once — module
    # level so every adapter for the same underlying logger dedupes together
    # (get_logger builds a fresh adapter per call).
    _warned_once = set()

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        from .state import PartialState

        if not main_process_only or not PartialState._shared_state.get("_initialized"):
            return True
        return PartialState().is_main_process

    def log(self, level, msg, *args, **kwargs):
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if self.isEnabledFor(level):
            if self._should_log(main_process_only):
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)
            elif in_order:
                from .state import PartialState

                state = PartialState()
                for i in range(state.num_processes):
                    if i == state.process_index:
                        msg, kwargs = self.process(msg, kwargs)
                        self.logger.log(level, msg, *args, **kwargs)
                    state.wait_for_everyone()

    def warning_once(self, msg, *args, **kwargs):
        """Emit a given warning only once per process.

        Dedupes by ``(logger name, message string)`` rather than
        ``functools.lru_cache``: the cache keyed on ``self`` (re-warning per
        adapter instance, and pinning every adapter alive) and raised
        ``TypeError`` on unhashable kwargs like ``extra={...}``.
        """
        key = (self.logger.name, str(msg))
        if key not in MultiProcessAdapter._warned_once:
            MultiProcessAdapter._warned_once.add(key)
            self.warning(msg, *args, **kwargs)


def get_logger(name: str, log_level: Optional[str] = None) -> MultiProcessAdapter:
    """The reference's ``get_logger``; honors ``ACCELERATE_LOG_LEVEL``."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})

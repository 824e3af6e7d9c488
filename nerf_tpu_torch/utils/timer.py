"""Wall-clock helpers (the console format of ``nerf_tpu.utils.timer``)."""

from __future__ import annotations

import datetime


def format_elapsed_time(start_time: datetime.datetime) -> str:
    """Elapsed time since ``start_time`` as HH:MM:SS."""
    total_seconds = int((datetime.datetime.now() - start_time).total_seconds())
    return "{:02d}:{:02d}:{:02d}".format(
        total_seconds // 3600, (total_seconds % 3600) // 60, total_seconds % 60
    )

"""Console and memory diagnostics (port of ``baddiffusion_tpu/utils/logging.py``).

``Log`` prints ANSI-coloured lines; ``MemoryLog`` appends timestamped host RAM
and per-GPU memory lines to a file, reading the GPU side from
``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import datetime
import os
import time

import torch


class Log:
    """ANSI-coloured log helpers; each returns the line it printed."""

    CRITICAL = "\033[91m\033[1m"
    ERROR = "\033[91m"
    WARNING = "\033[93m"
    INFO = "\033[92m"
    ENDC = "\033[0m"

    @staticmethod
    def _emit(colour: str, msg: str) -> str:
        out = f"{colour}{msg}{Log.ENDC}"
        print(out)
        return out

    @staticmethod
    def critical(msg: str) -> str:
        return Log._emit(Log.CRITICAL, msg)

    @staticmethod
    def error(msg: str) -> str:
        return Log._emit(Log.ERROR, msg)

    @staticmethod
    def warning(msg: str) -> str:
        return Log._emit(Log.WARNING, msg)

    @staticmethod
    def info(msg: str) -> str:
        return Log._emit(Log.INFO, msg)


class MemoryLog:
    """Appends ``<time> (+<s>) RAM: <%> | cuda:<i>: <%> ...`` lines to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()

    @staticmethod
    def _host_ram_line() -> str:
        try:
            import psutil
        except ImportError:
            return "RAM: n/a"
        return f"RAM: {psutil.virtual_memory().percent}%"

    @staticmethod
    def _device_lines() -> str:
        if not torch.cuda.is_available():
            return "devices: n/a"
        parts = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            parts.append(f"cuda:{i}: {100.0 * (total - free) / max(total, 1):.1f}%")
        return " | ".join(parts)

    def append(self, note: str = "") -> None:
        stamp = datetime.datetime.now().isoformat(timespec="seconds")
        line = f"{stamp} (+{time.time() - self._t0:.1f}s) {self._host_ram_line()} | {self._device_lines()}"
        if note:
            line += f" | {note}"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")

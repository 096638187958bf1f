"""CF01 fixture, leg (b): a Config key that reaches no consumer. Linted
beside cf01_good.py, which reads read_buffer_size_bytes and
trace_max_length directly and flush_timeout through its property;
dead_key is read only by this module's own validation."""
from dataclasses import dataclass


@dataclass
class Config:
    read_buffer_size_bytes: int = 0
    trace_max_length: int = 8192
    flush_timeout: str = "10s"
    dead_key: int = 0                                            # CF01

    @property
    def flush_timeout_seconds(self) -> float:
        return float(self.flush_timeout.rstrip("s"))


def _validate(cfg: Config) -> None:
    if cfg.dead_key < 0 or cfg.read_buffer_size_bytes < 0:
        raise ValueError("negative")

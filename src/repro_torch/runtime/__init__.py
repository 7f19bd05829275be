"""Runtime subsystems of the port: checkpointing, elastic execution, the
fault harness, telemetry.

Submodules load lazily (PEP 562): ``core.lower`` and the other pipeline
modules import :mod:`repro_torch.runtime.telemetry` at module scope, and an
eager ``from . import elastic`` here would pull ``core`` back in while
``core.lower`` is still initializing.
"""
import importlib

__all__ = ["checkpoint", "elastic", "fault", "telemetry"]


def __getattr__(name):
    if name in __all__:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + __all__)

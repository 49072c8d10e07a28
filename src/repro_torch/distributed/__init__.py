"""Distributed pieces of the port that one device needs: the straggler
watchdog of the training loop."""
from repro_torch.distributed.fault import StragglerWatchdog

__all__ = ["StragglerWatchdog"]

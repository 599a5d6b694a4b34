"""A stand-in for the card in the CPU tests: the run's device is the
CPU, and its trace takes the host's aten ops for the device's records,
so that the traced path's arithmetic and readers run as they do on the
card. No number it gives is ever reported as the card's."""
import torch

from cfdbench import run, trace


class HostCard(run.Card):
    platform = "cpu"

    def __init__(self, chips: int = 1):
        self.device = torch.device("cpu")

    def kind(self) -> str:
        return "cpu"

    def sync(self) -> None:
        pass

    def memory_peak(self) -> int:
        return 0

    def release(self) -> None:
        pass

    def trace(self, fn):
        from torch.profiler import ProfilerActivity
        events, wall = trace.profile(fn, self.sync, [ProfilerActivity.CPU])
        return trace.summarise(
            events, device=lambda e: e.name.startswith("aten::")), wall

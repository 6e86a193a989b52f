"""Running-average meters and progress printing (the reference's
AverageClass / ProgressMeter)."""
from __future__ import annotations

from torch import nn


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} (avg:{avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressPrinter:
    def __init__(self, num_batches: int, *meters: AverageMeter,
                 prefix: str = ""):
        nd = len(str(num_batches))
        self._fmt = "[{:" + str(nd) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def print(self, batch: int) -> None:
        entries = [self.prefix + self._fmt.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))


def model_summary(model: nn.Module) -> str:
    """Parameter-count summary per top-level module (the reference prints
    a torchinfo summary at startup)."""
    lines = ["=" * 56, f"{'module':<38}{'params':>16}", "-" * 56]
    total = 0
    for name, child in sorted(model.named_children()):
        n = sum(p.numel() for p in child.parameters())
        total += n
        lines.append(f"{name:<38}{n:>16,}")
    lines += ["-" * 56, f"{'TOTAL':<38}{total:>16,}", "=" * 56]
    return "\n".join(lines)

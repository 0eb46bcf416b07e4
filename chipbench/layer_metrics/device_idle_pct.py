"""``device_idle_pct``: the share of the measured loop in which no
kernel, copy or fill ran on the card (``torch.profiler``, CUDA activity
only): how far the host holds the card back."""

from chipbench.trace import busy_seconds


def read(rec):
    return 100.0 * (1.0 - busy_seconds(rec) / (rec.t_close - rec.t_open))

"""The file loop's host/device share controller.

Both file loops (mapping/mapper.py `_map_file_native` and
`_map_file_frag`) send a share of each batch's eligible reads to the
device front and map the rest on the host.  A ShareSplit holds that
share and the costs it is set from, and decides it once for both: the
loops measure, choose which reads go where and call it for the rest.
Per batch, in this order: `plan`, then `host_cost` and `device_cost`
for what the batch measured, then `end_batch`.

The policy: the host takes t_dev / (t_dev + t_host) of the eligible
reads, so that both sides finish together, at most 0.9 of them; a
target over 0.95 means the device does not pay (share 1.0), and two
such targets in a row collapse the split to the host, as does one host
thread mapping faster than the blend has for three batch cycles.
Collapsed, the host maps every read and every probe_interval()-th
batch probes the device with a quarter batch; two warm probes in a row
at a target <= 0.45 reopen the split."""
from __future__ import annotations

import time

# the clock of the blended rate (a test replaces it)
_clock = time.perf_counter


def _ema(prev, x, alpha=0.4):
    """Exponential moving average with None start."""
    return x if prev is None else prev + alpha * (x - prev)


class ShareSplit:
    """The split's learned state.  `share`: the host's fraction of the
    eligible reads; t_host, t_host_cpu, t_dev: seconds a read on the
    host (wall, and CPU time free of contention) and on the device path
    (its host work included), None until measured.  A caller pins the
    share by constructing it, e.g. ShareSplit(share=0.0) sends every
    eligible read to the device; the pin holds while the host measures
    no cost, since the share moves only once both costs are known."""

    def __init__(self, share: float = 0.35, collapsed: bool = False):
        self.share = 1.0 if collapsed else share
        self.collapsed = collapsed
        self.t_host = self.t_host_cpu = self.t_dev = None
        self.rate_mix = None        # blended reads a second, an average
        self.nb_mix = 0             # batch cycles in rate_mix
        self.t_last = None          # the last open batch's end
        self.hi_tgt = 0             # targets over 0.95 in a row
        self.reopen = 0             # warm probes in a row at <= 0.45
        self.nb = 0                 # collapsed batches, for the cadence
        self._probed = False        # this batch took a warm device cost

    def probe_interval(self) -> int:
        """Batches between device probes while the host owns the work.

        A probe maps ~a quarter batch through the device path, costing
        ~(n/4)*t_dev against interval*n*t_host of host work; sizing the
        interval to ~5x the cost ratio caps probe overhead at ~5%
        regardless of workload."""
        if not self.t_dev or not self.t_host:
            return 8
        return max(8, min(256, int(5.0 * self.t_dev / self.t_host)))

    def plan(self, n: int, n_elig: int) -> int:
        """A batch of n reads, n_elig of them eligible for the device:
        how many eligible reads go to the device.  Collapsed, that is 0,
        or a probe's reads every probe_interval()-th batch."""
        if not self.collapsed:
            return n_elig - int(n_elig * self.share)
        self.nb += 1
        if self.nb % self.probe_interval():
            return 0
        return min(n_elig, max(8, n // 4))

    def host_cost(self, wall: float, cpu: float, n: int) -> None:
        """The host share mapped n reads in `wall` s (the loop's measure
        of a read's host cost) and `cpu` s of CPU time."""
        if n:
            self.t_host = _ema(self.t_host, wall / n)
            self.t_host_cpu = _ema(self.t_host_cpu, cpu / n)

    def device_cost(self, seconds: float, n: int, cold: bool) -> None:
        """The device path took `seconds` of host time for n reads;
        `cold`: it built the kernels or ran a bucket for the first
        time, which is not the steady cost."""
        if n and not cold:
            self.t_dev = _ema(self.t_dev, seconds / n)
            self._probed = True

    def end_batch(self, n: int) -> None:
        """A batch of n reads has ended: open, the blended rate of the
        batch cycle, then the share, collapsed where the device does not
        pay; collapsed, the reopen test on a warm probe."""
        probed, self._probed = self._probed, False
        if self.collapsed:
            if not (probed and self.t_host):
                return
            # hysteresis: one probe biased low (the device ran during
            # the host call) must not reopen the split; the share stays
            # 1.0 for the next batch, which times the cycle afresh
            if self.t_dev / (self.t_dev + self.t_host) > 0.45:
                self.reopen = 0
                return
            self.reopen += 1
            if self.reopen >= 2:
                self.collapsed = False
                self.rate_mix, self.nb_mix, self.reopen = None, 0, 0
            return
        # blended throughput over the batch cycle (every read over the
        # wall since the previous batch's end); build-length cycles are
        # skipped
        now = _clock()
        t_last, self.t_last = self.t_last, now
        if t_last is not None and n > 0 and self.share < 1.0:
            cyc = now - t_last
            if cyc / n < 0.05:
                self.rate_mix = _ema(self.rate_mix, n / cyc)
                self.nb_mix += 1
        if not (self.t_dev and self.t_host):
            return
        tgt = self.t_dev / (self.t_dev + self.t_host)
        share = 1.0 if tgt > 0.95 else min(0.9, max(0.0, tgt))
        # a device read costing over 19x a host read twice in a row does
        # not pay: collapse without waiting for the blended rate
        self.hi_tgt = self.hi_tgt + 1 if tgt > 0.95 else 0
        if self.hi_tgt >= 2:
            self.collapsed = True
            share = 1.0
        elif (share < 1.0 and self.rate_mix and self.nb_mix >= 3
              and self.t_host_cpu
              and 1.0 / self.t_host_cpu > 1.08 * self.rate_mix):
            # the blend runs slower than one host thread alone: the host
            # and the device path's host work contend for the cores
            self.collapsed = True
            share = 1.0
        self.share = share

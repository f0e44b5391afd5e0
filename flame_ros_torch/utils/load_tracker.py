"""System/process load monitoring from /proc.

Capability parity with flame::utils::LoadTracker (reference usage:
src/flame_nodelet.cc:153,592-606 — cpu/mem/swap loads for both the system
and the engine process, integrated over `load_integration_factor` frames
because /proc timing resolution is one jiffy).
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class Load:
    cpu: float = 0.0   # Percent of one core (process) or of all cores (system).
    mem: float = 0.0   # MB resident (process) / MB used (system).
    swap: float = 0.0  # MB.


@dataclass
class LoadSnapshot:
    max_load: Load
    sys_load: Load
    pid_load: Load


def _read_first_line(path: str) -> str:
    with open(path) as f:
        return f.readline()


class LoadTracker:
    def __init__(self, pid: int | None = None):
        self.pid = pid if pid is not None else os.getpid()
        self._ncpu = os.cpu_count() or 1
        self._clk = os.sysconf("SC_CLK_TCK")
        self._page_mb = os.sysconf("SC_PAGE_SIZE") / 1e6
        self._last_sys = self._read_sys_cpu()
        self._last_pid = self._read_pid_cpu()
        self._last_time = self._read_sys_cpu_total()

    def _read_sys_cpu(self):
        parts = _read_first_line("/proc/stat").split()[1:]
        vals = [int(x) for x in parts[:8]]
        idle = vals[3] + vals[4]
        return sum(vals), idle

    def _read_sys_cpu_total(self):
        return self._read_sys_cpu()[0]

    def _read_pid_cpu(self):
        with open(f"/proc/{self.pid}/stat") as f:
            parts = f.read().split()
        return int(parts[13]) + int(parts[14])  # utime + stime

    def _mem_info(self):
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.split()[0])  # kB
        return info

    def get(self) -> LoadSnapshot:
        sys_total, sys_idle = self._read_sys_cpu()
        pid_ticks = self._read_pid_cpu()
        d_total = max(sys_total - self._last_sys[0], 1)
        d_idle = sys_idle - self._last_sys[1]
        d_pid = pid_ticks - self._last_pid
        self._last_sys = (sys_total, sys_idle)
        self._last_pid = pid_ticks

        mem = self._mem_info()
        mem_total_mb = mem.get("MemTotal", 0) / 1e3
        mem_used_mb = (mem.get("MemTotal", 0) - mem.get("MemAvailable", 0)) / 1e3
        swap_total_mb = mem.get("SwapTotal", 0) / 1e3
        swap_used_mb = (mem.get("SwapTotal", 0) - mem.get("SwapFree", 0)) / 1e3

        try:
            with open(f"/proc/{self.pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
            pid_mem_mb = rss_pages * self._page_mb
        except OSError:
            pid_mem_mb = 0.0

        return LoadSnapshot(
            max_load=Load(cpu=float(self._ncpu), mem=mem_total_mb,
                          swap=swap_total_mb),
            sys_load=Load(cpu=100.0 * (d_total - d_idle) / d_total * self._ncpu,
                          mem=mem_used_mb, swap=swap_used_mb),
            pid_load=Load(cpu=100.0 * d_pid / d_total * self._ncpu,
                          mem=pid_mem_mb, swap=0.0),
        )

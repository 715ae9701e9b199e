"""The host a run sits on: facts read around the window.

None of this is a metric.  The facts go to standard error before the
result line, so that a run that reads slow can be told apart from one that
reads fast by where it ran: the CPUs it may use and the one it ended on, the
NUMA nodes of those CPUs and of its pages, the card's own node, the
cgroup's CPU quota and throttling, pressure stall times, the hypervisor's
steal time, transparent huge pages, torch's thread count, the process's
threads and CPU seconds, and a fixed probe of the host's speed (one 256 MiB
copy, one pure-Python loop) read before and after the window.  A file that
is not there reads "absent".
"""

import os
import resource
import time
from pathlib import Path

import numpy as np

ABSENT = "absent"
PROBE_BYTES = 256 * 2**20
PROBE_LOOP = 1_000_000


def read_text(path) -> str | None:
    try:
        return Path(path).read_text()
    except OSError:
        return None


def parse_cpulist(text: str) -> set:
    """'0-3,8,10-11' -> {0, 1, 2, 3, 8, 10, 11}."""
    out = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def format_cpulist(cpus) -> str:
    cpus, runs = sorted(cpus), []
    for c in cpus:
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


def node_cpus(root: str = "/") -> dict:
    """{NUMA node: its CPUs} from sysfs; {} where sysfs shows no nodes."""
    out = {}
    for d in sorted(Path(root, "sys/devices/system/node").glob("node[0-9]*")):
        text = read_text(d / "cpulist")
        if text is not None:
            out[int(d.name[4:])] = parse_cpulist(text)
    return out


def card_pci(device_index: int = 0) -> str | None:
    """The card's PCI address, '0000:1b:00.0', from torch's properties."""
    import torch

    p = torch.cuda.get_device_properties(device_index)
    bus = getattr(p, "pci_bus_id", None)
    if bus is None:
        return None
    return f"{getattr(p, 'pci_domain_id', 0):04x}:{bus:02x}:{getattr(p, 'pci_device_id', 0):02x}.0"


def card_node(pci: str | None, root: str = "/") -> tuple:
    """(the card's NUMA node or None, its local CPUs or None), from sysfs.
    A node of -1 (the firmware gives none) reads None."""
    if pci is None:
        return None, None
    d = Path(root, "sys/bus/pci/devices", pci.lower())
    node = read_text(d / "numa_node")
    local = read_text(d / "local_cpulist")
    n = int(node) if node is not None and node.strip().lstrip("-").isdigit() else None
    return (n if n is not None and n >= 0 else None), (parse_cpulist(local) if local is not None else None)


def cgroup_dir(root: str = "/") -> Path:
    """The cgroup (v2) directory of this process."""
    text = read_text(Path(root, "proc/self/cgroup")) or ""
    for line in text.splitlines():
        if line.startswith("0::"):
            return Path(root, "sys/fs/cgroup", line[3:].lstrip("/"))
    return Path(root, "sys/fs/cgroup")


def cpu_quota(cg: Path) -> float | None:
    """CPUs that cpu.max grants (quota / period); None where unlimited or absent."""
    text = read_text(cg / "cpu.max")
    if text is None:
        return None
    f = text.split()
    if len(f) < 2 or f[0] == "max":
        return None
    return int(f[0]) / int(f[1])


def cpu_stat(cg: Path) -> dict | None:
    text = read_text(cg / "cpu.stat")
    if text is None:
        return None
    kv = dict(line.split() for line in text.splitlines() if len(line.split()) == 2)
    return {k: int(kv[k]) for k in ("nr_periods", "nr_throttled", "throttled_usec") if k in kv}


def pressure(kind: str, root: str = "/") -> dict | None:
    """{'some': total us, 'full': total us} of /proc/pressure/<kind>."""
    text = read_text(Path(root, "proc/pressure", kind))
    if text is None:
        return None
    out = {}
    for line in text.splitlines():
        f = line.split()
        tot = [x for x in f[1:] if x.startswith("total=")]
        if f and tot:
            out[f[0]] = int(tot[0][6:])
    return out


def steal_ticks(root: str = "/") -> int | None:
    """The whole machine's steal time (/proc/stat, clock ticks): time a
    hypervisor ran someone else on these CPUs."""
    text = read_text(Path(root, "proc/stat"))
    if text is None:
        return None
    f = text.splitlines()[0].split()
    return int(f[8]) if f[0] == "cpu" and len(f) > 8 else None


def last_cpu(root: str = "/") -> int | None:
    """The CPU this process last ran on (/proc/self/stat, field 39)."""
    text = read_text(Path(root, "proc/self/stat"))
    if text is None:
        return None
    return int(text.rsplit(")", 1)[1].split()[36])


def thp(root: str = "/") -> dict:
    """The transparent huge page setting and this process's huge pages (kB)."""
    mode = read_text(Path(root, "sys/kernel/mm/transparent_hugepage/enabled"))
    roll = read_text(Path(root, "proc/self/smaps_rollup")) or ""
    anon = [int(line.split()[1]) for line in roll.splitlines() if line.startswith("AnonHugePages:")]
    rss = [int(line.split()[1]) for line in roll.splitlines() if line.startswith("Rss:")]
    return {"thp_mode": mode.strip() if mode else ABSENT, "anon_huge_kB": anon[0] if anon else ABSENT,
            "rss_kB": rss[0] if rss else ABSENT}


def numa_pages(root: str = "/") -> dict | None:
    """{node: pages} of this process's mappings (/proc/self/numa_maps)."""
    text = read_text(Path(root, "proc/self/numa_maps"))
    if text is None:
        return None
    out: dict = {}
    for line in text.splitlines():
        for tok in line.split():
            if tok[:1] == "N" and "=" in tok and tok[1:].split("=")[0].isdigit():
                n, c = tok[1:].split("=")
                out[int(n)] = out.get(int(n), 0) + int(c)
    return out


def threads(root: str = "/") -> int | None:
    """The threads of this process (/proc/self/status)."""
    text = read_text(Path(root, "proc/self/status")) or ""
    got = [int(line.split()[1]) for line in text.splitlines() if line.startswith("Threads:")]
    return got[0] if got else None


def cpu_seconds() -> float:
    """User and system CPU seconds of every thread of this process so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def probe() -> dict:
    """The host's speed now: GB/s of one 256 MiB np.copyto (both buffers
    touched first) and microseconds of a fixed pure-Python loop."""
    src = np.ones(PROBE_BYTES, np.uint8)
    dst = np.zeros_like(src)
    np.copyto(dst, src)
    t0 = time.perf_counter()
    np.copyto(dst, src)
    copy_s = time.perf_counter() - t0
    del src, dst
    t0 = time.perf_counter()
    s = 0
    for i in range(PROBE_LOOP):
        s += i & 7
    loop_s = time.perf_counter() - t0
    return {"copy_GBps": PROBE_BYTES / copy_s / 1e9, "py_loop_us": 1e6 * loop_s}


def _or_absent(v):
    return ABSENT if v is None else v


class Facts:
    """The facts of one run: `read_static()` once, `snapshot()` before and after
    the window, `report()` the lines for standard error."""

    def __init__(self, root: str = "/"):
        self.root = root
        self.cg = cgroup_dir(root)
        self.static: dict = {}
        self.snaps: list = []

    def read_static(self, card_index: int | None = 0) -> None:
        nodes = node_cpus(self.root)
        allowed = os.sched_getaffinity(0)
        try:
            pci = card_pci(card_index) if card_index is not None else None
        except (RuntimeError, AssertionError):
            pci = None
        node, local = card_node(pci, self.root)
        import torch

        self.static = {
            "cpus_allowed": format_cpulist(allowed),
            "cpu_nodes": {n: format_cpulist(c & allowed) for n, c in nodes.items() if c & allowed} or ABSENT,
            "card_pci": _or_absent(pci),
            "card_node": _or_absent(node),
            "card_local_cpus": ABSENT if local is None else format_cpulist(local),
            "cpu_max": (read_text(self.cg / "cpu.max") or ABSENT).strip(),
            "quota_cpus": _or_absent(cpu_quota(self.cg)),
            "torch_threads": torch.get_num_threads(),
        }

    def snapshot(self, label: str, with_probe: bool = True) -> None:
        snap = {"label": label, "t": time.perf_counter(), "cpu_s": cpu_seconds(),
                "threads": _or_absent(threads(self.root)), "cpu": _or_absent(last_cpu(self.root)),
                "cpu_stat": _or_absent(cpu_stat(self.cg)), "psi_cpu": _or_absent(pressure("cpu", self.root)),
                "psi_memory": _or_absent(pressure("memory", self.root)), "steal_ticks": _or_absent(steal_ticks(self.root)),
                "numa_pages": _or_absent(numa_pages(self.root)), **thp(self.root)}
        if with_probe:
            snap.update(probe())
        self.snaps.append(snap)

    def deltas(self) -> dict:
        """What changed between the first and the last snapshot."""
        if len(self.snaps) < 2:
            return {}
        a, b = self.snaps[0], self.snaps[-1]
        out = {"seconds": b["t"] - a["t"], "cpu_s": b["cpu_s"] - a["cpu_s"]}
        if isinstance(a["cpu_stat"], dict) and isinstance(b["cpu_stat"], dict):
            out.update({k: b["cpu_stat"][k] - a["cpu_stat"].get(k, 0) for k in b["cpu_stat"]})
        for k in ("psi_cpu", "psi_memory"):
            if isinstance(a[k], dict) and isinstance(b[k], dict):
                out[k + "_us"] = {s: b[k][s] - a[k].get(s, 0) for s in b[k]}
        if isinstance(a["steal_ticks"], int) and isinstance(b["steal_ticks"], int):
            out["steal_ticks"] = b["steal_ticks"] - a["steal_ticks"]
        return out

    def report(self) -> list:
        import json

        lines = ["rqbench host " + json.dumps(self.static)]
        lines += ["rqbench host " + json.dumps(s) for s in self.snaps]
        lines.append("rqbench host " + json.dumps({"label": "window_delta", **self.deltas()}))
        return lines

"""The host facts: a missing sysfs, cgroup or proc file reads "absent" and
fails nothing; what is there is parsed."""

from rqbench import hostinfo


def test_cpulists_round_trip():
    assert hostinfo.parse_cpulist("0-3,8,10-11\n") == {0, 1, 2, 3, 8, 10, 11}
    assert hostinfo.format_cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"
    assert hostinfo.parse_cpulist("") == set()


def test_every_reader_says_absent_on_an_empty_root(tmp_path):
    root = str(tmp_path)
    assert hostinfo.node_cpus(root) == {}
    assert hostinfo.card_node("0000:1b:00.0", root) == (None, None)
    assert hostinfo.card_node(None, root) == (None, None)
    cg = hostinfo.cgroup_dir(root)
    assert hostinfo.cpu_quota(cg) is None and hostinfo.cpu_stat(cg) is None
    assert hostinfo.pressure("cpu", root) is None and hostinfo.steal_ticks(root) is None
    assert hostinfo.last_cpu(root) is None and hostinfo.numa_pages(root) is None and hostinfo.threads(root) is None
    assert hostinfo.thp(root) == {"thp_mode": "absent", "anon_huge_kB": "absent", "rss_kB": "absent"}
    f = hostinfo.Facts(root)
    f.read_static(None)
    f.snapshot("before", with_probe=False)
    f.snapshot("after", with_probe=False)
    assert f.static["card_node"] == "absent" and f.static["cpu_max"] == "absent"
    assert f.static["cpu_nodes"] == "absent" and f.static["quota_cpus"] == "absent"
    assert all(line.startswith("rqbench host {") for line in f.report())
    assert set(f.deltas()) == {"seconds", "cpu_s"}


def _fake_root(tmp_path, node="1", local="4-7", cpu_max="200000 100000"):
    for n, cpus in ((0, "0-3"), (1, "4-7")):
        d = tmp_path / f"sys/devices/system/node/node{n}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpus + "\n")
    dev = tmp_path / "sys/bus/pci/devices/0000:1b:00.0"
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text(node + "\n")
    (dev / "local_cpulist").write_text(local + "\n")
    (tmp_path / "proc/self").mkdir(parents=True)
    (tmp_path / "proc/self/cgroup").write_text("0::/job\n")
    cg = tmp_path / "sys/fs/cgroup/job"
    cg.mkdir(parents=True)
    (cg / "cpu.max").write_text(cpu_max + "\n")
    (cg / "cpu.stat").write_text("usage_usec 10\nnr_periods 5\nnr_throttled 2\nthrottled_usec 300\n")
    (tmp_path / "proc/pressure").mkdir(parents=True)
    (tmp_path / "proc/pressure/cpu").write_text("some avg10=0.00 avg60=0.00 avg300=0.00 total=123\n")
    (tmp_path / "proc/stat").write_text("cpu  1 2 3 4 5 6 7 99 0 0\n")
    (tmp_path / "proc/self/stat").write_text("1 (py thon) R" + " 0" * 35 + " 6 0\n")
    (tmp_path / "proc/self/status").write_text("Name:\tpython3\nThreads:\t12\n")
    (tmp_path / "proc/self/numa_maps").write_text("7f0 default anon=3 N0=2 N1=1\n7f1 bind:1 N1=5 kernelpagesize_kB=4\n")
    return str(tmp_path)


def test_readers_parse_what_is_there(tmp_path):
    root = _fake_root(tmp_path)
    assert hostinfo.node_cpus(root) == {0: {0, 1, 2, 3}, 1: {4, 5, 6, 7}}
    assert hostinfo.card_node("0000:1B:00.0", root) == (1, {4, 5, 6, 7})
    cg = hostinfo.cgroup_dir(root)
    assert cg.name == "job" and hostinfo.cpu_quota(cg) == 2.0
    assert hostinfo.cpu_stat(cg) == {"nr_periods": 5, "nr_throttled": 2, "throttled_usec": 300}
    assert hostinfo.pressure("cpu", root) == {"some": 123}
    assert hostinfo.steal_ticks(root) == 99 and hostinfo.last_cpu(root) == 6
    assert hostinfo.numa_pages(root) == {0: 2, 1: 6} and hostinfo.threads(root) == 12


def test_a_card_without_a_node_reads_none(tmp_path):
    root = _fake_root(tmp_path, node="-1")
    assert hostinfo.card_node("0000:1b:00.0", root)[0] is None
    assert hostinfo.cpu_quota(hostinfo.cgroup_dir(_fake_root(tmp_path / "b", cpu_max="max 100000"))) is None


def test_the_probe_reads_positive_numbers(monkeypatch):
    monkeypatch.setattr(hostinfo, "PROBE_BYTES", 1 << 20)
    monkeypatch.setattr(hostinfo, "PROBE_LOOP", 1000)
    p = hostinfo.probe()
    assert p["copy_GBps"] > 0 and p["py_loop_us"] > 0

"""The port's command-line slice (`backup`, `fix`, `compact`, `export`,
`benchmark`) held against the JAX package's.

The offline commands run through `_torch_storage.twin`: each package
writes the same volume in the same directory on pinned clocks, runs the
command through its dispatcher, and the two must print the same text
and leave byte-identical `.dat`, `.idx` and tar files.  `weed benchmark`
runs against each package's in-process cluster, in one process and in
spawned load processes, and both packages must count the same
successful requests.
"""

from __future__ import annotations

import contextlib
import io
import os
import tarfile
import types

import pytest

from _torch_cluster import (PACKAGES, PORT, LiveCluster,  # noqa: F401
                            hermetic_port_state, mod)
from _torch_storage import twin

pytestmark = pytest.mark.torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The backup, offline and benchmark commands and the filer's (slice 11a).
OFFERED = ("backup", "fix", "compact", "export", "benchmark", "watch",
           "scaffold", "filer")
# The gateways, the broker, the filer-event replication and the mount
# (slice 11b).
GATEWAYS = ("msg.broker", "s3", "webdav", "mount", "filer.copy",
            "filer.replicate")


def test_dispatcher_offers_this_slices_commands():
    ref, port = (mod(pkg, "command") for pkg in PACKAGES)
    ref._load_all()
    port._load_all()
    assert set(OFFERED) <= set(port.COMMANDS)
    assert set(GATEWAYS) <= set(port.COMMANDS)
    # Both packages register the same commands, under the same usage
    # (the port's volume, server and shell add -device).
    assert sorted(port.COMMANDS) == sorted(ref.COMMANDS)
    assert len(port.COMMANDS) == 21
    for name, cmd in port.COMMANDS.items():
        if name in OFFERED + GATEWAYS:
            assert cmd.usage == ref.COMMANDS[name].usage


def _main(m, argv):
    """Run `weed <argv>` through one package's dispatcher; the exit code
    and what it printed."""
    cmd = mod(m.name, "command")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cmd.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _volume(m, root):
    vol = m.volume.Volume(root, "", 7)
    for i in range(1, 21):
        n = m.needle.Needle(id=i, cookie=0x1234, data=f"payload-{i}".encode())
        n.set_name(f"file-{i}.txt".encode())
        vol.write_needle(n)
    vol.delete_needle(3)
    vol.delete_needle(9)
    vol.close()


def _reads(m, root, nids):
    vol = m.volume.Volume(root, "", 7)
    try:
        out = {}
        for nid in nids:
            try:
                out[nid] = vol.read_needle(nid).data
            except Exception as e:  # noqa: BLE001 — the outcome
                out[nid] = type(e).__name__
        return out, vol.file_count()
    finally:
        vol.close()


def _fix(m, root):
    _volume(m, root)
    os.remove(os.path.join(root, "7.idx"))
    yield "fixed", {"run": _main(m, ["fix", f"-dir={root}", "-volumeId=7"])}
    yield "reloaded", {"reads": _reads(m, root, (3, 5, 9, 20))}


def _compact(m, root):
    _volume(m, root)
    before = os.path.getsize(os.path.join(root, "7.dat"))
    run = _main(m, ["compact", f"-dir={root}", "-volumeId=7"])
    yield "compacted", {"run": run, "before": before,
                        "after": os.path.getsize(os.path.join(root, "7.dat"))}
    yield "reloaded", {"reads": _reads(m, root, (3, 5, 9, 20))}


def _export(m, root):
    _volume(m, root)
    tar_path = os.path.join(root, "out.tar")
    run = _main(m, ["export", f"-dir={root}", "-volumeId=7", f"-o={tar_path}"])
    with tarfile.open(tar_path) as tar:
        names = tar.getnames()
        data = tar.extractfile("file-5.txt").read()
    yield "tar", {"run": run, "names": names, "file-5": data}
    yield "listing", {"run": _main(m, ["export", f"-dir={root}",
                                       "-volumeId=7"])}


def test_fix_regenerates_idx(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _fix))
    assert steps["fixed"]["run"][0] == 0
    reads, count = steps["reloaded"]["reads"]
    assert count == 18 and reads[5] == b"payload-5"
    assert reads[3] == "NotFoundError"


def test_compact_shrinks(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _compact))
    assert steps["compacted"]["run"][0] == 0
    assert steps["compacted"]["after"] < steps["compacted"]["before"]
    reads, _count = steps["reloaded"]["reads"]
    assert reads[5] == b"payload-5" and reads[3] == "NotFoundError"


def test_export_tar_and_listing(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _export))
    assert "file-5.txt" in steps["tar"]["names"]
    assert "file-3.txt" not in steps["tar"]["names"]
    assert steps["tar"]["file-5"] == b"payload-5"
    _rc, listing, _err = steps["listing"]["run"]
    assert "file-5.txt" in listing and "file-9.txt" not in listing


def _benchmark(pkg, root, argv):
    cluster = LiveCluster(pkg, root, n=1)
    try:
        cmd = mod(pkg, "command")
        bench = mod(pkg, "command.benchmark_cmd")
        host = cluster.url().replace("http://", "")
        flags, rest = cmd.parse_flags([f"-master={host}", *argv])
        reports: list = []
        with contextlib.redirect_stdout(io.StringIO()):
            rc = bench.run_benchmark(flags, rest, reports)
    finally:
        cluster.stop()
    return rc, [(r["requests"], r["errors"]) for r in reports]


@pytest.mark.parametrize("argv", [
    ["-n=200", "-size=1024", "-c=4", "-procs=1"],
    ["-n=40", "-size=512", "-c=4", "-procs=2", "-cpu=false"]],
    ids=["threads", "processes"])
def test_benchmark_counts_equal(argv, tmp_path):
    """weed benchmark at -n 200 (threads) and in two spawned load
    processes: both packages complete every request, write then read."""
    out = []
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        out.append(_benchmark(pkg, d, argv))
    assert out[1] == out[0]
    n = int(argv[0].split("=")[1])
    assert out[1] == (0, [(n, 0), (n, 0)])


def test_benchmark_takes_one_master_in_both_packages():
    """`weed benchmark -master=` names one master in both packages: a
    seed list is read as one address (the clients elsewhere take
    lists), so both fail alike on `-master=a,b`."""
    out = []
    for pkg in PACKAGES:
        cmd = mod(pkg, "command")
        bench = mod(pkg, "command.benchmark_cmd")
        flags, rest = cmd.parse_flags(
            ["-master=127.0.0.1:1,127.0.0.1:2", "-n=2", "-c=1", "-procs=1",
             "-cpu=false", "-read=false"])
        reports: list = []
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = bench.run_benchmark(flags, rest, reports)
        out.append((rc, [(r["requests"], r["errors"]) for r in reports],
                    printed.getvalue().splitlines()[0]))
    assert out[1] == out[0]
    assert out[1][1] == [(0, 2)]
    assert "http://127.0.0.1:1,127.0.0.1:2" in out[1][2]


@pytest.mark.parametrize("missing", ["/dev/fuse", "libfuse.so.2"])
def test_mount_without_fuse_fails_naming_what_is_missing(
        missing, tmp_path, monkeypatch):
    """`weed mount` on a host without a FUSE device or libfuse exits 1
    and names the missing piece, before it dials the filer (the one
    given here does not exist); it never goes on without a mount."""
    import ctypes

    from seaweedfs_tpu_torch.command import mount_cmd
    if missing == "/dev/fuse":
        real = os.path.exists
        monkeypatch.setattr(mount_cmd.os.path, "exists",
                            lambda p: p != "/dev/fuse" and real(p))
    else:
        def no_lib(name, *a, **k):
            raise OSError(f"{name}: cannot open shared object file")
        monkeypatch.setattr(ctypes, "CDLL", no_lib)
    rc, out, err = _main(types.SimpleNamespace(name=PORT), [
        "mount", f"-dir={tmp_path}", "-filer=127.0.0.1:1"])
    assert rc == 1
    assert missing in err and "cannot mount" in err
    assert "mounting" not in out


# A role's wait for SIGTERM, with the signal delivered to another thread
# of the process (the kernel may pick any thread that does not block it).
_SIGTERM_ELSEWHERE = """\
import importlib, signal, sys, threading, time
servers = importlib.import_module(sys.argv[1] + ".command.servers")
class Role:
    def stop(self):
        print("stopped", flush=True)
sleeper = threading.Thread(target=time.sleep, args=(3600,), daemon=True)
sleeper.start()
def later():
    time.sleep(0.3)
    signal.pthread_kill(sleeper.ident, signal.SIGTERM)
threading.Thread(target=later, daemon=True).start()
servers._wait_forever([Role()])
print("exited", flush=True)
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sigterm_on_another_thread_stops_the_role_in_the_port_only(pkg):
    """`_wait_forever` under a SIGTERM that lands on a thread other than
    the main one: the JAX package's main thread waits without a timeout
    and never runs the handler, so the role outlives its SIGTERM (the
    rolling restart's volume subprocess that did not exit in 60 s); the
    port's wakes each second, stops its roles and returns."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_ELSEWHERE, pkg],
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        out, _ = proc.communicate(timeout=6)
        exited = True
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        exited = False
    if pkg == PORT:
        assert exited and out.split() == ["stopped", "exited"], out
    else:
        assert not exited and out == "", out


@pytest.mark.parametrize("missing", ["/dev/fuse", "libfuse.so.2"])
def test_reference_mount_without_fuse_dials_the_filer_first(
        missing, tmp_path, monkeypatch):
    """The JAX package's `weed mount` under the same patches: it has no
    such check (ROADMAP queue 3).  It dials the filer before it looks
    at FUSE, so with the filer given here (nothing listens) both cases
    end in the filer's ConnectError escaping the command, nothing
    printed and the missing piece never named."""
    import ctypes
    if missing == "/dev/fuse":
        real = os.path.exists
        monkeypatch.setattr(os.path, "exists",
                            lambda p: p != "/dev/fuse" and real(p))
    else:
        def no_lib(name, *a, **k):
            raise OSError(f"{name}: cannot open shared object file")
        monkeypatch.setattr(ctypes, "CDLL", no_lib)
    resilience = mod(PACKAGES[0], "cluster.resilience")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            pytest.raises(resilience.ConnectError) as ei:
        mod(PACKAGES[0], "command").main(
            ["mount", f"-dir={tmp_path}", "-filer=127.0.0.1:1"])
    assert str(ei.value).startswith("127.0.0.1:1: ")
    assert out.getvalue() == "" and missing not in err.getvalue()

"""The port's storage backends, volume tiering, remote block cache and
filer chunk cache held against seaweedfs_tpu.

Mirrors tests/test_tier.py on `local://` backends: a readonly volume's
`.dat` moves to the backend and reads proxy through the remote block
cache, survives a restart through its `.vif`, is found by a `Store`,
stays remote when `keep_local` left a `.dat`, and moves back.  Each
scenario runs once per package in the same directory, so the `.vif`
(which names the backend) must be byte-identical too.  `S3Backend` runs
against an in-process S3 stand-in that checks every request's sig v4
with seaweedfs_tpu's verifier; the port signs through its own copy of
`s3api/sigv4`.  The S3 gateway cases (tiering over the repo's own
gateway, the tier RPCs and shell commands) need a live cluster and wait
for the volume-server slice.
"""

from __future__ import annotations

import http.server
import os
import threading
import urllib.parse

import pytest
import torch

from _torch_storage import PAIR, PORT, REF, FixedClock, needle, outcome, twin

pytestmark = pytest.mark.torch

torch.set_num_threads(1)

AK, SK = "AKIDPORT", "port-secret-key"


def _make_volume(m, root, n=20):
    v = m.volume.Volume(root, "", 7, use_worker=False)
    for i in range(n):
        v.write_needle(needle(m, i + 1, f"needle-{i}".encode() * 10,
                              0x1234 + i))
    return v


def _reads(v, n=20):
    return [outcome(lambda i=i: v.read_needle(i + 1).data) for i in range(n)]


# -- backends ----------------------------------------------------------------


def _local_backend(m, root):
    b = m.backend.backend_for_spec(f"local://{root}/tier")
    src = os.path.join(root, "src.bin")
    with open(src, "wb") as f:
        f.write(bytes(range(256)) * 16)
    obs = {"kind": type(b).__name__, "spec": b.spec,
           "up": b.upload_file("v1.dat", src),
           "range": b.read_range("v1.dat", 256, 10)}
    b.download_file("v1.dat", os.path.join(root, "back.bin"))
    yield "copied", obs
    b.delete("v1.dat")
    b.delete("v1.dat")  # idempotent
    yield "deleted", {"gone": outcome(b.read_range, "v1.dat", 0, 1)[:2],
                      "bad": outcome(m.backend.backend_for_spec, "ftp://x"),
                      "nobucket": outcome(m.backend.backend_for_spec,
                                          "s3://host:1")}


def test_local_backend(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _local_backend))
    assert steps["copied"]["up"] == 4096
    assert steps["deleted"]["gone"] == ("raise", "FileNotFoundError")


def _remote_file(m, root):
    m.remote_cache.CACHE.reset()
    b = m.backend.LocalDirBackend(os.path.join(root, "t"))
    payload = bytes((i * 7) & 0xFF for i in range(3 * (1 << 20) + 123))
    src = os.path.join(root, "big.bin")
    with open(src, "wb") as f:
        f.write(payload)
    b.upload_file("big", src)
    rf = b.open_file("big", len(payload))
    obs = {"cross": rf.pread(100, (1 << 20) - 50) ==
           payload[(1 << 20) - 50:(1 << 20) + 50],
           "tail": rf.pread(1 << 20, len(payload) - 10) == payload[-10:],
           "beyond": rf.pread(10, len(payload) + 5), "size": rf.size(),
           "again": rf.pread(100, (1 << 20) - 50) ==
           payload[(1 << 20) - 50:(1 << 20) + 50]}
    st = m.remote_cache.CACHE.stats()
    obs["cache"] = {k: st[k] for k in ("hit_bytes", "miss_bytes",
                                       "used_bytes", "evictions")
                    if k in st}
    m.remote_cache.CACHE.drop_file(b.spec, "big")
    obs["dropped"] = m.remote_cache.CACHE.used_bytes()
    yield "read", obs
    m.remote_cache.CACHE.reset()


def test_remote_file_block_cache(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _remote_file))
    obs = steps["read"]
    assert obs["cross"] and obs["tail"] and obs["again"]
    assert obs["beyond"] == b"" and obs["dropped"] == 0
    assert obs["cache"]["hit_bytes"] > 0


# -- tier moves --------------------------------------------------------------


def _tier_move(m, root):
    v = _make_volume(m, root)
    dest = f"local://{root}/remote"
    obs = {"not_ro": outcome(m.tier.move_dat_to_remote, v, dest)}
    v.set_readonly()
    info = m.tier.move_dat_to_remote(v, dest)
    obs.update(info=info, dat=os.path.exists(v.file_name() + ".dat"),
               vif=m.tier.load_vif(v.file_name()), reads=_reads(v),
               write=outcome(v.write_needle, needle(m, 999, b"x")),
               again=outcome(m.tier.move_dat_to_remote, v, dest))
    yield "uploaded", obs
    m.tier.move_dat_from_remote(v)
    obs = {"dat": os.path.exists(v.file_name() + ".dat"),
           "vif": os.path.exists(v.file_name() + ".vif"),
           "reads": _reads(v), "remote": v.remote_file is None,
           "not_tiered": outcome(m.tier.move_dat_from_remote, v)}
    yield "downloaded", obs
    v.close()


def test_tier_upload_remote_reads_and_download(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _tier_move))
    up = steps["uploaded"]
    assert up["not_ro"][1] == "VolumeError" and not up["dat"]
    assert up["reads"][4] == ("ok", b"needle-4" * 10)
    assert up["write"][1] == "VolumeError"
    assert steps["downloaded"]["dat"] and not steps["downloaded"]["vif"]


def _tier_restart(m, root):
    v = _make_volume(m, root)
    v.set_readonly()
    m.tier.move_dat_to_remote(v, f"local://{root}/remote")
    v.close()
    v2 = m.tier.open_remote_volume(root, "", 7)
    yield "reopened", {"ro": v2.readonly, "remote": v2.remote_file is not None,
                       "reads": _reads(v2), "count": v2.file_count(),
                       "modified_at": v2.modified_at}
    v2.close()
    store = m.store.Store([root])
    found = store.find_volume(7)
    hb = store.collect_heartbeat()["volumes"][0]
    yield "store", {"remote": found.remote_file is not None,
                    "read": found.read_needle(3).data,
                    "tiered": hb.tiered, "size": hb.size}
    store.close()


def test_open_remote_volume_and_store_discovery(tmp_path, monkeypatch):
    steps = dict(twin(tmp_path, monkeypatch, _tier_restart))
    assert steps["reopened"]["ro"] and steps["reopened"]["remote"]
    assert steps["store"]["read"] == b"needle-2" * 10
    assert steps["store"]["tiered"]


def _keep_local(m, root):
    v = _make_volume(m, root)
    v.set_readonly()
    m.tier.move_dat_to_remote(v, f"local://{root}/remote", keep_local=True)
    v.close()
    store = m.store.Store([root])
    found = store.find_volume(7)
    yield "reloaded", {"dat": os.path.exists(os.path.join(root, "7.dat")),
                       "remote": found.remote_file is not None,
                       "ro": found.readonly,
                       "write": outcome(found.write_needle,
                                        needle(m, 999, b"x"))}
    store.close()


def test_keep_local_reload_stays_remote(tmp_path, monkeypatch):
    obs = dict(twin(tmp_path, monkeypatch, _keep_local))["reloaded"]
    assert obs["dat"] and obs["remote"] and obs["ro"]
    assert obs["write"][1] == "VolumeError"


# -- S3 ----------------------------------------------------------------------


class _MiniS3(http.server.BaseHTTPRequestHandler):
    """PUT/GET (with Range)/DELETE on an in-memory bucket; every signed
    request is checked with seaweedfs_tpu's sig v4 verifier."""

    objects: dict = {}
    seen: list = []

    def log_message(self, *a):
        pass

    def _check_sig(self, payload_hash: str) -> bool:
        from seaweedfs_tpu.s3api.auth import compute_signature_v4
        auth = self.headers.get("Authorization", "")
        if not auth:
            return True
        parts = dict(p.strip().split("=", 1)
                     for p in auth.split(" ", 1)[1].split(","))
        scope = parts["Credential"].split("/", 1)[1]
        signed = parts["SignedHeaders"].split(";")
        lower = {k.lower(): v for k, v in self.headers.items()}
        u = urllib.parse.urlparse(self.path)
        want = compute_signature_v4(
            self.command, u.path, u.query, lower, signed, payload_hash,
            lower["x-amz-date"], scope, SK)
        self.seen.append((self.command, parts["Signature"] == want))
        return parts["Signature"] == want

    def _reply(self, code, body=b""):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        if not self._check_sig(self.headers["x-amz-content-sha256"]):
            return self._reply(403)
        self.objects[urllib.parse.urlparse(self.path).path] = body
        self._reply(200)

    def do_GET(self):
        if not self._check_sig(self.headers.get("x-amz-content-sha256",
                                                "")):
            return self._reply(403)
        body = self.objects.get(urllib.parse.urlparse(self.path).path)
        if body is None:
            return self._reply(404)
        rng = self.headers.get("Range")
        if rng:
            lo, hi = (int(x) for x in rng.split("=")[1].split("-"))
            body = body[lo:hi + 1]
        self._reply(206 if rng else 200, body)

    def do_DELETE(self):
        if not self._check_sig(self.headers.get("x-amz-content-sha256",
                                                "")):
            return self._reply(403)
        self.objects.pop(urllib.parse.urlparse(self.path).path, None)
        self._reply(204)


@pytest.fixture
def mini_s3():
    _MiniS3.objects, _MiniS3.seen = {}, []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _MiniS3)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_sigv4_signs_like_the_reference(monkeypatch):
    for m in PAIR:
        monkeypatch.setattr(m.sigv4, "time", FixedClock())
    args = ("PUT", "http://h:1/b/k%20x?partNumber=2&uploadId=z",
            {"Content-Length": "3", "x-amz-meta-a": " b  c "}, b"abc", AK, SK)
    assert PORT.sigv4.sign_request(*args) == REF.sigv4.sign_request(*args)
    kw = {"payload_hash": "UNSIGNED-PAYLOAD", "service": "sqs",
          "region": "eu-west-1"}
    assert PORT.sigv4.sign_request(*args, **kw) == \
        REF.sigv4.sign_request(*args, **kw)


def test_s3_backend_tier_roundtrip(tmp_path, monkeypatch, mini_s3):
    def scenario(m, root):
        m.remote_cache.CACHE.reset()
        v = _make_volume(m, root)
        v.set_readonly()
        before = _reads(v)
        monkeypatch.setenv("WEED_TIER_ACCESS_KEY", AK)
        monkeypatch.setenv("WEED_TIER_SECRET_KEY", SK)
        info = m.tier.move_dat_to_remote(v, f"s3://{mini_s3}/tier/pfx",
                                         access_key=AK, secret_key=SK)
        obs = {"info": info, "objects": sorted(_MiniS3.objects),
               "reads": _reads(v) == before}
        yield "uploaded", obs
        m.tier.move_dat_from_remote(v, access_key=AK, secret_key=SK)
        yield "downloaded", {"reads": _reads(v) == before,
                             "objects": sorted(_MiniS3.objects)}
        v.close()
        m.remote_cache.CACHE.reset()
        b = m.backend.backend_for_spec(f"s3://{mini_s3}/tier", AK, SK)
        b.delete("absent-key")

    steps = dict(twin(tmp_path, monkeypatch, scenario))
    assert steps["uploaded"]["objects"] == ["/tier/pfx/7.dat"]
    assert steps["uploaded"]["reads"] and steps["downloaded"]["reads"]
    assert steps["downloaded"]["objects"] == []
    assert _MiniS3.seen and all(ok for _cmd, ok in _MiniS3.seen)
    assert {cmd for cmd, _ok in _MiniS3.seen} == {"PUT", "GET", "DELETE"}


# -- the filer chunk cache ---------------------------------------------------


def test_chunk_cache_equal():
    out = []
    for m in PAIR:
        c = m.chunk_cache.FilerChunkCache(max_bytes=10_000)
        c.configure_tenant_cap(6_000)
        fetched = []

        def fetch(fid, n):
            def f():
                fetched.append(fid)
                return fid.encode() * n
            return f

        got = [c.get_or_fetch("1,a", fetch("1,a", 500), tenant="t1"),
               c.get_or_fetch("1,a", fetch("1,a", 500), tenant="t1"),
               c.get_or_fetch("2,b", fetch("2,b", 1000), tenant="t1"),
               c.get_or_fetch("3,c", fetch("3,c", 1000), tenant="t2"),
               c.get_or_fetch("4,d", fetch("4,d", 1500), tenant="t2")]
        c.invalidate("2,b")
        got.append(c.get_or_fetch("2,b", fetch("2,b", 10)))
        st = c.stats()
        out.append((got, fetched, c.used_bytes(),
                    {k: v for k, v in st.items()
                     if not k.startswith("fetch")}))
        c.reset()
        assert c.used_bytes() == 0
    assert out[1] == out[0]

"""Volume-server read surface and reproduced reference faults, each case
run once for the JAX package and once for the port (`pkg`).

The server cases of tests/test_sendfile_read.py: a large GET through
the zero-copy path with the flow ledger's byte identity, single-range
reads (206, suffix form, multi-range ignored, 416), conditional GETs
(ETag, Last-Modified, Content-Disposition), and -read.redirect.  The
CLI flag case of tests/test_offset_5bytes.py on the port's dispatcher.

Two faults of the reference are kept in the port for parity and pinned
here in both packages (ROADMAP queue 3, "kept for parity"):

- `_vol_loc_cache` grows without bound: every distinct volume id a
  misdirected read asks about stays cached, negative answers included;
- `_read_redirect_or_404` compares only `url` with its own address, so
  a location whose `publicUrl` is an alias of this server is taken for
  another holder and the read is redirected to itself.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request

import pytest

from _torch_cluster import (LiveCluster, cluster_deadline,  # noqa: F401
                            hermetic_port_state, mod, pkg)

pytestmark = [pytest.mark.torch,
              pytest.mark.usefixtures("cluster_deadline")]

BIG = bytes(range(256)) * 2048  # 512 KiB: the sendfile path


@pytest.fixture
def cluster(pkg, tmp_path):
    c = LiveCluster(pkg, tmp_path, n=1)
    yield c
    c.stop()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), b""


def test_large_get_end_to_end_sendfile(cluster):
    flows = mod(cluster.pkg, "stats.flows")
    vs = cluster.servers[0]
    client = cluster.client()
    fid = client.upload_data(BIG)
    assert bytes(cluster.rpc.call(f"http://{vs.url()}/{fid}")) == BIG

    def served():
        return flows.LEDGER.totals(purpose_="user.read", direction="out",
                                   local=vs.url())[0]
    deadline = time.time() + 5.0
    while served() != len(BIG) and time.time() < deadline:
        time.sleep(0.05)
    assert served() == len(BIG)
    assert flows.LEDGER.totals(purpose_="user.read",
                               direction="in")[0] == len(BIG)
    text = b"the quick brown fox " * 40_000
    fid2 = client.upload(text, name="a.txt")["fid"]
    assert client.download(fid2) == text


def test_range_reads_on_volume_server(cluster):
    vs = cluster.servers[0]
    client = cluster.client()
    small = bytes(range(256)) * 4
    for payload in (small, BIG):
        url = f"http://{vs.url()}/{client.upload_data(payload)}"
        st, hdrs, body = _get(url, {"Range": "bytes=10-99"})
        assert st == 206 and body == payload[10:100]
        assert hdrs["Content-Range"] == f"bytes 10-99/{len(payload)}"
        st, _h, body = _get(url, {"Range": "bytes=-100"})
        assert st == 206 and body == payload[-100:]
        st, _h, body = _get(url, {"Range": f"bytes={len(payload) - 1}-"})
        assert st == 206 and body == payload[-1:]
        st, _h, body = _get(url, {"Range": "bytes=0-5,10-15"})
        assert st == 200 and body == payload
        st, _h, _b = _get(url, {"Range": f"bytes={len(payload) + 5}-"})
        assert st == 416
        st, hdrs, body = _get(url)
        assert st == 200 and body == payload
        assert hdrs.get("Accept-Ranges") == "bytes"


def test_conditional_get_etag_last_modified(cluster):
    vs = cluster.servers[0]
    client = cluster.client()
    fids = [client.upload(b"small payload" * 10, name="doc.pdf",
                          mime="application/pdf", compress=False)["fid"],
            client.upload(BIG[:300_000], name="big.bin", mime="image/png",
                          compress=False)["fid"]]
    for fid in fids:
        url = f"http://{vs.url()}/{fid}"
        st, hdrs, _b = _get(url)
        assert st == 200
        etag = hdrs["ETag"]
        assert etag.startswith('"') and len(etag) == 10
        assert 'filename="' in hdrs["Content-Disposition"]
        assert hdrs["Content-Disposition"].startswith("inline")
        assert hdrs["Content-Type"] in ("application/pdf", "image/png")
        st, _h, body = _get(url, {"If-None-Match": etag})
        assert st == 304 and body == b""
        assert _get(url, {"If-Modified-Since": hdrs["Last-Modified"]})[0] \
            == 304
        assert _get(url, {"If-Modified-Since":
                          "Mon, 01 Jan 1990 00:00:00 GMT"})[0] == 200
        _st, hdrs, _b = _get(url + "?dl=true")
        assert hdrs["Content-Disposition"].startswith("attachment")


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **kw):
        return None


def test_read_redirect_non_local_volume(pkg, tmp_path):
    """A GET for a volume another server hosts answers 301 there when
    -read.redirect is on, and 404 when it is off."""
    cluster = LiveCluster(pkg, tmp_path, n=0)
    try:
        a = cluster.add_server(read_redirect=True)
        b = cluster.add_server(read_redirect=False)
        client = cluster.client()
        by_server: dict[str, str] = {}
        for i in range(60):
            fid = client.upload_data(f"rr-{i}".encode() * 10)
            locs = client.lookup(int(fid.split(",")[0]))
            if len(locs) == 1:
                by_server.setdefault(locs[0]["url"], fid)
        foreign = by_server[b.url()]
        with urllib.request.urlopen(f"http://{a.url()}/{foreign}",
                                    timeout=10) as r:
            assert r.status == 200 and r.url.startswith(f"http://{b.url()}/")
            assert r.read().startswith(b"rr-")
        opener = urllib.request.build_opener(_NoRedirect)
        with pytest.raises(urllib.error.HTTPError) as ei:
            opener.open(f"http://{a.url()}/{foreign}", timeout=10)
        assert ei.value.code == 301
        assert ei.value.headers["Location"] == f"http://{b.url()}/{foreign}"
        local = by_server.get(a.url())
        if local is not None:
            with pytest.raises(urllib.error.HTTPError) as ei:
                opener.open(f"http://{b.url()}/{local}", timeout=10)
            assert ei.value.code == 404
    finally:
        cluster.stop()


def test_cli_flag_selects_flavor(pkg):
    """`weed version -offsetBytes=5` flips the process offset flavor."""
    t = mod(pkg, "core.types")
    try:
        mod(pkg, "command").main(["version", "-offsetBytes=5"])
        assert t.OFFSET_SIZE == 5
    finally:
        t.set_offset_flavor(4)


# -- reference faults kept for parity ----------------------------------------

def test_volume_location_cache_is_unbounded(cluster):
    """Every distinct volume id a misdirected read asks about stays in
    `_vol_loc_cache` (the master answers 404, negative-cached): nothing
    evicts, so the cache grows with the ids clients send."""
    vs = cluster.servers[0]
    for vid in range(1000, 1200):
        st, _h, _b = _get(f"http://{vs.url()}/{vid},0100000001")
        assert st == 404
    assert len(vs._vol_loc_cache) == 200
    assert all(entry == {} for _exp, entry in vs._vol_loc_cache.values())


def test_public_url_alias_redirects_to_itself(cluster):
    """A location whose `publicUrl` names this server by another address
    is not recognised as this server: the read of a volume it does not
    hold is redirected to itself, and a client following redirects
    loops."""
    vs = cluster.servers[0]
    alias = f"localhost:{vs.server.port}"
    vs._vol_loc_cache[4242] = (time.time() + 3600, {"locations": [
        {"url": vs.url(), "publicUrl": alias}]})
    opener = urllib.request.build_opener(_NoRedirect)
    with pytest.raises(urllib.error.HTTPError) as ei:
        opener.open(f"http://{vs.url()}/4242,0100000001", timeout=10)
    assert ei.value.code == 301
    assert ei.value.headers["Location"] == f"http://{alias}/4242,0100000001"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://{vs.url()}/4242,0100000001",
                               timeout=10)
    assert ei.value.code == 301  # urllib stops at its loop detection

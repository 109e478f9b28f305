"""The port's data-lifecycle policy engine and daemon (lifecycle/)
against seaweedfs_tpu's: the policy-grammar cases and the daemon's unit
cases of tests/test_lifecycle.py, each run for both packages with the
answers held equal.  The end-to-end tiering and TTL cases run on live
volume servers in tests/test_torch_volume_planes.py."""

from __future__ import annotations

import textwrap

import pytest

from _torch_cluster import both, hermetic_port_state, mod  # noqa: F401

pytestmark = pytest.mark.torch


def _lc(pkg):
    return mod(pkg, "lifecycle")


def test_parse_duration_units():
    def run(pkg):
        lc = _lc(pkg)
        got = [lc.parse_duration(s) for s in
               ("90s", "10m", "2h", "30d", "1w", "45", "1.5m")]
        assert got == [90.0, 600.0, 7200.0, 30 * 86400.0, 604800.0, 45.0,
                       90.0]
        errors = []
        for bad in ("", "10x", "m", "-5s", "1 0m"):
            with pytest.raises(lc.PolicyError) as ei:
                lc.parse_duration(bad)
            errors.append(str(ei.value))
        return got, errors
    both(run)


def test_line_grammar_and_first_match_wins():
    text = textwrap.dedent("""\
        # comments and blank lines are fine

        logs    tier   dest=local:///cold  idle=10m
        logs    tier   dest=local:///never  age=99d   # shadowed
        pics    tier   dest=s3://h:1/b/frozen  age=30d  fullness=0.8
        scratch expire
        *       expire
    """)

    def run(pkg):
        p = _lc(pkg).parse_rules_text(text)
        assert len(p) == 5
        r = p.tier_rule_for("logs")
        assert (r.dest, r.idle_for) == ("local:///cold", 600.0)
        r = p.tier_rule_for("pics")
        assert (r.min_age, r.fullness) == (30 * 86400.0, 0.8)
        assert p.tier_rule_for("other") is None
        # expire: the exact rule wins over the wildcard, both match.
        assert p.expire_rule_for("scratch").collection == "scratch"
        assert p.expire_rule_for("anything").collection == "*"
        return [repr(r) for r in p.rules]
    both(run)


def test_toml_rules_and_load_dispatch(tmp_path):
    toml = tmp_path / "rules.toml"
    toml.write_text(textwrap.dedent("""\
        [[rule]]
        collection = "logs"
        action = "tier"
        dest = "local:///cold"
        idle = "10m"

        [[rule]]
        collection = "*"
        action = "expire"
    """))
    txt = tmp_path / "rules.txt"
    txt.write_text("logs tier dest=local:///cold idle=10m\n")

    def run(pkg):
        lc = _lc(pkg)
        p = lc.load_rules(str(toml))
        assert p.tier_rule_for("logs").idle_for == 600.0
        assert p.expire_rule_for("x") is not None
        assert len(lc.load_rules(str(txt))) == 1
        return [repr(r) for r in p.rules]
    both(run)


@pytest.mark.parametrize("bad,msg", [
    ("logs tier idle=10m", "dest"),                     # no destination
    ("logs tier dest=local:///c", "at least one"),      # unconditional
    ("logs tier dest=local:///c fullness=1.5", "fullness"),
    ("logs expire idle=10m", "no conditions"),
    ("logs tier dest=local:///c shade=1", "unknown rule keys"),
    ("logs freeze", "unknown lifecycle action"),
    ("logs", "want"),
    ("logs tier dest", "bad token"),
])
def test_rule_validation_errors(bad, msg):
    def run(pkg):
        lc = _lc(pkg)
        with pytest.raises(lc.PolicyError, match=msg) as ei:
            lc.parse_rules_text(bad)
        return str(ei.value)
    both(run)


class _VInfo:
    collection = "c"
    tiered = False
    ttl = 0
    modified_at = 1.0
    size = 100


def test_daemon_requires_single_holder_and_skips_tiered():
    """_consider refuses to tier replicated volumes and never re-tiers an
    already-tiered one."""
    class DN:
        def url(self):
            return "127.0.0.1:1"

    class Topo:
        volume_size_limit = 1000

        def leaves(self):
            return []

    class M:
        topo = Topo()

        def is_leader(self):
            return True

    def run(pkg):
        lc = _lc(pkg)
        daemon = lc.LifecycleDaemon(
            M(), lc.Policy([lc.Rule(collection="*", action="tier",
                                    dest="local:///t", min_age=0.0001)]),
            interval=3600)
        tiered = []
        daemon._tier_one = lambda dn, vid, vinfo, rule, out: tiered.append(
            vid)
        out = {"tiered": [], "vacuumed": [], "errors": []}
        dn = DN()
        daemon._consider(dn, 1, _VInfo(), {1: [dn, dn]}, None, None, out)
        assert tiered == []                  # two holders: refused
        daemon._consider(dn, 1, _VInfo(), {1: [dn]}, None, None, out)
        assert tiered == [1]                 # a single holder: tiered
        vi = _VInfo()
        vi.tiered = True
        daemon._consider(dn, 2, vi, {2: [dn]}, None, None, out)
        assert tiered == [1]                 # already tiered: skipped
        return tiered, out
    both(run)


def test_daemon_unreachable_holder_degrades_scan_not_master(monkeypatch):
    """A dead holder costs the scan an error entry; the daemon keeps
    going and the error shows in status()."""
    from _torch_cluster import pin_clocks
    pin_clocks(monkeypatch)

    class DN:
        volumes: dict = {}

        def url(self):
            return "127.0.0.1:1"  # nothing listens here

    class Topo:
        volume_size_limit = 1000

        def __init__(self, dn):
            self._dn = dn

        def leaves(self):
            return [self._dn]

    class M:
        def __init__(self, dn):
            self.topo = Topo(dn)

        def is_leader(self):
            return True

    def run(pkg):
        lc = _lc(pkg)
        dn = DN()
        vi = _VInfo()
        vi.collection, vi.size = "", 10
        dn.volumes = {5: vi}
        daemon = lc.LifecycleDaemon(
            M(dn), lc.Policy([lc.Rule(collection="*", action="tier",
                                      dest="local:///t", min_age=0.0001)]),
            interval=3600)
        daemon._policy_retry.max_attempts = 1
        out = daemon.scan_once()
        assert out["tiered"] == []
        assert out["errors"] and out["errors"][0]["volume"] == 5
        status = daemon.status()
        assert status["actions"]["tier_error"] == 1
        mod(pkg, "cluster.resilience").reset_breakers()
        return ([e["volume"] for e in out["errors"]], status["actions"],
                status["scans"])
    both(run)

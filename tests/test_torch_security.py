"""The port's write-path JWT, request guard and configuration loader
(utils/security.py, utils/config.py) against seaweedfs_tpu's: the cases
of tests/test_cli.py, with tokens byte-equal under a pinned clock; the
master's half of tests/test_shell_fs_security.py's secured cluster
(assign and lookup mint the same token in both packages); and the port's
`weed` dispatcher, which so far has `master`."""

from __future__ import annotations

import json

import pytest

from _torch_cluster import (PACKAGES, both, hermetic_port_state,  # noqa: F401
                            mod, pin_clocks)
from seaweedfs_tpu_torch import command
from seaweedfs_tpu.cluster.master import MasterServer as RefMasterServer
from seaweedfs_tpu_torch.cluster.master import MasterServer

pytestmark = pytest.mark.torch


def _sec(pkg):
    return mod(pkg, "utils.security")


def test_jwt_round_trip(monkeypatch):
    pin_clocks(monkeypatch)

    def run(pkg):
        sec = _sec(pkg)
        tok = sec.gen_jwt("secret", 60, "3,0144b2c8f1")
        claims = sec.decode_jwt("secret", tok)
        assert claims["fid"] == "3,0144b2c8f1" and "exp" in claims
        assert sec.gen_jwt("", 60, "3,01") == ""  # no key, no token
        return tok, claims
    both(run)


def test_jwt_bad_signature_and_expiry(monkeypatch):
    pin_clocks(monkeypatch)

    def run(pkg):
        sec = _sec(pkg)
        tok = sec.gen_jwt("secret", 60, "3,ab")
        with pytest.raises(sec.JwtError, match="signature") as bad:
            sec.decode_jwt("wrong", tok)
        expired = sec.gen_jwt("secret", -100, "3,ab")
        with pytest.raises(sec.JwtError, match="expired") as old:
            sec.decode_jwt("secret", expired)
        with pytest.raises(sec.JwtError, match="malformed"):
            sec.decode_jwt("secret", "not-a-token")
        return tok, expired, str(bad.value), str(old.value)
    both(run)


def test_guard(monkeypatch):
    pin_clocks(monkeypatch)

    def run(pkg):
        sec = _sec(pkg)
        g = sec.Guard(signing_key="k", expires_seconds=60)
        assert g.is_active
        tok = sec.gen_jwt("k", 60, "3,ab")
        g.check_jwt(tok, "3,ab")
        g.check_jwt(tok, "3,ab_1")  # chunk-suffix variants allowed
        errors = []
        for token, fid in ((tok, "4,cd"), ("", "3,ab")):
            with pytest.raises(sec.JwtError) as ei:
                g.check_jwt(token, fid)
            errors.append(str(ei.value))
        inactive = sec.Guard()
        assert not inactive.is_active
        inactive.check_jwt("", "3,ab")  # no-op when no key configured
        wl = sec.Guard(white_list=["10.0.0.1"])
        assert wl.check_white_list("10.0.0.1")
        assert not wl.check_white_list("10.0.0.2")
        return tok, errors
    both(run)


def test_config_load_and_env_override(tmp_path, monkeypatch):
    (tmp_path / "security.toml").write_text(
        '[jwt.signing]\nkey = "abc"\nexpires_after_seconds = 10\n')

    def run(pkg):
        load = mod(pkg, "utils.config").load_configuration
        monkeypatch.delenv("WEED_JWT_SIGNING_KEY", raising=False)
        cfg = load("security", search_paths=[str(tmp_path)])
        got = [cfg.get_string("jwt.signing.key"),
               cfg.get_int("jwt.signing.expires_after_seconds")]
        monkeypatch.setenv("WEED_JWT_SIGNING_KEY", "override")
        got.append(cfg.get_string("jwt.signing.key"))
        assert got == ["abc", 10, "override"]
        # missing optional config is empty, required raises
        assert load("nothere", search_paths=[str(tmp_path)]).get("x") is None
        with pytest.raises(FileNotFoundError):
            load("nothere", required=True, search_paths=[str(tmp_path)])
        return got
    both(run)


def test_config_sub_and_bool():
    def run(pkg):
        cfg = mod(pkg, "utils.config").Configuration(
            {"sqlite": {"enabled": True, "file": "f.db"}})
        assert cfg.get_bool("sqlite.enabled") is True
        assert cfg.sub("sqlite") == {"enabled": True, "file": "f.db"}
        return cfg.sub("sqlite")
    both(run)


def test_secured_masters_mint_equal_tokens(monkeypatch):
    """A master with a signing key attaches the write token to assign
    and (with fileId) to lookup answers; under a pinned clock and a
    seeded `random` both packages mint byte-equal tokens."""
    import random
    pin_clocks(monkeypatch)
    beat = json.dumps({"ip": "127.0.0.1", "port": 4301, "volumes": [
        {"id": 3, "collection": "", "size": 0, "replica_placement": 0}]})
    answers = []
    for pkg in PACKAGES:
        m = mod(pkg, "cluster.master").MasterServer(
            jwt_signing_key="test-signing-key", jwt_expires_seconds=10)
        rpcm = mod(pkg, "cluster.rpc")
        m.start()
        try:
            rpcm.call(m.url() + "/heartbeat", "POST", beat.encode())
            random.seed(5)
            a = rpcm.call(m.url() + "/dir/assign")
            look = rpcm.call(m.url() + f"/dir/lookup?volumeId=3&fileId="
                                       f"{a['fid']}")
        finally:
            m.stop()
        assert a["auth"] and look["auth"]
        claims = _sec(pkg).decode_jwt("test-signing-key", a["auth"])
        assert claims["fid"] == a["fid"]
        answers.append((a, look))
    assert answers[1] == answers[0]


# -- the dispatcher ----------------------------------------------------------

def test_dispatcher_lists_only_the_ported_commands(capsys):
    """Since slice 11b every command of the JAX package is ported, the
    gateways too; a name neither package has is refused."""
    assert command.main(["-h"]) == 0
    out = capsys.readouterr().out
    for name in ("master", "volume", "server", "shell", "upload",
                 "download", "version", "backup", "fix", "compact",
                 "export", "benchmark", "filer", "watch", "scaffold",
                 "s3", "webdav", "msg.broker", "mount", "filer.copy",
                 "filer.replicate"):
        assert f"  {name} " in out
    assert command.main(["nosuchcommand"]) == 2
    assert "unknown command" in capsys.readouterr().err


@pytest.mark.parametrize("kwargs,what", [
    ({"peers": ["127.0.0.1:1", "127.0.0.1:2"]}, "-peers must include"),
])
def test_unported_master_features_raise(kwargs, what):
    """Raft (-peers) is ported: a peer list that does not name this
    master's own address is refused with the reference's error, rather
    than run as a split brain."""
    with pytest.raises(ValueError, match=what):
        MasterServer(**kwargs)
    with pytest.raises(ValueError, match=what):
        RefMasterServer(**kwargs)
